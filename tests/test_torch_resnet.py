"""ResNet-20 in the port against the JAX package, on the CPU: the batch
norm rule, global average pooling, the model at its published widths
(16/32/64, stride-2 stage entries whose SAME padding is asymmetric, the
1x1 projections) in f32 and bf16, its BN state updates, and one training
step's loss and gradients.

Params and BN statistics are JAX-initialized and carried across with
`convert`; inputs are numpy-seeded. Each tolerance is stated beside its
check.
"""

from __future__ import annotations

import functools
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_mnist_tpu import optim as jopt
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.ops import losses as jlosses
from dist_mnist_tpu.ops import nn as jnn
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.convert import params_from_jax, train_state_from_jax
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.ops import losses as tlosses
from dist_mnist_tpu_torch.ops import nn as tnn
from dist_mnist_tpu_torch.train.step import loss_and_grads
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, tree_map


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the suite's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)) / (
        float(np.max(np.abs(want), initial=0.0)) + 1e-30)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _pair_flat(t_tree, j_tree):
    t_flat = flatten_with_path(t_tree)
    j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(t_flat) == len(j_flat)
    return [(path, got, np.asarray(want)) for (path, got), (_, want)
            in zip(t_flat, j_flat)]


@pytest.fixture(scope="module")
def resnet():
    """The JAX ResNet-20's init (f32 params and BN statistics), shared."""
    model = jget_model("resnet20", compute_dtype=jnp.float32)
    params, state = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 32, 32, 3), jnp.float32)))(jax.random.PRNGKey(0))
    return jax.device_get(params), jax.device_get(state)


def test_flops_and_tree_equal_the_reference(resnet):
    jmodel, tmodel = jget_model("resnet20"), tget_model("resnet20")
    shape = (1, 32, 32, 3)
    assert tmodel.flops_per_example(shape) == jmodel.flops_per_example(shape)
    params, state = tmodel.init(torch.Generator().manual_seed(0),
                                torch.zeros(shape))
    for t_tree, j_tree in ((params, resnet[0]), (state, resnet[1])):
        for path, got, want in _pair_flat(t_tree, j_tree):
            assert tuple(got.shape) == want.shape, path
            assert got.dtype == torch.float32, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_reference(dtype, train):
    """f32: the same statistics up to summation order, 1e-5 of the
    largest output and state value. bf16: the f32 result rounded to bf16,
    the same within one bf16 ulp (2^-8 relative)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 6, 6, 5)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(5).astype(np.float32),
         "bias": rng.standard_normal(5).astype(np.float32)}
    s = {"mean": rng.standard_normal(5).astype(np.float32),
         "var": rng.random(5).astype(np.float32) + 0.5}
    jy, js = jnn.batch_norm(p, s, jnp.asarray(x, getattr(jnp, dtype)),
                            train=train)
    ty, ts = tnn.batch_norm(params_from_jax(p), params_from_jax(s),
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            train=train)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    assert ty.dtype == getattr(torch, dtype)
    assert _rel_err(ty.float().numpy(), np.asarray(jy, np.float32)) <= tol
    for k in ("mean", "var"):
        assert _rel_err(ts[k].numpy(), js[k]) <= 1e-5, k


def test_batch_norm_variance_is_biased_and_momentum_on_old():
    """The reference's rule, not F.batch_norm's: var = mean((x - mean)^2)
    over N, H and W, running = 0.9 old + 0.1 batch."""
    x = torch.tensor([[[[1.0]], [[3.0]]]])  # N=2, H=W=1, C=1
    _, s = tnn.batch_norm({"scale": torch.ones(1), "bias": torch.zeros(1)},
                          {"mean": torch.zeros(1), "var": torch.ones(1)},
                          x.reshape(2, 1, 1, 1), train=True)
    assert torch.allclose(s["mean"], torch.tensor([0.2]))
    assert torch.allclose(s["var"], torch.tensor([0.9 + 0.1 * 1.0]))


def test_global_avg_pool_matches_reference():
    x = np.random.default_rng(2).standard_normal((3, 8, 8, 4)).astype(
        np.float32)
    for dtype in ("float32", "bfloat16"):
        got = tnn.global_avg_pool(torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)))
        want = jnn.global_avg_pool(jnp.asarray(x, getattr(jnp, dtype)))
        assert got.dtype == getattr(torch, dtype)
        # f32: summation order; bf16: one bf16 rounding of the same mean
        tol = 1e-6 if dtype == "float32" else 2 ** -8
        assert _rel_err(got.float().numpy(),
                        np.asarray(want, np.float32)) <= tol


# logits / BN statistics, relative to the largest reference value. f32:
# the same arithmetic up to the order of each conv's sums through 19
# convs and BNs, 1e-4. bf16: both packages round activations to bf16 at
# each conv, BN and residual add, but oneDNN and XLA accumulate a bf16
# conv differently; the logits agree to 5e-2 and the f32 BN statistics
# (taken from bf16 activations) to 2e-2.
FORWARD_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_bn_updates_match_reference(resnet, dtype):
    logit_tol, state_tol = FORWARD_TOLS[dtype]
    params_np, state_np = resnet
    x = _images(8, seed=3).astype(np.float32) / 255.0
    jmodel = jget_model("resnet20", compute_dtype=getattr(jnp, dtype))
    tmodel = tget_model("resnet20", compute_dtype=getattr(torch, dtype))
    params, state = params_from_jax(params_np), params_from_jax(state_np)
    for train in (True, False):
        jlogits, jstate = jax.jit(functools.partial(
            jmodel.apply, train=train))(params_np, state_np, jnp.asarray(x))
        with torch.no_grad():
            tlogits, tstate = tmodel.apply(params, state,
                                           torch.from_numpy(x), train=train)
        assert tlogits.dtype == torch.float32 and tlogits.shape == (8, 10)
        assert _rel_err(tlogits.numpy(), jlogits) <= logit_tol, train
        for path, got, want in _pair_flat(tstate, jstate):
            assert _rel_err(got.numpy(), want) <= state_tol, (train, path)


def _is_pre_bn_bias(path) -> bool:
    """A conv bias that a batch norm follows: the norm subtracts it again,
    so its gradient is 0 in exact arithmetic."""
    return path[-1] == "b" and path[-2] in ("stem", "conv1", "conv2")


def test_training_step_loss_and_grads_match_reference(resnet):
    """f32, one step's loss and gradients. The loss within 1e-5. The
    reference's own f32 gradients lie up to 7% of a leaf's largest value
    from an f64 evaluation of the same function (XLA's CPU convolutions;
    measured, s2b0/conv1/w), the port's within 1.2%: each leaf of the
    port within 1e-1 of the leaf's largest reference value, and within
    2e-2 of the port's own f64 gradients. A conv bias that a batch norm
    follows has gradient 0; both packages' are within 1e-6 of the largest
    gradient of the model."""
    params_np, state_np = resnet
    images = _images(8, seed=4)
    labels = np.random.default_rng(4).integers(0, 10, (8,), dtype=np.int32)
    jmodel = jget_model("resnet20", compute_dtype=jnp.float32)
    x = jnp.asarray(images, jnp.float32) / 255.0

    def loss_of(params):
        logits, _ = jmodel.apply(params, state_np, x, train=True)
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(labels))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_of))(params_np)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    grads, losses_ = {}, {}
    for dtype in (torch.float32, torch.float64):
        params, state = (tree_map(lambda a: a.to(dtype), params_from_jax(t))
                         for t in (params_np, state_np))
        loss, _, t_state, g = loss_and_grads(
            tget_model("resnet20", compute_dtype=dtype),
            tlosses.softmax_cross_entropy, params, state, batch)
        grads[dtype], losses_[dtype] = g, loss
    assert _rel_err(losses_[torch.float32].numpy(), j_loss) <= 1e-5
    largest = max(float(np.abs(np.asarray(g)).max())
                  for g in jax.tree.leaves(j_grads))
    pairs = _pair_flat(grads[torch.float32], j_grads)
    for (path, got, want), (_, g64) in zip(
            pairs, flatten_with_path(grads[torch.float64])):
        assert got.dtype == torch.float32 and got.is_contiguous(), path
        if _is_pre_bn_bias(path):
            assert float(np.abs(want).max()) <= 1e-6 * largest, path
            assert float(got.abs().max()) <= 1e-6 * largest, path
            continue
        assert _rel_err(got.numpy(), want) <= 1e-1, path
        assert _rel_err(got.numpy(), g64.numpy()) <= 2e-2, path
    assert not any(leaf.requires_grad for _, leaf in flatten_with_path(
        t_state))


def test_train_state_from_jax_carries_bn_state_and_accumulation():
    """A reference ResNet-20 TrainState under accumulated clip + Adam
    crosses leaf for leaf: params, BN statistics, the accumulation buffer,
    its call counter and the chained slots."""
    jmodel = jget_model("resnet20")
    opt = jopt.gradient_accumulation(
        jopt.chain(jopt.clip_by_global_norm(1.0), jopt.adam(1e-3)), 2)
    jstate = jax.device_get(jax.jit(lambda key: jcreate_state(
        jmodel, opt, key, jnp.zeros((1, 32, 32, 3), jnp.uint8)))(
            jax.random.PRNGKey(0)))
    tstate = train_state_from_jax(jstate, seed=0)
    topt_ = topt.gradient_accumulation(
        topt.chain(topt.clip_by_global_norm(1.0), topt.adam(1e-3)), 2)
    fresh = topt_.init(tstate.params)
    for part in ("params", "model_state", "opt_state"):
        for path, got, want in _pair_flat(getattr(tstate, part),
                                          getattr(jstate, part)):
            assert got.dtype == torch.from_numpy(np.array(want)).dtype, path
            assert np.array_equal(got.numpy(), want), path
    assert [p for p, _ in flatten_with_path(fresh)] == [
        p for p, _ in flatten_with_path(tstate.opt_state)]
