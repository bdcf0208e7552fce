"""Parity of the port's optimizers (`dist_mnist_tpu_torch/optim/`) and of
the fused-Adam wrappers' plain CPU path against the JAX package, on the
CPU.

Both packages get the same numpy-seeded params and grads. The JAX fused
paths run the Pallas kernels in interpret mode (the reference's default
off the TPU), so the port's plain versions are held to the kernels' math.
Tolerance: 1e-6 of the largest reference value per leaf — f32 arithmetic
in the same order, where the two frameworks' `pow` (in lr_t), `sqrt` and
reductions may round a last bit apart.
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu import optim as jopt
from dist_mnist_tpu_torch import configs as tconfigs
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu.ops.pallas import fused_adam as jfused
from dist_mnist_tpu_torch.ops.kernels import fused_adam as tfused
from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
    adam_leaf_plan,
    fused_adam_clip_wd_update,
    fused_adam_clip_wd_update_leaves,
    fused_adam_cost,
    fused_adam_update,
    fused_adam_update_leaves,
)
from dist_mnist_tpu_torch.utils.tree import flatten_with_path


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the session's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


TOL = 1e-6

#: LeNet-5's 8 param leaves (the training path's update shapes)
LENET_SHAPES = {
    "conv1": {"w": (5, 5, 1, 32), "b": (32,)},
    "conv2": {"w": (5, 5, 32, 64), "b": (64,)},
    "fc1": {"w": (3136, 512), "b": (512,)},
    "fc2": {"w": (512, 10), "b": (10,)},
}
#: ragged and degenerate leaves: a 2-D leaf that is not a multiple of 128
#: lanes, a 7-vector, a 0-d scalar
ODD_SHAPES = {"w": (130, 257), "b": (7,), "s": ()}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)) / (
        float(np.max(np.abs(want), initial=0.0)) + 1e-30)


def _assert_trees_close(t_tree, j_tree, tol=TOL, what=""):
    t_flat = flatten_with_path(t_tree)
    j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(t_flat) == len(j_flat)
    for (path, got), (_, want) in zip(t_flat, j_flat):
        got = got.numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, (what, path)
        assert got.dtype == want.dtype, (what, path)
        err = _rel_err(got, want)
        assert err <= tol, f"{what} {path}: rel err {err} > {tol}"


def _run_both(t_opt, j_opt, shapes, *, steps=3, seed=0, grad_scale=1.0):
    """`steps` updates of both optimizers on the same params and fresh
    numpy grads each step; compares updates, state and params after each."""
    rng = np.random.default_rng(seed)
    params_np = _tree(shapes, rng)
    j_params = jax.tree.map(jnp.asarray, params_np)
    t_params = params_from_jax(params_np)
    j_state, t_state = j_opt.init(j_params), t_opt.init(t_params)
    for step in range(steps):
        grads_np = _tree(shapes, rng, grad_scale)
        j_upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads_np),
                                      j_state, j_params)
        t_upd, t_state = t_opt.update(params_from_jax(grads_np), t_state,
                                      t_params)
        _assert_trees_close(t_upd, j_upd, what=f"updates@{step}")
        _assert_trees_close(t_state, j_state, what=f"state@{step}")
        j_params = jopt.apply_updates(j_params, j_upd)
        t_params = topt.apply_updates(t_params, t_upd)
        _assert_trees_close(t_params, j_params, what=f"params@{step}")
    return t_state


OPTIMIZERS = {
    "adam": (lambda m: m.adam(1e-3)),
    "adam_fused": (lambda m: m.adam(1e-3, fused=True)),
    "adamw": (lambda m: m.adamw(1e-3, weight_decay=0.01)),
    # the settings of the reference's kernel bench: clip + decoupled decay
    "fused_adamw_clip_wd": (
        lambda m: m.fused_adamw(1e-3, weight_decay=0.01, clip_norm=0.5)),
    "fused_adamw_wd_only": (lambda m: m.fused_adamw(1e-3, weight_decay=0.02)),
    "fused_adamw_clip_only": (lambda m: m.fused_adamw(1e-3, clip_norm=0.5)),
    # wd=0 and no clip: routed to the fused_adam_update kernel
    "fused_adamw_off_path": (lambda m: m.fused_adamw(1e-3)),
    "chain_clip_adamw": (lambda m: m.chain(m.clip_by_global_norm(0.5),
                                           m.adamw(1e-3, weight_decay=0.01))),
    "adam_cosine": (lambda m: m.adam(m.schedules.cosine_decay(1e-2, 4, 1))),
    "sgd": (lambda m: m.sgd(0.1)),
    "momentum_nesterov": (lambda m: m.momentum(0.1, 0.9, nesterov=True)),
    "l2_scale_momentum": (lambda m: m.chain(m.add_decayed_weights(1e-3),
                                            m.scale(0.5),
                                            m.momentum(0.1, 0.9))),
}


@pytest.mark.parametrize("shapes", [ODD_SHAPES, LENET_SHAPES],
                         ids=["odd", "lenet5"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name, shapes):
    make = OPTIMIZERS[name]
    # grads of norm well above 0.5, so the clip is active where present
    _run_both(make(topt), make(jopt), shapes, grad_scale=3.0)


def test_fused_adamw_off_path_is_adam_fused_bitwise():
    """wd=0 and no clip routes to the same kernel as adam(fused=True):
    the same bits, as in the reference."""
    rng = np.random.default_rng(11)
    params = params_from_jax(_tree(ODD_SHAPES, rng))
    grads = params_from_jax(_tree(ODD_SHAPES, rng))
    a, f = topt.adam(1e-3, fused=True), topt.fused_adamw(1e-3)
    before = (fused_adam_update.launches, fused_adam_clip_wd_update.launches)
    u_a, s_a = a.update(grads, a.init(params), params)
    u_f, s_f = f.update(grads, f.init(params), params)
    for ta, tf in ((u_a, u_f), (s_a["m"], s_f["m"]), (s_a["v"], s_f["v"])):
        for (_, x), (_, y) in zip(flatten_with_path(ta),
                                  flatten_with_path(tf)):
            assert torch.equal(x, y)
    assert set(s_f) == {"m", "v", "count"}
    assert s_f["count"].dtype == torch.int32 and int(s_f["count"]) == 1
    # CPU tensors take the plain version: no kernel launch is counted
    assert (fused_adam_update.launches,
            fused_adam_clip_wd_update.launches) == before


@pytest.mark.parametrize("name", ["mlp_mnist", "lenet5_mnist"])
@pytest.mark.parametrize("overrides", [
    {}, {"grad_clip_norm": 1.0}, {"weight_decay": 0.01},
    {"optimizer": "momentum", "weight_decay": 0.01},
    {"lr_schedule": "cosine", "warmup_steps": 1, "train_steps": 4},
], ids=["default", "clip", "adamw", "momentum_l2", "cosine"])
def test_build_optimizer_matches_reference(name, overrides):
    from dist_mnist_tpu.cli.train import build_optimizer as jbuild

    _run_both(topt.build_optimizer(tconfigs.get_config(name, **overrides)),
              jbuild(jconfigs.get_config(name, **overrides)), ODD_SHAPES,
              grad_scale=3.0)


def test_build_optimizer_refuses_gradient_accumulation():
    """No longer refused: ``replicas_to_aggregate=2`` builds the
    reference's accumulation around clip + Adam on the cosine horizon in
    updates; updates, state (buffer, calls, inner slots) and params within
    TOL of the reference's over two boundaries."""
    from dist_mnist_tpu.cli.train import build_optimizer as jbuild

    over = dict(replicas_to_aggregate=2, grad_clip_norm=1.0,
                lr_schedule="cosine", warmup_steps=2, train_steps=8)
    state = _run_both(
        topt.build_optimizer(tconfigs.get_config("lenet5_mnist", **over)),
        jbuild(jconfigs.get_config("lenet5_mnist", **over)), ODD_SHAPES,
        steps=4, grad_scale=3.0)
    assert int(state["calls"]) == 4


def _leaf(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def test_wrappers_reject_what_the_kernels_do_not_take():
    g, m, v = _leaf((4, 8)), _leaf((4, 8), 1), _leaf((4, 8), 2).abs()
    lr = torch.full((), 1e-3)
    with pytest.raises(TypeError, match="float32"):
        fused_adam_update(g.to(torch.bfloat16), m, v, lr)
    with pytest.raises(ValueError, match="shapes differ"):
        fused_adam_update(g, m[:2], v, lr)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam_update(g.t(), m.t(), v.t(), lr)
    with pytest.raises(ValueError, match="scalar"):
        fused_adam_update(g, m, v, torch.ones(2))
    with pytest.raises(ValueError, match="3 scalar"):
        fused_adam_clip_wd_update(g, m, v, g, lr)
    # neither the CPU nor CUDA: the wrapper raises instead of computing
    meta = [t.to("meta") for t in (g, m, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_adam_update(*meta, lr.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_adam_clip_wd_update(*meta, meta[0], torch.ones(3,
                                                             device="meta"))


def test_cost_counts_the_bytes_each_pass_must_move():
    numels = [32, 800, 64, 51200, 512, 1605632, 10, 5120]
    assert sum(numels) == 1_663_370  # LeNet-5's parameters
    assert fused_adam_cost(numels)["hbm_bytes"] == 24 * 1_663_370
    assert fused_adam_cost(numels, clip_wd=True)["hbm_bytes"] == \
        28 * 1_663_370


#: LeNet-5's leaf sizes; ViT-Tiny's 152 (depth 12: per block two layer
#: norms' scale and bias, qkv, out, two MLP layers' weight and bias; then
#: the patch embedding, class token, position embedding, the final norm
#: and the head at 10 classes), in `flatten_with_path` order
LENET_NUMELS = [32, 800, 64, 51200, 512, 1605632, 10, 5120]
VIT_NUMELS = [192, 36864, 576, 110592, 192, 192, 192, 192, 768, 147456,
              192, 147456] * 12 + [192, 192, 192, 10, 1920, 192, 9216, 12480]


def test_vit_numels_are_vit_tiny_leaves():
    from dist_mnist_tpu_torch.models.vit import ViTTiny

    params, _ = ViTTiny().init(torch.Generator().manual_seed(0),
                               torch.zeros(1, 32, 32, 3))
    assert [t.numel() for _, t in flatten_with_path(params)] == VIT_NUMELS


@pytest.mark.parametrize("numels", [LENET_NUMELS, VIT_NUMELS, [1, 7, 129],
                                    [0, 5, 0, 4096, 4097, 3]],
                         ids=["lenet5", "vit_tiny", "ragged", "empty"])
def test_adam_leaf_plan_offsets_are_multiples_of_4(numels):
    """Every leaf's outputs start on a multiple of 4 elements (16 bytes,
    so the next step's m and v take the float4 loop) and do not overlap."""
    plan = adam_leaf_plan(numels)
    assert len(plan.offsets) == len(numels)
    ends = 0
    for off, n in zip(plan.offsets, numels):
        assert off % 4 == 0 and off >= ends
        ends = off + n
    assert plan.total >= ends and plan.total % 4 == 0


@pytest.mark.parametrize("numels", [LENET_NUMELS, VIT_NUMELS, [1, 7, 129],
                                    [0, 5, 0, 4096, 4097, 3]],
                         ids=["lenet5", "vit_tiny", "ragged", "empty"])
def test_adam_leaf_plan_chunks_cover_each_leaf_once(numels):
    """Each table's chunks (one block each) run 0 .. chunks - 1, each leaf
    takes ceil(n / CHUNK) consecutive ones from its first, and every leaf
    with elements is in exactly one table, in order."""
    plan = adam_leaf_plan(numels)
    seen = []
    for leaves, firsts, chunks in plan.tables:
        owner = []
        for i, first in zip(leaves, firsts):
            assert first == len(owner)
            owner += [i] * -(-numels[i] // tfused.CHUNK)
        assert len(owner) == chunks > 0
        for i in leaves:  # the chunks of a leaf hold its elements once
            assert owner.count(i) * tfused.CHUNK >= numels[i] > (
                owner.count(i) - 1) * tfused.CHUNK
        seen += leaves
    assert seen == [i for i, n in enumerate(numels) if n > 0]


def test_adam_leaf_plan_splits_vit_tiny_into_tables_that_fit_4kb():
    """ViT-Tiny's 152 leaves: more than one table, each of at most
    `TABLE_LEAVES` leaves, whose bytes with the launch's four pointers and
    five f32 constants fit the 4 KB a launch's parameters may take."""
    assert len(VIT_NUMELS) == 152
    plan = adam_leaf_plan(VIT_NUMELS)
    assert [len(t[0]) for t in plan.tables] == [64, 64, 24]
    assert all(len(t[0]) <= tfused.TABLE_LEAVES for t in plan.tables)
    assert tfused.TABLE_BYTES + 4 * 8 + 5 * 4 <= 4096
    assert len(adam_leaf_plan(LENET_NUMELS).tables) == 1


def _leaf_arrays(seed):
    rng = np.random.default_rng(seed)
    shapes = [leaf for layer in LENET_SHAPES.values()
              for leaf in layer.values()]
    return [[rng.standard_normal(sh).astype(np.float32) * scale
             for sh in shapes] for scale in (1.0, 0.1, 0.01, 1.0)]


@pytest.mark.parametrize("clip_wd", [False, True], ids=["adam", "clip_wd"])
def test_leaves_update_matches_jax_kernel_leaf_by_leaf(clip_wd):
    """LeNet-5's 8 leaves through one `*_leaves` call (on the CPU: the
    plain version, leaf by leaf) against the JAX Pallas kernels (interpret
    mode) one leaf at a time: delta, m' and v' within `TOL` of the largest
    value per leaf."""
    g, m, v, p = _leaf_arrays(3)
    v = [np.abs(x) for x in v]
    lr_t, clip, wd = np.float32(3e-3), np.float32(0.37), np.float32(1e-5)
    tg, tm, tv, tp = ([torch.from_numpy(x.copy()) for x in xs]
                      for xs in (g, m, v, p))
    if clip_wd:
        got = fused_adam_clip_wd_update_leaves(
            tg, tm, tv, tp, torch.tensor([lr_t, clip, wd]))
    else:
        got = fused_adam_update_leaves(tg, tm, tv, torch.tensor(lr_t))
    for i in range(len(g)):
        if clip_wd:
            want = jfused.fused_adam_clip_wd_update(
                jnp.asarray(g[i]), jnp.asarray(m[i]), jnp.asarray(v[i]),
                jnp.asarray(p[i]), lr_t, clip, wd)
        else:
            want = jfused.fused_adam_update(
                jnp.asarray(g[i]), jnp.asarray(m[i]), jnp.asarray(v[i]),
                lr_t)
        for out, ref in zip((x[i] for x in got), want):
            assert out.shape == ref.shape
            assert _rel_err(out.numpy(), ref) <= TOL
