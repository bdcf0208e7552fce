"""Parity of the port's ViT-Tiny training slice against the JAX package, on
the CPU: the configs, CIFAR-10 loading, augmentation, the model (both
attention paths, both pools, the stacked `blocks` layout), carried-over
params, remat, three training steps and the bench's config mode.

Params are JAX-initialized and carried across with
`convert.params_from_jax`; inputs are numpy-seeded and fed to both
packages. The JAX ViT runs its `"xla"` attention; the port's `"flash"`
path takes its kernels' plain versions on the CPU (the kernels themselves
are held to those on the card, tests/test_torch_cuda.py). Models run in
f32 here, where the point is the algorithm. Each tolerance is stated
beside its check.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cli.train import build_optimizer as jbuild_optimizer
from dist_mnist_tpu.data import datasets as jdatasets
from dist_mnist_tpu.data.augment import random_crop_flip as jcrop_flip
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.models.vit import convert_block_layout as jconvert
from dist_mnist_tpu.ops import losses as jlosses
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu_torch import bench as tbench
from dist_mnist_tpu_torch import configs as tconfigs
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.data.augment import crop_flip, random_crop_flip
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.models.vit import convert_block_layout
from dist_mnist_tpu_torch.ops import losses as tlosses
from dist_mnist_tpu_torch.train import TrainState, make_train_step
from dist_mnist_tpu_torch.train.step import loss_and_grads
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

#: the small ViT of these tests: depth 2, dim 64, 4 heads, 8x8 patches
#: (16 patch tokens of a 32x32 image), f32, the stacked layout
SMALL = dict(depth=2, dim=64, heads=4, patch=8, scan_blocks=True)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


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


def _batch(n, seed, shape=(32, 32, 3)):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, *shape), dtype=np.uint8),
            "label": rng.integers(0, 10, (n,), dtype=np.int32)}


def _t_batch(batch_np):
    return {k: torch.from_numpy(v.copy()) for k, v in batch_np.items()}


def _pair(impl="xla", dropout=0.0, **kw):
    kw = {**SMALL, "dropout_rate": dropout, **kw}
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **kw)
    tmodel = tget_model("vit_tiny", compute_dtype=torch.float32,
                        attention_impl=impl, **kw)
    return jmodel, tmodel


def _jax_params(jmodel, seed=0):
    params, _ = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 32, 32, 3)))
    return jax.device_get(params)


# -- configs, data, augmentation ----------------------------------------------

@pytest.mark.parametrize("name", ["vit_tiny_cifar", "vit_tiny_cifar_flash",
                                  "vit_tiny_cifar_tp",
                                  "vit_tiny_cifar_fsdp_tp",
                                  "vit_tiny_cifar_ring",
                                  "vit_tiny_cifar_ring_flash",
                                  "vit_tiny_cifar_ulysses",
                                  "vit_tiny_cifar_ulysses_flash",
                                  "vit_tiny_cifar_moe",
                                  "vit_tiny_cifar_pp"])
def test_vit_config_entries_equal_reference_field_for_field(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cifar_synthetic_twin_byte_identical_to_reference(tmp_path):
    kw = dict(seed=3, synthetic_sizes=(120, 30), cache_synthetic=False)
    got = tdatasets.load_dataset("cifar10", tmp_path / "t", **kw)
    want = jdatasets.load_dataset("cifar10", tmp_path / "j", **kw)
    assert got.synthetic and want.synthetic
    assert got.image_shape == want.image_shape == (32, 32, 3)
    for field in ("train_images", "train_labels", "test_images",
                  "test_labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_cifar_npz_cache_is_shared_with_reference(tmp_path):
    raw = jdatasets._synth("cifar10", 40, 12, 5)
    jdatasets._write_synth_cache(tmp_path / "j", "cifar10", raw)
    got = tdatasets.load_dataset("cifar10", tmp_path / "j",
                                 synthetic_sizes=(1, 1))
    assert got.synthetic
    assert got.train_images.tobytes() == raw["train_x"].tobytes()
    tdatasets._write_synth_cache(tmp_path / "t", "cifar10", raw)
    back = jdatasets.load_dataset("cifar10", tmp_path / "t",
                                  synthetic_sizes=(1, 1))
    assert back.synthetic
    assert back.test_images.tobytes() == raw["test_x"].tobytes()
    assert np.array_equal(back.test_labels, raw["test_y"])


def test_cifar_batches_dir_loads_as_reference(tmp_path):
    """The real dataset's python pickles, made small: both packages read
    the same arrays, flagged real."""
    rng = np.random.default_rng(4)
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (7, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, 7).tolist()}
        with open(batch_dir / name, "wb") as f:
            pickle.dump(d, f)
    got = tdatasets.load_dataset("cifar10", tmp_path)
    want = jdatasets.load_dataset("cifar10", tmp_path)
    assert not got.synthetic and not want.synthetic
    assert got.train_images.shape == (35, 32, 32, 3)
    for field in ("train_images", "train_labels", "test_images",
                  "test_labels"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


def test_augment_core_bitwise_equal_to_reference():
    """The reference's own draws (its key split, crop origins and flip
    bits) fed to the port's deterministic core: the same uint8 bytes."""
    images = _batch(16, seed=5)["image"]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcrop_flip(key, jnp.asarray(images)))
    k_crop, k_flip = jax.random.split(key)
    oy, ox = np.array(jax.random.randint(k_crop, (2, 16), 0, 9))
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (16,)))
    assert flips.any() and not flips.all()
    got = crop_flip(torch.from_numpy(images), torch.from_numpy(oy),
                    torch.from_numpy(ox), torch.from_numpy(flips)).numpy()
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def test_random_crop_flip_draws_from_its_generator():
    images = torch.from_numpy(_batch(32, seed=6)["image"])
    a = random_crop_flip(torch.Generator().manual_seed(1), images)
    b = random_crop_flip(torch.Generator().manual_seed(1), images)
    c = random_crop_flip(torch.Generator().manual_seed(2), images)
    assert a.shape == images.shape and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    # pad 0 and no flip is the identity
    same = random_crop_flip(torch.Generator(), images, pad=0, flip=False)
    assert torch.equal(same, images)


# -- the model ---------------------------------------------------------------

def test_vit_flops_per_example_matches_reference():
    """DeiT-Ti on CIFAR (S = 65): ~0.730 GFLOP forward per example."""
    jm = jget_model("vit_tiny", scan_blocks=True)
    tm = tget_model("vit_tiny", scan_blocks=True)
    shape = (1, 32, 32, 3)
    assert tm.flops_per_example(shape) == jm.flops_per_example(shape)
    assert abs(tm.flops_per_example(shape) / 1e9 - 0.730) < 1e-3
    assert tm.n_tokens(shape) == 65


def test_params_from_jax_carries_the_stacked_vit_tree():
    """Every leaf crosses in its layout and bits, the stacked `blocks`
    leaves with their leading depth axis; `convert_block_layout` unstacks
    and restacks as the reference's does."""
    jmodel, tmodel = _pair()
    jparams = _jax_params(jmodel)
    params = params_from_jax(jparams)
    flat = flatten_with_path(params)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(want)
    for (path, leaf), (_, w) in zip(flat, want):
        assert leaf.dtype == torch.float32 and tuple(leaf.shape) == w.shape
        assert leaf.numpy().tobytes() == np.asarray(w).tobytes(), path
    blocks = params["blocks"]
    assert blocks["attn"]["qkv"]["w"].shape == (2, 64, 192)
    assert blocks["mlp_in"]["w"].shape == (2, 64, 256)
    unrolled = convert_block_layout(params)
    junrolled = params_from_jax(jax.device_get(jconvert(jparams)))
    assert sorted(unrolled) == sorted(junrolled)
    for (_, a), (_, b) in zip(flatten_with_path(unrolled),
                              flatten_with_path(junrolled)):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(flatten_with_path(
            convert_block_layout(unrolled)), flat):
        assert torch.equal(a, b)
    # and the port's own init has the reference's tree and shapes
    own, _ = tmodel.init(torch.Generator().manual_seed(0),
                         torch.zeros(1, 32, 32, 3))
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(own)] == \
        [(p, tuple(x.shape)) for p, x in flat]


def test_params_from_jax_carries_the_ulysses_geometry():
    """`vit_tiny_cifar_ulysses`' model at full width (dim 192, 4 heads of
    48, mean pool, the stacked layout): the reference's init converts
    leaf for leaf, and the port's ViT on it (no seq axis: Ulysses falls
    back to the plain attention) gives the reference's logits, f32,
    within 2e-4 / 2e-5."""
    kw = dict(tconfigs.get_config("vit_tiny_cifar_ulysses").model_kwargs)
    assert kw["heads"] == 4 and kw["pool"] == "mean"
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **kw)
    tmodel = tget_model("vit_tiny", compute_dtype=torch.float32, **kw)
    jparams = _jax_params(jmodel, seed=7)
    params = params_from_jax(jparams)
    assert params["blocks"]["attn"]["qkv"]["w"].shape == (12, 192, 576)
    assert "cls" not in params and params["pos"].shape == (1, 64, 192)
    x = _batch(2, seed=9)["image"].astype(np.float32) / np.float32(255)
    want, _ = jmodel.apply(jparams, {}, jnp.asarray(x), train=False)
    got, _ = tmodel.apply(params, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def _loss_and_grads_pair(jmodel, tmodel, params_np, batch_np, mask=None):
    x = batch_np["image"].astype(np.float32) / np.float32(255)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p):
        logits, _ = jmodel.apply(p, {}, jnp.asarray(x), mask=jmask)
        return (jlosses.softmax_cross_entropy(
            logits, jnp.asarray(batch_np["label"])), logits)

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    params = params_from_jax(params_np)
    leaves = [leaf.requires_grad_() for _, leaf in flatten_with_path(params)]
    logits, _ = tmodel.apply(params, {}, torch.from_numpy(x),
                             mask=None if mask is None
                             else torch.from_numpy(mask))
    loss = tlosses.softmax_cross_entropy(logits,
                                         torch.from_numpy(batch_np["label"]))
    grads = torch.autograd.grad(loss, leaves)
    return (j_logits, j_grads), (logits.detach(), grads)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_logits_and_grads_match_reference(impl, pool):
    """Logits within 2e-4/2e-5 and every param grad within 5e-4/5e-5 of
    the JAX ViT's ("xla", f32): the same arithmetic up to summation order
    (tests/test_parallel_attention.py's ViT bounds)."""
    jmodel, tmodel = _pair(impl, pool=pool)
    (j_logits, j_grads), (logits, grads) = _loss_and_grads_pair(
        jmodel, tmodel, _jax_params(jmodel, seed=1), _batch(6, seed=7))
    assert logits.shape == (6, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               **LOGIT_TOL)
    jflat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    assert len(jflat) == len(grads)
    for g, (path, jg) in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_vit_token_mask_matches_reference(impl):
    """Right-padded heights under a key-prefix token mask (zoo serving):
    the "flash" path takes the masked kernels; logits and grads as the
    reference's masked "xla" path."""
    jmodel, tmodel = _pair(impl, pool="mean")
    mask = np.ones((3, 16), bool)
    mask[0, 4:] = False  # one patch row of four real
    mask[1, 12:] = False
    (j_logits, j_grads), (logits, grads) = _loss_and_grads_pair(
        jmodel, tmodel, _jax_params(jmodel, seed=2), _batch(3, seed=8),
        mask=mask)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               **LOGIT_TOL)
    for g, (path, jg) in zip(grads,
                             jax.tree_util.tree_flatten_with_path(j_grads)[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("kw,err", [
    # ring and Ulysses build (tests/test_torch_seq.py), and since the
    # model-parallel slice MoE blocks and the block pipeline beside them
    # (tests/test_torch_moe.py, tests/test_torch_pp.py): off an expert or
    # pipe mesh they run all experts local and the plain stack
    ({"attention_impl": "ring", "mlp_impl": "moe"}, None),
    ({"attention_impl": "ulysses_flash", "block_pipeline": 2}, None),
    ({"mlp_impl": "moe"}, None),
    ({"block_pipeline": 4}, None),
    ({"attention_impl": "sparse"}, ValueError),
    ({"pool": "max"}, ValueError),
])
def test_vit_refuses_what_later_slices_bring(kw, err):
    """What the ViT still refuses raises; what the later slices brought
    builds and runs a finite forward on one process (an MoE model's state
    holding its aux loss and stats, the dense fallback's ep_engaged 0)."""
    if err is not None:
        with pytest.raises(err):
            tget_model("vit_tiny", **kw)
        return
    model = tget_model("vit_tiny", **{**SMALL, "depth": 4, **kw})
    x = torch.rand(2, 32, 32, 3)
    params, state = model.init(torch.Generator().manual_seed(0), x)
    logits, new_state = model.apply(params, state, x)
    assert torch.isfinite(logits).all() and logits.shape == (2, 10)
    assert set(new_state) == set(state)
    if kw.get("mlp_impl") == "moe":
        assert float(new_state["moe_aux"]) > 0
        assert float(new_state["moe_ep_engaged_metric"]) == 0.0


# -- training: remat, three steps, the bench ---------------------------------

def test_remat_grads_equal_no_remat_grads_with_dropout():
    """Dropout 0.1 and augmentation on, one generator seed: the remat
    step's grads equal the plain step's bit for bit. Masks drawn inside
    the checkpointed region would be drawn again, differently, by the
    recompute, and every grad would move."""
    _, tmodel = _pair("flash", dropout=0.1)
    params, _ = tmodel.init(torch.Generator().manual_seed(3),
                            torch.zeros(1, 32, 32, 3))
    batch = _t_batch(_batch(8, seed=9))
    out = {}
    for remat in (False, True):
        out[remat] = loss_and_grads(
            tmodel, tlosses.softmax_cross_entropy, params, {}, batch,
            rng=torch.Generator().manual_seed(11), remat=remat,
            augment=True)
    assert torch.equal(out[False][0], out[True][0])
    for (path, a), (_, b) in zip(flatten_with_path(out[False][3]),
                                 flatten_with_path(out[True][3])):
        assert torch.equal(a, b), path
    # and dropout did act: another seed gives other grads
    other = loss_and_grads(tmodel, tlosses.softmax_cross_entropy, params, {},
                           batch, rng=torch.Generator().manual_seed(12),
                           remat=True, augment=True)
    assert not torch.equal(other[0], out[True][0])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_no_batch_keeps_the_weight_matmuls():
    """What each policy saves and what its recompute runs again, counted
    over one forward and backward (the flash path; on the CPU its plain
    version's products are batched matmuls): `dots_no_batch` keeps the
    2-D weight products, so a remat step runs as many `aten.mm` as a
    plain one, and one more patch convolution, the batched products and
    the ``attn_out`` tags again; `save_attn` keeps the tags too (one a
    layer, not run again); `dots` keeps every matmul, the batched ones
    included; `nothing` recomputes the matmuls too."""
    _, tmodel = _pair("flash")
    params, _ = tmodel.init(torch.Generator().manual_seed(4),
                            torch.zeros(1, 32, 32, 3))
    batch = _t_batch(_batch(4, seed=10))
    counts = {}
    for label, kw in (("plain", {}),
                      ("dots_no_batch", dict(remat=True)),
                      ("save_attn", dict(remat=True,
                                         remat_policy="save_attn")),
                      ("dots", dict(remat=True, remat_policy="dots")),
                      ("nothing", dict(remat=True, remat_policy="nothing"))):
        with _CountOps() as c:
            loss_and_grads(tmodel, tlosses.softmax_cross_entropy, params, {},
                           batch, **kw)
        counts[label] = c.counts

    def count(op):
        return {k: v.get(op, 0) for k, v in counts.items()}

    mm, bmm = count("aten.mm.default"), count("aten.bmm.default")
    conv = count("aten.convolution.default")
    tags = count("dist_mnist_tpu_torch.checkpoint_name.default")
    depth = SMALL["depth"]
    assert mm["dots_no_batch"] == mm["save_attn"] == mm["dots"] \
        == mm["plain"] > 0
    assert mm["nothing"] > mm["plain"]
    assert bmm["dots"] == bmm["plain"] > 0
    assert bmm["dots_no_batch"] == bmm["save_attn"] == bmm["nothing"] \
        > bmm["plain"]
    assert tags == {"plain": depth, "dots_no_batch": 2 * depth,
                    "save_attn": depth, "dots": 2 * depth,
                    "nothing": 2 * depth}
    assert conv == {"plain": 1, "dots_no_batch": 2, "save_attn": 2,
                    "dots": 2, "nothing": 2}


@pytest.mark.parametrize("policy", ["dots_no_batch", "save_attn", "dots",
                                    "nothing"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_policies_give_the_gradients_of_no_remat_bitwise(impl,
                                                               policy):
    """A remat policy changes what is saved, never a number: the loss
    and every gradient the same bits as without remat (dropout masks
    passed, as the step draws them)."""
    _, tmodel = _pair(impl, dropout=0.1)
    params, _ = tmodel.init(torch.Generator().manual_seed(6),
                            torch.zeros(1, 32, 32, 3))
    batch = _t_batch(_batch(4, seed=11))
    mask = tmodel.dropout_masks(torch.Generator().manual_seed(2),
                                torch.zeros(4, 32, 32, 3))
    base = loss_and_grads(tmodel, tlosses.softmax_cross_entropy, params, {},
                          batch, dropout_mask=mask)
    got = loss_and_grads(tmodel, tlosses.softmax_cross_entropy, params, {},
                         batch, dropout_mask=mask, remat=True,
                         remat_policy=policy)
    assert torch.equal(got[0], base[0])
    for a, b in zip(flatten_with_path(got[3]), flatten_with_path(base[3])):
        assert torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("policy,err", [("save_attn", None),
                                        ("dots", None),
                                        ("everything", ValueError)])
def test_remat_policies_the_port_lacks_raise(policy, err):
    """Every policy of the reference builds a step (`save_attn` and `dots`
    since the sequence-parallel slice); a name it lacks raises."""
    _, tmodel = _pair()
    if err is None:
        assert callable(make_train_step(tmodel, topt.adam(1e-3), remat=True,
                                        remat_policy=policy))
        return
    with pytest.raises(err):
        make_train_step(tmodel, topt.adam(1e-3), remat=True,
                        remat_policy=policy)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_train_steps_match_reference(mesh1, impl):
    """Three steps of the config's recipe (global-norm clip 1.0, AdamW
    0.05, cosine; warm-up cut to 1 step so that the steps move the
    params) with remat on, dropout 0 and augmentation off, on the same
    batches from carried-over params: the losses within 1e-5 relative
    (f32 all the way)."""
    cfg_kw = dict(warmup_steps=1, train_steps=4)
    tcfg = tconfigs.get_config("vit_tiny_cifar_flash", **cfg_kw)
    jcfg = jconfigs.get_config("vit_tiny_cifar_flash", **cfg_kw)
    jmodel, tmodel = _pair(impl)
    jopt, topt_ = jbuild_optimizer(jcfg), topt.build_optimizer(tcfg)
    batches = [_batch(8, seed=20 + i) for i in range(3)]
    with mesh1:
        jstate = jcreate_state(jmodel, jopt, jax.random.PRNGKey(5),
                               jnp.zeros((1, 32, 32, 3), jnp.uint8))
        params = params_from_jax(jax.device_get(jstate.params))
        jstep = jmake_train_step(jmodel, jopt, mesh1, donate=False,
                                 remat=True, remat_policy="dots_no_batch")
        j_losses = []
        for b in batches:
            jstate, jout = jstep(jstate, shard_batch(b, mesh1))
            j_losses.append(float(jout["loss"]))
    tstate = TrainState(torch.zeros((), dtype=torch.int32), params, {},
                        topt_.init(params), torch.Generator())
    tstep = make_train_step(tmodel, topt_, remat=True)
    t_losses = []
    for b in batches:
        tstate, tout = tstep(tstate, _t_batch(b))
        t_losses.append(float(tout["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert len(set(t_losses)) == 3  # the params moved


CONFIG_EXTRA_KEYS = {"chips", "mesh", "global_batch", "batch_note",
                     "examples_per_sec", "mfu", "flops_per_step",
                     "flops_basis", "model_tflops_per_sec", "device_kind",
                     "peak_bf16_tflops", "timed_steps", "steps_run",
                     "chunk_losses"}


def test_bench_config_mode_runs_a_small_width_on_cpu(monkeypatch, capsys):
    """`run_config` at a small width through `main`'s config path: the
    reference's record schema, its per-chip batch (1024 // 16), the
    analytic MFU numerator, a finite loss per chunk."""
    small = dataclasses.replace(
        tconfigs.get_config("vit_tiny_cifar_flash"),
        model_kwargs={"attention_impl": "flash", **SMALL})
    monkeypatch.setitem(tbench.CONFIGS, "vit_tiny_cifar_flash", small)
    ds = tdatasets.load_dataset("cifar10", "/nonexistent", seed=0,
                                synthetic_sizes=(256, 32),
                                cache_synthetic=False)
    monkeypatch.setattr(tbench, "load_dataset", lambda *a, **k: ds)
    orig = tbench.run_config
    monkeypatch.setattr(tbench, "run_config",
                        lambda *a, **k: orig(*a, **k, chunk=2))
    rec = tbench.main(["--config", "vit_tiny_cifar_flash", "--steps", "4",
                       "--device=cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert rec["metric"] == "vit_tiny_cifar_flash_steps_per_sec_per_chip"
    assert rec["unit"] == "steps/sec/chip" and rec["value"] > 0
    assert rec["synthetic_data"] is True
    assert CONFIG_EXTRA_KEYS <= set(rec["extra"])
    extra = rec["extra"]
    assert extra["global_batch"] == 64 and extra["chips"] == 1
    assert extra["batch_note"].startswith("per-chip geometry of the "
                                          "16-chip ladder config: 64/chip")
    assert extra["mfu"] is None and extra["device_kind"] == "cpu"
    model = tget_model("vit_tiny", **small.model_kwargs)
    assert extra["flops_per_step"] == 64 * 3 * model.flops_per_example(
        (1, 32, 32, 3))
    assert extra["timed_steps"] == 4 and extra["steps_run"] == 6
    assert len(extra["chunk_losses"]) == 3
    assert np.isfinite(extra["chunk_losses"]).all()


@pytest.mark.parametrize("name,match", [
    ("vit_tiny_cifar_moe", None),
    ("vit_tiny_cifar_pp", None),
    ("no_such_config", "unknown config"),
])
def test_bench_config_mode_refuses_what_the_port_lacks(name, match,
                                                       monkeypatch, capsys):
    """An unknown config exits naming the port's configs; the MoE and
    pipeline configs (refused until the model-parallel slice) run at a
    small width on one process: their model = 4 and pipe = 4 meshes fall
    back to the one rank there is, as the note says, the MoE layers all
    experts local and the blocks the plain stack, with a finite loss per
    chunk. `LATER_CONFIGS` is gone."""
    assert not hasattr(tbench, "LATER_CONFIGS")
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            tbench.main(["--config", name, "--device=cpu"])
        return
    cfg = tconfigs.get_config(name)
    monkeypatch.setitem(tbench.CONFIGS, name, dataclasses.replace(
        cfg, model_kwargs={**cfg.model_kwargs, **SMALL, "depth": 4}))
    ds = tdatasets.load_dataset("cifar10", "/nonexistent", seed=0,
                                synthetic_sizes=(256, 32),
                                cache_synthetic=False)
    monkeypatch.setattr(tbench, "load_dataset", lambda *a, **k: ds)
    orig = tbench.run_config
    monkeypatch.setattr(tbench, "run_config",
                        lambda *a, **k: orig(*a, **k, chunk=2))
    rec = tbench.main(["--config", name, "--steps", "2", "--device=cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    extra = rec["extra"]
    assert extra["chips"] == 1 and extra["global_batch"] == 64
    assert extra["mesh_note"].startswith("fallback (config wants")
    assert np.isfinite(extra["chunk_losses"]).all()


def test_bench_config_mode_runs_a_sequence_parallel_config(monkeypatch,
                                                           capsys):
    """`vit_tiny_cifar_ring_flash` (refused until the sequence-parallel
    slice) at a small width on one process: its seq = 2 mesh falls back
    to the one rank there is, as the note says, the ring runs its flash
    engine's exact attention, at the ladder's per-chip batch 64, with a
    finite loss per chunk."""
    name = "vit_tiny_cifar_ring_flash"
    cfg = tconfigs.get_config(name)
    monkeypatch.setitem(tbench.CONFIGS, name, dataclasses.replace(
        cfg, model_kwargs={**cfg.model_kwargs, **SMALL}))
    ds = tdatasets.load_dataset("cifar10", "/nonexistent", seed=0,
                                synthetic_sizes=(256, 32),
                                cache_synthetic=False)
    monkeypatch.setattr(tbench, "load_dataset", lambda *a, **k: ds)
    orig = tbench.run_config
    monkeypatch.setattr(tbench, "run_config",
                        lambda *a, **k: orig(*a, **k, chunk=2))
    rec = tbench.main(["--config", name, "--steps", "2", "--device=cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    extra = rec["extra"]
    assert rec["metric"] == f"{name}_steps_per_sec_per_chip"
    assert extra["chips"] == 1 and extra["global_batch"] == 64
    assert extra["mesh_note"].startswith("fallback (config wants")
    assert np.isfinite(extra["chunk_losses"]).all()


@pytest.mark.parametrize("name,chips,batch", [
    ("vit_tiny_cifar_flash", 1, 64), ("vit_tiny_cifar_flash", 4, 256),
    ("vit_tiny_cifar_flash", 16, 1024), ("lenet5_mnist", 1, 200),
    ("lenet5_mnist", 8, 1600)])
def test_ladder_batch_keeps_the_per_chip_batch(name, chips, batch):
    """The reference's `bench.py ladder_batch`: the config's batch on its
    own chip count, its per-chip batch times the chips on any other."""
    got, note = tbench.ladder_batch(tconfigs.get_config(name), chips)
    assert got == batch
    assert (note == "config global batch") == (
        chips == tconfigs.get_config(name).ladder_devices)


def test_dropout_masks_are_drawn_per_layer_from_the_generator():
    _, tmodel = _pair("flash", dropout=0.1)
    x = torch.zeros(5, 32, 32, 3)
    a = tmodel.dropout_masks(torch.Generator().manual_seed(0), x)
    b = tmodel.dropout_masks(torch.Generator().manual_seed(0), x)
    assert a.shape == (2, 5, 17, 256) and a.dtype == torch.bool
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert abs(float(a.float().mean()) - 0.9) < 0.01
    _, nodrop = _pair("flash", dropout=0.0)
    assert nodrop.dropout_masks(torch.Generator(), x) is None
