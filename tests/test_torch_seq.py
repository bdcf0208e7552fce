"""Sequence parallelism in the port against the JAX package, on the CPU:
two gloo ranks on a seq = 2 mesh and four on seq = 4 and on data = 2 x
seq = 2 (`torch_ranks.run_ranks`, the cases in `torch_seq_cases.py`),
against the reference's ring and Ulysses attention on a CPU seq mesh and
its ViT and training step.

- Attention: `ring_self_attention` and `ulysses_self_attention`, both
  engines (the flash engine through its plain version here), on 2 and 4
  ranks at the reference's shapes (tests/test_parallel_attention.py:
  B = 2, S = 32, 4 heads of 16, f32): the output and the q, k, v
  gradients within the reference's rtol 2e-4, atol 2e-5 of its own ring
  and Ulysses on a seq mesh; a head count the seq axis does not divide
  raises the reference's ValueError.
- The ViT's forward and backward with each of ring, ring_flash, ulysses
  and ulysses_flash on data = 2 x seq = 2 (depth 2, dim 64, 4 heads,
  8x8 patches, mean pool, f32, the stacked layout): the logits within
  2e-4 / 2e-5 and the gradients, reduced by the step's rule, within
  5e-4 / 5e-5 of the reference's on its data = 2 x seq = 2 mesh.
- Three training steps on data = 2 x seq = 2 with the reference's dropout
  masks (the same ViT): within 2e-4 (loss) and 5e-4 (params) of the reference's
  unsharded step; the first step's reduced gradients the same bits on
  every rank.
- Every remat policy gives the gradients of no remat, bit for bit, on
  the ring and on Ulysses, and reruns the forward's collectives.
- `cli.train.run_config` of `vit_tiny_cifar_ring_flash` at a small width
  on seq = 2: the collectives a step as the shapes predict, and its
  checkpoint restored on one process bit for bit.
- F1: the sharded flash entry logs no warning at per-rank batches 1, 2
  and 3 on four ranks.

Each group of ranks runs its cases once (a module fixture, the two
groups at once, while this process computes the reference's side), with
a time limit of its own.
"""

from __future__ import annotations

import dataclasses
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cli.train import build_optimizer as jbuild_optimizer
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import activate as jactivate
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.ops.losses import softmax_cross_entropy as jce
from dist_mnist_tpu.parallel.ring_attention import (
    ring_self_attention as jring,
)
from dist_mnist_tpu.parallel.ulysses import (
    ulysses_self_attention as julysses,
)
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu_torch import configs as tconfigs
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, check_axes
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.models.vit import SEQ_IMPLS, ViTTiny
from dist_mnist_tpu_torch.train import create_train_state

import torch_ranks
import torch_seq_cases as cases

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
#: the steps' tolerances: the loss relative, each updated leaf relative
#: to its largest reference value
LOSS_TOL, PARAM_TOL = 2e-4, 5e-4
J_VIT_KW = {k: v for k, v in cases.VIT_KW.items() if k != "compute_dtype"}
BATCH = 8
ENGINES = {"ring": jring, "ulysses": julysses}


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


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec() -> tuple[dict, dict]:
    """(the ranks' numpy inputs, what the reference's side needs)."""
    rng = np.random.default_rng(0)
    attn = {n: rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
            for n in "qkvg"}
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_VIT_KW)
    cfg = jconfigs.get_config("vit_tiny_cifar_ring_flash", warmup_steps=1,
                              train_steps=4)
    jopt = jbuild_optimizer(cfg)
    mesh1 = jmake_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    with mesh1:
        state = jcreate_state(jmodel, jopt, jax.random.PRNGKey(5),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    tokens = (32 // J_VIT_KW["patch"]) ** 2  # mean pool: no CLS token
    masks = []
    for i in range(3):
        keys = jax.random.split(jax.random.fold_in(state.rng, i),
                                J_VIT_KW["depth"])
        masks.append(np.stack([np.asarray(jax.random.bernoulli(
            k, 0.9, (BATCH, tokens, 4 * J_VIT_KW["dim"]))) for k in keys]))
    params = jax.device_get(state.params)
    fwd = {"params": params,
           "batch": {"image": rng.integers(0, 256, (4, 32, 32, 3), np.uint8),
                     "label": rng.integers(0, 10, (4,), np.int32)}}
    steps = {"params": params,
             "batches": [{"image": rng.integers(0, 256, (BATCH, 32, 32, 3),
                                                np.uint8),
                          "label": rng.integers(0, 10, (BATCH,), np.int32)}
                         for _ in range(3)],
             "masks": masks}
    return ({"attn": attn, "fwd": fwd, "steps": steps},
            {"jmodel": jmodel, "jopt": jopt, "mesh1": mesh1, "state": state})


def _reference(spec: dict, side: dict) -> dict:
    """The JAX side: ring and Ulysses on a seq mesh of 2 and of 4 (output
    and the vjp of ``g``), the ViT's logits and gradients with each impl
    on data = 2 x seq = 2, and three unsharded steps."""
    out: dict = {"attn": {}, "heads_error": {}, "fwd": {}}
    q, k, v, g = (jnp.asarray(spec["attn"][n]) for n in "qkvg")
    for n in (2, 4):
        jmesh = jmake_mesh(JMeshSpec(data=1, seq=n),
                           devices=jax.devices()[:n])
        with jmesh:
            for name, fn in ENGINES.items():
                for impl in ("xla", "flash"):
                    def run(a, b, c, cot, fn=fn, impl=impl):
                        o, vjp = jax.vjp(lambda x, y, z: fn(
                            x, y, z, jmesh, impl=impl), a, b, c)
                        return o, vjp(cot)

                    o, grads = jax.jit(run)(q, k, v, g)
                    out["attn"][(n, name, impl)] = (
                        np.asarray(o), [np.asarray(x) for x in grads])
            bad = jnp.zeros((1, 4, n + 1, 8))
            try:
                julysses(bad, bad, bad, jmesh)
            except ValueError as err:
                out["heads_error"][n] = str(err)
    batch = spec["fwd"]["batch"]
    x = jnp.asarray(batch["image"], jnp.float32) / 255.0
    y = jnp.asarray(batch["label"])
    jmesh = jmake_mesh(JMeshSpec(data=2, seq=2), devices=jax.devices()[:4])
    for impl in SEQ_IMPLS:
        model = dataclasses.replace(side["jmodel"], attention_impl=impl)

        def loss_fn(p, model=model):
            logits, _ = model.apply(p, {}, x, train=False)
            return jce(logits, y), logits

        with jactivate(jmesh):
            (_, logits), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(spec["fwd"]["params"])
        out["fwd"][impl] = (np.asarray(logits), _jflat(grads))
    mesh1, state = side["mesh1"], side["state"]
    # without remat: the same numbers (remat recomputes, it does not round
    # otherwise), compiled in half the time
    step = jmake_train_step(side["jmodel"], side["jopt"], mesh1,
                            donate=False)
    losses = []
    with mesh1:
        for b in spec["steps"]["batches"]:
            state, m = step(state, shard_batch(b, mesh1))
            losses.append(float(m["loss"]))
    out["losses"], out["params"] = losses, _jflat(state.params)
    out["params0"] = _jflat(spec["steps"]["params"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (2: seq = 2; 4: seq = 4 and data = 2 x seq = 2)
    and the reference's, the two groups running while this process
    computes the reference's side."""
    spec, side = _spec()
    two, four = (tmp_path_factory.mktemp(f"seq{n}") for n in (2, 4))
    data_dir = two / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 256, 64, 0))
    out: dict = {"ckpt": two / "ckpt", "spec": spec}

    def run(n, *args):
        try:
            out[n] = torch_ranks.run_ranks(*args, timeout=240)
        except BaseException as err:  # noqa: BLE001 — raised below
            out[n] = err

    threads = [threading.Thread(target=run, name=f"SeqGroup-{n}", args=a)
               for n, a in (
                   (2, (2, cases.seq2_cases, 2, two / "store", spec,
                        str(two / "ckpt"), str(data_dir))),
                   (4, (4, cases.seq4_cases, 4, four / "store", spec)))]
    for t in threads:
        t.start()
    try:
        out["ref"] = _reference(spec, side)
    finally:
        for t in threads:
            t.join()
    for n in (2, 4):
        if isinstance(out[n], BaseException):
            raise out[n]
    return out


# -- attention ----------------------------------------------------------------

def _gathered(ranks: list, key: str):
    """Out and the q, k, v grads of every seq rank, concatenated along the
    tokens in seq order."""
    by_seq = sorted(ranks, key=lambda r: r["attention"]["seq_index"])
    parts = [r["attention"][key] for r in by_seq]
    out = np.concatenate([p["out"] for p in parts], axis=1)
    grads = [np.concatenate([p["grads"][i] for p in parts], axis=1)
             for i in range(3)]
    return out, grads, [p["adaptive_equal"] for p in parts]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_seq_attention_matches_the_reference(runs, n, name, impl):
    """The port's ring or Ulysses attention over n gloo ranks against the
    reference's on an n-way CPU seq mesh: output and q, k, v gradients
    within its rtol 2e-4, atol 2e-5; the mesh-adaptive entry the same
    bits as the explicit one."""
    out, grads, adaptive = _gathered(runs[n], f"{name}/{impl}")
    want_out, want_grads = runs["ref"]["attn"][(n, name, impl)]
    np.testing.assert_allclose(out, want_out, **ATTN_TOL)
    for got, want, what in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(got, want, **ATTN_TOL, err_msg=what)
    assert all(adaptive)


@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_refuses_an_indivisible_head_count(runs, n):
    """n + 1 heads over an n-way seq axis: the reference's ValueError."""
    want = runs["ref"]["heads_error"][n]
    assert "divisible" in want
    for res in runs[n]:
        assert res["refusals"]["ulysses_heads"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_cls_pool_refuses_on_a_seq_mesh(runs, n):
    for res in runs[n]:
        assert "S % seq = 1" in res["refusals"]["cls_pool"]


def test_seq_beside_model_and_pipe_still_refuse():
    """Seq beside model, and pipe beside seq, still refuse (no reference
    config combines them); a pipe axis beside data alone is the pipeline
    slice's (tests/test_torch_pp.py)."""
    with pytest.raises(NotImplementedError, match="item 11"):
        check_axes(MeshSpec(data=1, model=2, seq=2))
    with pytest.raises(NotImplementedError, match="item 11"):
        check_axes(MeshSpec(data=1, seq=2, pipe=2))
    check_axes(MeshSpec(data=2, seq=4))
    check_axes(MeshSpec(data=2, pipe=4))


# -- the ViT ------------------------------------------------------------------

@pytest.mark.parametrize("impl", SEQ_IMPLS)
def test_vit_forward_backward_matches_the_reference(runs, impl):
    """Data = 2 x seq = 2: each data rank's logits (the same bits on both
    its seq ranks) within 2e-4 / 2e-5 of the reference's on its own
    data = 2 x seq = 2 mesh, and the gradients reduced by the step's rule
    (the same bits on every rank) within 5e-4 / 5e-5 of its whole-batch
    gradients."""
    want_logits, want_grads = runs["ref"]["fwd"][impl]
    four = runs[4]
    for res in four:
        rows = slice(2 * res["rank"], 2 * res["rank"] + 2)
        got = res["fwd_bwd"][impl]
        np.testing.assert_allclose(got["logits"], want_logits[rows],
                                   **LOGIT_TOL)
    base = four[0]["fwd_bwd"][impl]["grads"]
    assert set(base) == set(want_grads)
    for path, want in want_grads.items():
        np.testing.assert_allclose(base[path], want, **GRAD_TOL,
                                   err_msg=path)
    for res in four[1:]:
        got = res["fwd_bwd"][impl]
        for path in base:
            np.testing.assert_array_equal(got["grads"][path], base[path])
    by_data: dict = {}
    for res in four:
        by_data.setdefault(res["rank"], []).append(
            res["fwd_bwd"][impl]["logits"])
    for a, b in by_data.values():
        np.testing.assert_array_equal(a, b)


def _key_bias(path: str, arr: np.ndarray) -> np.ndarray | None:
    """The key third of a qkv bias: softmax is invariant to it, so its
    gradient is rounding noise that AdamW scales to whole steps."""
    if path.endswith("attn/qkv/b"):
        d = arr.shape[-1] // 3
        return arr[..., d:2 * d]
    return None


@pytest.mark.parametrize("impl", SEQ_IMPLS)
def test_three_seq_steps_match_the_references_unsharded_step(runs, impl):
    """Four ranks, data = 2 x seq = 2, three steps of the config's recipe
    with the reference's dropout masks: losses within 2e-4 relative of
    the reference's unsharded step, every updated leaf within 5e-4 of its
    largest reference value (the key bias held to 3 steps of the rate,
    as in the TP step's test); every rank the same losses and final
    params, and the first step's reduced gradients the same bits on
    every rank."""
    ref = runs["ref"]
    four = runs[4]
    lr = tconfigs.get_config("vit_tiny_cifar_ring_flash").learning_rate
    for res in four:
        got = res["steps"][impl]
        for a, b in zip(got["losses"], ref["losses"]):
            assert abs(a - b) <= LOSS_TOL * abs(b), (got["losses"],
                                                     ref["losses"])
        for path, want in ref["params"].items():
            g = got["params"][path]
            kb = _key_bias(path, want)
            if kb is not None:
                start = _key_bias(path, ref["params0"][path])
                assert np.abs(_key_bias(path, g) - start).max() <= 3 * lr
                keep = np.ones(want.shape[-1], bool)
                keep[want.shape[-1] // 3:2 * want.shape[-1] // 3] = False
                g, want = g[..., keep], want[..., keep]
            err = np.abs(g - want).max() / (np.abs(want).max() + 1e-30)
            assert err <= PARAM_TOL, (path, err)
        assert len(set(got["losses"])) == 3  # the params moved
    base = four[0]["steps"][impl]
    for res in four[1:]:
        got = res["steps"][impl]
        assert got["losses"] == base["losses"]
        for key in ("grads", "params"):
            for path in base[key]:
                np.testing.assert_array_equal(got[key][path],
                                              base[key][path])


@pytest.mark.parametrize("policy", ["dots_no_batch", "save_attn", "dots",
                                    "nothing"])
@pytest.mark.parametrize("impl", ["ring_flash", "ulysses_flash"])
def test_remat_policies_keep_the_seq_gradients_bitwise(runs, impl, policy):
    """On seq = 2, one backward under each remat policy: the gradients of
    no remat, bit for bit; the recompute runs the forward's collectives
    again (the ring's shift of K and V, or Ulysses' all-to-alls of q, k,
    v and the output, in every layer, and the pool's all-reduce), under
    every policy (train/step.py REMAT_POLICIES)."""
    for res in runs[2]:
        runs_ = res["remat"][impl]
        assert runs_[policy]["equal"]
        off, on = runs_["off"]["sp"], runs_[policy]["sp"]
        depth = cases.VIT_KW["depth"]
        key = "sp_ring_shift" if impl.startswith("ring") else "sp_all_to_all"
        # forward: K and V shifted once a layer (seq = 2, no last shift),
        # or q, k, v in and the output out; the backward the same again
        per_layer = 2 if impl.startswith("ring") else 4
        assert off[f"{key}_calls"] == 2 * per_layer * depth
        assert on[f"{key}_calls"] == 3 * per_layer * depth
        assert on[f"{key}_bytes"] * 2 == off[f"{key}_bytes"] * 3
        assert (off["sp_all_reduce_calls"], on["sp_all_reduce_calls"]) == \
            (2, 3)


def test_cli_seq_run_collectives_and_checkpoint(runs):
    """`vit_tiny_cifar_ring_flash` through `run_config` on seq = 2 (batch
    8, bf16, S = 16 tokens, 8 a rank, 4 heads of 16): the same final params
    on both ranks; a step's `sp_` traffic is the shapes' prediction: 12
    shifts of a bf16 K or V block (4 forward, 4 in the remat recompute, 4
    backward) and 4 all-reduces (the pool's [8, 64] f32 sum forward,
    recompute and backward, and the gradients' flat f32 buffer); the
    chief's step-4 checkpoint restores on one process bit for bit."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.train.state import params_digest

    a, b = (r["cli"] for r in runs[2])
    assert a["digest"] == b["digest"] and a["step"] == b["step"] == 4
    assert a["mesh"]["seq"] == 2 and np.isfinite(a["loss"])
    block = 8 * 8 * 4 * 16 * 2
    pool = 8 * 64 * 4
    assert a["collectives"] == {
        "sp_ring_shift_bytes": 12 * block, "sp_ring_shift_calls": 12,
        "sp_all_reduce_bytes": 3 * pool + 4 * a["param_elements"],
        "sp_all_reduce_calls": 4}
    cfg = tconfigs.get_config("vit_tiny_cifar_ring_flash")
    model = ViTTiny(**{**cfg.model_kwargs, **J_VIT_KW})
    target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                np.zeros((1, 32, 32, 3), np.uint8), "cpu")
    mgr = CheckpointManager(runs["ckpt"] / "cli", async_save=False)
    try:
        restored = mgr.restore(target)
    finally:
        mgr.close()
    assert restored.step_int == 4
    assert params_digest(restored.params) == a["digest"]


def test_f1_no_flash_warning_on_four_ranks(runs):
    """F1: four ranks (data = 2 x model = 2) at per-rank batches 1, 2 and
    3 through the sharded flash entry log no warning: each rank's batch
    is its slice of a global batch the data axis divides."""
    for res in runs[4]:
        assert res["f1_warnings"] == []


@pytest.mark.parametrize("impl", SEQ_IMPLS)
def test_seq_impls_without_a_seq_axis_fall_back_to_their_engine(impl):
    """Without a seq axis, ring and Ulysses run their engine's exact
    attention: the logits of the "xla" or "flash" ViT, bit for bit."""
    kw = dict(cases.VIT_KW)
    engine = "flash" if impl.endswith("_flash") else "xla"
    params, _ = ViTTiny(**kw).init(torch.Generator().manual_seed(3),
                                   torch.zeros(1, 32, 32, 3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    got, _ = ViTTiny(attention_impl=impl, **kw).apply(params, {}, x)
    want, _ = ViTTiny(attention_impl=engine, **kw).apply(params, {}, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
