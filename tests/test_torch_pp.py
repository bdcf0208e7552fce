"""Pipeline parallelism in the port against the JAX package, on the CPU: a
group of four gloo ranks (`torch_ranks.run_ranks`, the cases in
`torch_mp_cases.py`) against the reference's `pipeline_apply`, its
pipelined ViT and its training step on CPU meshes of the same shapes.

- `pipeline_apply` of a ReLU layer stage (the reference's
  tests/test_pipeline_moe.py stage, 8 microbatches) on data = 1 x pipe =
  4 and data = 2 x pipe = 2, GPipe and circular (2 chunks), with and
  without `skip_bubble`: the output and the gradients of
  ``sum(out**2)/data`` (the step's rule: the loss over the pipe size,
  the sum over the pipe ranks, the mean over the data ranks) within rtol
  1e-5 / atol 1e-5 of the reference's on the same mesh shape, and the
  same bits on every pipe rank.
- The pipelined ViT (the reference's TestPipelineInViT geometry: depth
  4, dim 32, f32), GPipe and circular, on data = 2 x pipe = 2: logits
  within 2e-4 / 2e-5 of the reference's pipelined logits and of the
  port's plain stack; the gradients within 5e-4 / 5e-5 of the
  reference's, every stage's blocks with a gradient.
- With dropout 0.1 under remat the pipelined ViT's gradients equal the
  plain stack's on the same keep-masks (within 1e-5 / 1e-6): the pipe
  ranks of a data shard use the same masks, the data shards different
  ones.
- One remat step of `sgd(1.0)` on data = 2 x pipe = 2 in f32: the loss
  within 2e-4 relative of the reference's, every updated leaf within
  5e-4 of its largest reference value.
- `vit_tiny_cifar_pp` through `run_config` at a small width on pipe = 4:
  the ``pp_`` collectives a step as the shapes predict, and its
  checkpoint restored on one process bit for bit.
- The refusals and the fallback: a mismatched pipe axis runs the plain
  stack with the reference's warning; MoE blocks and a token mask under
  the pipeline raise; bad shapes raise.
"""

from __future__ import annotations

import dataclasses
import logging
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import activate as jactivate
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.ops.losses import softmax_cross_entropy as jce
from dist_mnist_tpu.optim import sgd as jsgd
from dist_mnist_tpu.parallel.pipeline import pipeline_apply as jpipeline
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu_torch.cluster.mesh import AXES, Mesh, activate
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)

import torch_mp_cases as cases
import torch_ranks

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
LOSS_TOL, PARAM_TOL = 2e-4, 5e-4
J_KW = {k: v for k, v in cases.VIT_PP_KW.items() if k != "compute_dtype"}
MESHES = {"d1p4": (1, 4), "d2p2": (2, 2)}


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


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jmesh(data: int, pipe: int):
    return jmake_mesh(JMeshSpec(data=data, pipe=pipe),
                      devices=jax.devices()[:data * pipe])


def _jvit(**extra):
    return jget_model("vit_tiny", compute_dtype=jnp.float32, **J_KW, **extra)


def _spec() -> dict:
    rng = np.random.default_rng(1)
    stages = {"w": (rng.normal(size=(8, 16, 16)) / 4).astype(np.float32),
              "b": (rng.normal(size=(8, 16)) / 10).astype(np.float32)}
    params, _ = _jvit().init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 32, 32, 3)))
    batch = {"image": rng.integers(0, 256, (4, 32, 32, 3), np.uint8),
             "label": rng.integers(0, 10, (4,), np.int32)}
    with jactivate(_jmesh(2, 2)):
        state = jcreate_state(_jvit(**cases.VIT_PP_VARIANTS["gpipe"]),
                              jsgd(1.0), jax.random.PRNGKey(1),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    step = {"params": _np(state.params),
            "batch": {"image": rng.integers(0, 256, (8, 32, 32, 3),
                                            np.uint8),
                      "label": rng.integers(0, 10, (8,), np.int32)}}
    return {"stages": {"stages": stages,
                       "x": rng.normal(size=(32, 16)).astype(np.float32)},
            "vit": {"params": _np(params), "batch": batch}, "step": step}


def _reference(spec: dict) -> dict:
    """The JAX side: `pipeline_apply` per case on each mesh shape, the
    pipelined ViTs' logits and gradients and one remat step on data = 2
    x pipe = 2."""
    out: dict = {"stages": {}}
    x = jnp.asarray(spec["stages"]["x"])

    def stage(p, a):
        return jax.nn.relu(a @ p["w"] + p["b"])

    for mesh_name, (data, pipe) in MESHES.items():
        jmesh = _jmesh(data, pipe)
        for v, skip in cases.PIPE_CASES:
            stacked = {k: jnp.asarray(a[:pipe * v])
                       for k, a in spec["stages"]["stages"].items()}

            def loss(p, v=v, skip=skip):
                y = jpipeline(stage, p, x, cases.PIPE_MB, jmesh,
                              circular_chunks=v, skip_bubble=skip)
                return jnp.sum(y ** 2) / data, y

            (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                stacked)
            out["stages"][(mesh_name, v, skip)] = {"out": np.asarray(y),
                                                   "grads": _np(g)}
    jmesh = _jmesh(2, 2)
    b = spec["vit"]["batch"]
    xb = jnp.asarray(b["image"], jnp.float32) / 255.0
    out["vit"] = {}
    for name, extra in cases.VIT_PP_VARIANTS.items():
        model = _jvit(**extra)

        def loss_fn(p, model=model):
            logits, _ = model.apply(p, {}, xb, train=False)
            return jce(logits, jnp.asarray(b["label"])), logits

        with jactivate(jmesh):
            (loss, logits), g = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(spec["vit"]["params"])
        out["vit"][name] = {"loss": float(loss),
                            "logits": np.asarray(logits),
                            "grads": _jflat(g)}
    model = _jvit(**cases.VIT_PP_VARIANTS["gpipe"])
    opt = jsgd(1.0)
    with jactivate(jmesh):
        state = jcreate_state(model, opt, jax.random.PRNGKey(1),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
        step = jmake_train_step(model, opt, jmesh, donate=False, remat=True)
        new, metrics = step(state, shard_batch(spec["step"]["batch"], jmesh))
    out["step"] = {"loss": float(metrics["loss"]),
                   "params": _jflat(new.params)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, the group running
    while this process computes the reference's side."""
    spec = _spec()
    tmp = tmp_path_factory.mktemp("pp4")
    data_dir = tmp / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 256, 64, 0))
    out: dict = {"spec": spec, "ckpt": tmp / "ckpt"}

    def run():
        try:
            out["ranks"] = torch_ranks.run_ranks(
                cases.pp4_cases, 4, tmp / "store", spec, str(tmp / "ckpt"),
                str(data_dir), timeout=300)
        except BaseException as err:  # noqa: BLE001 — raised below
            out["ranks"] = err

    thread = threading.Thread(target=run, name="PipeGroup-4")
    thread.start()
    try:
        out["ref"] = _reference(spec)
    finally:
        thread.join()
    if isinstance(out["ranks"], BaseException):
        raise out["ranks"]
    return out


def _data_index(r: dict, mesh_name: str) -> int:
    return r["rank"][0] if mesh_name == "d2p2" else 0


# -- pipeline_apply -----------------------------------------------------------

@pytest.mark.parametrize("v,skip", cases.PIPE_CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pipeline_matches_the_reference(runs, mesh_name, v, skip):
    data, _ = MESHES[mesh_name]
    want = runs["ref"]["stages"][(mesh_name, v, skip)]
    per = want["out"].shape[0] // data
    rows = runs["ranks"]
    for r in rows:
        d = _data_index(r, mesh_name)
        got = r["stages"][mesh_name][(v, skip)]
        np.testing.assert_allclose(got["out"],
                                   want["out"][d * per:(d + 1) * per], **TOL)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, **TOL,
                                       err_msg=name)
    base = rows[0]["stages"][mesh_name][(v, skip)]["grads"]
    for r in rows[1:]:
        for name in base:
            np.testing.assert_array_equal(
                r["stages"][mesh_name][(v, skip)]["grads"][name], base[name])


def _one_rank_mesh(pipe: int) -> Mesh:
    return Mesh(shape={**{a: 1 for a in AXES}, "pipe": pipe})


def test_pipeline_refuses_bad_shapes():
    """The reference's guards, raised before any collective: a stage stack
    that is not the pipe axis (times the chunks), a batch the microbatches
    do not divide, and a circular microbatch count the axis does not."""
    mesh = _one_rank_mesh(4)
    stages = stack_stage_params([{"w": torch.eye(8), "b": torch.zeros(8)}
                                 for _ in range(3)])
    with pytest.raises(ValueError, match="pipe axis size 4"):
        pipeline_apply(cases._stage_fn, stages, torch.ones(8, 8), 4, mesh)
    stages = stack_stage_params([{"w": torch.eye(8), "b": torch.zeros(8)}
                                 for _ in range(4)])
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(cases._stage_fn, stages, torch.ones(9, 8), 4, mesh)
    stages8 = stack_stage_params([{"w": torch.eye(8), "b": torch.zeros(8)}
                                  for _ in range(8)])
    with pytest.raises(ValueError, match="circular"):
        pipeline_apply(cases._stage_fn, stages8, torch.ones(6, 8), 6, mesh,
                       circular_chunks=2)


# -- the pipelined ViT --------------------------------------------------------

def _plain_logits(spec: dict, rows: slice) -> np.ndarray:
    b = spec["vit"]["batch"]
    x = torch.from_numpy(b["image"][rows].astype(np.float32) / 255.0)
    with torch.no_grad():
        logits, _ = ViTTiny(**cases.VIT_PP_KW).apply(
            params_from_jax(spec["vit"]["params"]), {}, x)
    return logits.numpy()


@pytest.mark.parametrize("name", list(cases.VIT_PP_VARIANTS))
def test_pipelined_vit_matches_the_reference_and_the_plain_stack(runs, name):
    """Data = 2 x pipe = 2: each rank's logits within 2e-4 / 2e-5 of the
    reference's pipelined logits and of the port's plain stack on the
    same rows; the gradients reduced by the step's rule within 5e-4 /
    5e-5 of the reference's, the same bits on every rank, and every
    stage's blocks with a gradient (both pipe ranks learn)."""
    want = runs["ref"]["vit"][name]
    for r in runs["ranks"]:
        d = r["rank"][0]
        rows = slice(2 * d, 2 * d + 2)
        got = r["vit"][name]
        np.testing.assert_allclose(got["logits"], want["logits"][rows],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got["logits"],
                                   _plain_logits(runs["spec"], rows),
                                   **LOGIT_TOL)
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * want["loss"]
        for path, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][path], g, **GRAD_TOL,
                                       err_msg=path)
    base = runs["ranks"][0]["vit"][name]["grads"]
    for r in runs["ranks"][1:]:
        for path in base:
            np.testing.assert_array_equal(r["vit"][name]["grads"][path],
                                          base[path])
    per_block = np.abs(base["blocks/attn/qkv/w"]).sum(axis=(1, 2))
    assert (per_block > 0).all(), per_block


def test_pipeline_dropout_equals_the_plain_stack(runs):
    """Dropout 0.1 under remat, keep-masks drawn for the whole batch from
    one seed: the pipelined ViT's reduced gradients equal the plain
    stack's on the same rows and masks (within 1e-5 / 1e-6); the pipe
    ranks of a data shard draw the same masks, the two data shards
    different ones."""
    by_data: dict = {}
    for r in runs["ranks"]:
        got = r["dropout"]
        for path, g in got["plain_grads"].items():
            np.testing.assert_allclose(got["grads"][path], g, rtol=1e-5,
                                       atol=1e-6, err_msg=path)
        by_data.setdefault(r["rank"][0], set()).add(got["mask_sum"])
    assert all(len(s) == 1 for s in by_data.values())
    assert by_data[0] != by_data[1]


def test_pp_step_matches_the_reference(runs):
    """One remat step of `sgd(1.0)` on data = 2 x pipe = 2, f32: the loss
    within 2e-4 relative of the reference's, every leaf within 5e-4 of
    its largest reference value, the same bits on every rank; the step
    moved the stage activations over pipe."""
    want = runs["ref"]["step"]
    base = runs["ranks"][0]["step"]
    for r in runs["ranks"]:
        got = r["step"]
        assert abs(float(got["metrics"]["loss"]) - want["loss"]) \
            <= LOSS_TOL * abs(want["loss"])
        for path, w in want["params"].items():
            err = np.abs(got["params"][path] - w).max() / (
                np.abs(w).max() + 1e-30)
            assert err <= PARAM_TOL, (path, err)
        for path in base["params"]:
            np.testing.assert_array_equal(got["params"][path],
                                          base["params"][path])
    assert base["stats"]["pp_ring_shift_calls"] > 0


def test_mismatched_pipe_axis_runs_the_plain_stack(caplog):
    """block_pipeline=4 under a pipe axis of 2: the plain stack (no
    collective), with the reference's warning; a pipeline with MoE blocks
    and a token mask under the pipeline raise."""
    x = torch.rand(4, 32, 32, 3)
    model = ViTTiny(**cases.VIT_PP_KW, block_pipeline=4)
    params, state = model.init(torch.Generator().manual_seed(0), x)
    ref, _ = model.apply(params, state, x)
    with caplog.at_level(logging.WARNING, logger="dist_mnist_tpu_torch"):
        with activate(_one_rank_mesh(2)):
            out, _ = model.apply(params, state, x)
    assert torch.equal(out, ref)
    assert any("pipe axis 2" in r.getMessage() for r in caplog.records)
    moe = ViTTiny(**{**cases.VIT_PP_KW, "mlp_impl": "moe"}, block_pipeline=2)
    mp, ms = moe.init(torch.Generator().manual_seed(0), x)
    with activate(_one_rank_mesh(2)), \
            pytest.raises(ValueError, match="dense MLP blocks only"):
        moe.apply(mp, ms, x)
    piped = ViTTiny(**cases.VIT_PP_KW, block_pipeline=2)
    with pytest.raises(ValueError, match="not supported with block_pipeline"):
        piped.apply(params, state, x, mask=torch.ones(4, 16, dtype=bool))


# -- the CLI ------------------------------------------------------------------

def test_cli_pp_run_collectives_and_checkpoint(runs):
    """`vit_tiny_cifar_pp` through `run_config` on pipe = 4 (batch 8, dim
    32, depth 4, 17 tokens with CLS, M = 8 microbatches of 1): the same
    final params on every rank, and a step's ``pp_`` traffic the shapes'
    prediction: a bf16 [1, 17, 32] activation shifted every tick but the
    last (M + S - 2 = 10), in the forward, the remat recompute and the
    backward; the [8, 1, 17, 32] output broadcast in the forward and the
    recompute, its cotangent all-reduced once; the f32 gradients summed
    over pipe once. The chief's step-4 checkpoint restores on one process
    bit for bit."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.state import params_digest

    rows = [r["cli"] for r in runs["ranks"]]
    assert len({r["digest"] for r in rows}) == 1
    a = rows[0]
    assert a["step"] == 4 and a["mesh"]["pipe"] == 4
    assert np.isfinite(a["loss"]) and not any(a["launches"].values())
    act = 1 * 17 * 32 * 2
    shifts = 8 + 4 - 2
    want = {"pp_ring_shift_bytes": 3 * shifts * act,
            "pp_ring_shift_calls": 3 * shifts,
            "pp_broadcast_bytes": 2 * 8 * act,
            "pp_broadcast_calls": 2,
            "pp_all_reduce_bytes": 8 * act + 4 * a["param_elements"],
            "pp_all_reduce_calls": 2}
    assert {k: v for k, v in a["collectives"].items() if v} == want
    cfg = get_config("vit_tiny_cifar_pp")
    model = get_model(cfg.model, **{**cfg.model_kwargs, **cases.SMALL})
    target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                np.zeros((1, 32, 32, 3), np.uint8), "cpu")
    mgr = CheckpointManager(runs["ckpt"] / "vit_tiny_cifar_pp",
                            async_save=False)
    try:
        restored = mgr.restore(target)
    finally:
        mgr.close()
    assert restored.step_int == 4
    assert params_digest(restored.params) == a["digest"]


def test_cli_launch_pp_on_four_cpu_ranks(tmp_path, runs):
    """The acceptance's command on the CPU: `cli.launch --num_processes=4
    --platform=cpu -- --config=vit_tiny_cifar_pp --mesh=pipe=4` (full
    width, batch 8, 2 steps) exits 0 with the same final digest on every
    rank."""
    data_dir = tmp_path / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 64, 16, 0))
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.launch",
         "--num_processes=4", "--platform=cpu", "--",
         "--config=vit_tiny_cifar_pp", "--mesh=pipe=4", "--batch_size=8",
         "--train_steps=2", "--eval_every=0", "--log_every=1",
         f"--data_dir={data_dir}"],
        cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    digests = {line.split("final params digest: ")[1]
               for line in proc.stdout.splitlines()
               if "final params digest: " in line}
    assert len(digests) == 1
    assert "'pipe': 4" in proc.stdout and "pp_ring_shift_calls" in proc.stdout


def test_dataclass_fields_match_the_reference():
    """`ViTTiny` carries the reference's MoE and pipeline fields with the
    reference's defaults."""
    from dist_mnist_tpu.models.vit import ViTTiny as JViTTiny

    names = ("mlp_impl", "n_experts", "moe_capacity_factor", "moe_top_k",
             "moe_aux_weight", "scan_blocks", "block_pipeline",
             "pipeline_microbatches", "pipeline_skip_bubble",
             "pipeline_circular")
    got = {f.name: f.default for f in dataclasses.fields(ViTTiny)}
    want = {f.name: f.default for f in dataclasses.fields(JViTTiny)}
    assert {n: got[n] for n in names} == {n: want[n] for n in names}
