"""Tensor parallelism in the port against the JAX package, on the CPU: two
gloo ranks on a model = 2 mesh and four on data = 2 x model = 2
(`torch_ranks.run_ranks`, the cases in `torch_tp_cases.py`), against the
reference's unsharded results and against the port on one rank.

- The rules: `TP_RULES` and `FSDP_TP_RULES` give every leaf of ViT-Tiny's
  stacked tree, LeNet-5 and the MLP the reference's spec on its
  data = 4 x model = 2 mesh.
- Decode (`causal_tiny` at the reference's test geometry, dense and
  paged-int8 caches): the full forward and an incremental decode bitwise
  the port's one-rank results and within 1e-5 of the JAX model's; a
  seeded loadgen gives the one-rank engine's streams; each rank holds
  half the KV bytes.
- The ViT step (dim 32, depth 2, 4 heads, 8x8 patches, f32, the
  reference's dropout masks passed): three TP and three FSDP x TP steps
  within the stated tolerances of the reference's unsharded step;
  replicated leaves' gradients bit-equal across ranks; per-rank bytes as
  the reference's rules predict; a TP checkpoint restored under DP and
  back bit for bit.
- The sharded flash entries bitwise the unsharded plain versions,
  forward and backward; a heads-indivisible mesh raises the reference's
  ValueError.

Each group of ranks runs its cases once (module fixtures), with a time
limit of its own.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cli.train import build_optimizer as jbuild_optimizer
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.models.causal_lm import CausalLMTiny as JaxLM
from dist_mnist_tpu.parallel import sharding as jsharding
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu_torch import configs as tconfigs
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.cli import launch as tlaunch
from dist_mnist_tpu_torch.cluster.mesh import AXES, Mesh
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.parallel import sharding as tsharding
from dist_mnist_tpu_torch.parallel.flash import (
    flash_attention_sharded,
    masked_flash_attention_sharded,
)
from dist_mnist_tpu_torch.serve.decode import DecodeEngine
from dist_mnist_tpu_torch.train import create_train_state
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

import torch_ranks
import torch_tp_cases as cases

ROOT = Path(__file__).resolve().parents[1]
#: the ViT step's tolerances: the loss relative, each updated leaf
#: relative to its largest reference value
LOSS_TOL, PARAM_TOL = 2e-4, 5e-4
#: the JAX ViT of the step, the cases' `VIT_KW` (dropout 0.1)
J_VIT_KW = dict(dim=32, depth=2, heads=4, patch=8, scan_blocks=True)
BATCH = 8
CFG_KW = dict(warmup_steps=1, train_steps=4)


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


def _nflat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_nflat(tree[k], (*prefix, str(k))))
        return out
    return {"/".join(prefix): np.asarray(tree)}


@pytest.fixture(scope="module")
def reference():
    """The JAX side: the LM's params, the ViT's params, batches and the
    dropout masks the reference's step draws (fold_in(rng, step), one
    split per layer, bernoulli(0.9) of the MLP hidden), and that step's
    three losses and final params on one device."""
    jlm, _ = JaxLM(**cases.LM_KW).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 64, (2, 8), dtype=np.int32)
    flash = {n: rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
             for n in "qkvg"}
    flash["lengths"] = np.array([5, 9], np.int32)

    cfg = jconfigs.get_config("vit_tiny_cifar_tp", **CFG_KW)
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_VIT_KW)
    jopt = jbuild_optimizer(cfg)
    mesh1 = jmake_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    batches = [{"image": rng.integers(0, 256, (BATCH, 32, 32, 3), np.uint8),
                "label": rng.integers(0, 10, (BATCH,), np.int32)}
               for _ in range(3)]
    seq = (32 // 8) ** 2 + 1  # patch tokens and the CLS token
    with mesh1:
        state = jcreate_state(jmodel, jopt, jax.random.PRNGKey(5),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
        params0 = jax.device_get(state.params)
        masks = []
        for i in range(3):
            keys = jax.random.split(jax.random.fold_in(state.rng, i),
                                    J_VIT_KW["depth"])
            masks.append(np.stack([np.asarray(jax.random.bernoulli(
                k, 0.9, (BATCH, seq, 4 * J_VIT_KW["dim"]))) for k in keys]))
        # without remat: the same numbers (remat recomputes, it does not
        # round otherwise), compiled in half the time
        step = jmake_train_step(jmodel, jopt, mesh1, donate=False)
        losses = []
        for b in batches:
            state, out = step(state, shard_batch(b, mesh1))
            losses.append(float(out["loss"]))
    return {
        "lm_params": jax.device_get(jlm), "tokens": tokens, "flash": flash,
        "vit": {"params": params0, "batches": batches, "masks": masks},
        "vit_losses": losses, "vit_params": _jflat(state.params),
        "vit_params0": _jflat(params0)}


def _port_spec(ref):
    return {k: ref[k] for k in ("lm_params", "tokens", "flash", "vit")}


@pytest.fixture(scope="module")
def groups(reference, tmp_path_factory):
    """Every case on two ranks (model = 2) and the FSDP x TP step on four
    (data = 2 x model = 2)."""
    spec = _port_spec(reference)
    two, four = (tmp_path_factory.mktemp(f"tp{n}") for n in (2, 4))
    data_dir = two / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 256, 64, 0))
    out: dict = {}

    def run(n, *args):
        try:
            out[n] = torch_ranks.run_ranks(*args, timeout=240)
        except BaseException as err:  # noqa: BLE001 — raised below
            out[n] = err

    # the two groups start at once: most of a group's time is its ranks'
    # start-up
    threads = [threading.Thread(target=run, name=f"TPGroup-{n}", args=a)
               for n, a in (
                   (2, (2, cases.tp2_cases, 2, two / "store", spec,
                        str(two / "ckpt"), str(data_dir))),
                   (4, (4, cases.tp4_cases, 4, four / "store", spec)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in (2, 4):
        if isinstance(out[n], BaseException):
            raise out[n]
    out["ckpt2"] = two / "ckpt"
    return out


@pytest.fixture(scope="module")
def one_rank(reference):
    """The port's one-rank decode results (no mesh)."""
    spec = _port_spec(reference)
    return {layout: {
        "lm": cases.lm_forward_and_decode(spec["lm_params"], spec["tokens"],
                                          layout),
        "engine": cases.decode_streams(layout)}
        for layout in cases.LM_LAYOUTS}


# -- the rules ----------------------------------------------------------------

def _model_state(name):
    if name == "vit_tiny":
        kw, shape = J_VIT_KW, (1, 32, 32, 3)
    else:
        kw, shape = {}, (1, 28, 28, 1)
    jmodel = jget_model(name, **kw)
    jstate = jax.eval_shape(lambda k: jcreate_state(
        jmodel, jbuild_optimizer(jconfigs.get_config("vit_tiny_cifar_tp")),
        k, jnp.zeros(shape, jnp.uint8)), jax.random.PRNGKey(0))
    tstate = create_train_state(
        tget_model(name, **kw),
        topt.build_optimizer(tconfigs.get_config("vit_tiny_cifar_tp")), 0,
        np.zeros(shape, np.uint8), "cpu")
    return jstate, tstate


@pytest.mark.parametrize("rules", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("model", ["vit_tiny", "lenet5", "mlp"])
def test_tp_rules_equal_the_references_leaf_for_leaf(mesh_tp, model, rules):
    """Every param and AdamW/clip slot of ViT-Tiny's stacked tree, LeNet-5
    and the MLP: the reference's spec on its data = 4 x model = 2 mesh
    (`tests/conftest.py` `mesh_tp`), right-aligned on stacked leaves."""
    jstate, tstate = _model_state(model)
    jspecs = jsharding.derive_state_specs(
        jstate, mesh_tp, jsharding.resolve_rules(rules))
    mesh = Mesh(shape={**{a: 1 for a in AXES}, "data": 4, "model": 2})
    tspecs = tsharding.derive_state_specs(tstate, mesh,
                                          tsharding.resolve_rules(rules))
    placed = 0
    for part in ("params", "opt_state"):
        t_flat = flatten_with_path(getattr(tspecs, part))
        j_flat = jax.tree_util.tree_flatten_with_path(
            getattr(jspecs, part), is_leaf=lambda x: isinstance(x, JP))[0]
        assert len(t_flat) == len(j_flat), part
        for (path, got), (_, want) in zip(t_flat, j_flat):
            assert tuple(got) == tuple(want), (part, path)
            placed += got.dim("model") is not None
    # ViT and LeNet-5 have Megatron leaves; the MLP's names match none
    assert (placed > 0) == (model != "mlp")
    if model == "vit_tiny":
        qkv = tspecs.params["blocks"]["attn"]["qkv"]["w"]
        want = ("data", "model") if rules == "fsdp_tp" else (None, "model")
        assert tuple(qkv) == (None, *want)


def test_resolve_rules_names_every_strategy():
    assert tsharding.resolve_rules("tp") is tsharding.TP_RULES
    assert tsharding.resolve_rules("fsdp_tp") is tsharding.FSDP_TP_RULES
    assert tsharding.TP_RULES.rules == jsharding.TP_RULES.rules
    assert tsharding.rules_name(tsharding.FSDP_TP_RULES) == "fsdp_tp"
    with pytest.raises(ValueError, match="unknown sharding_rules"):
        tsharding.resolve_rules("zero3")


# -- decode -------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(cases.LM_LAYOUTS))
def test_tp_forward_and_decode_bitwise_the_one_rank_results(
        groups, one_rank, reference, layout):
    """Heads split over model = 2: the full forward and an incremental
    decode are the one-rank port's bits on both ranks (every contraction
    is per head), and within 1e-5 of the JAX model's (the port's decode
    tolerance, tests/test_torch_decode.py); each rank's cache holds 2 of
    the 4 heads."""
    want = one_rank[layout]["lm"]
    jfull, _ = JaxLM(**cases.LM_LAYOUTS[layout]).apply(
        reference["lm_params"], {}, jnp.asarray(reference["tokens"]))
    for res in groups[2]:
        got = res["lm"][layout]
        np.testing.assert_array_equal(got["full"], want["full"])
        np.testing.assert_array_equal(got["decode"], want["decode"])
        np.testing.assert_allclose(got["full"], np.asarray(jfull),
                                   atol=1e-5, rtol=0)
        assert got["cache_k_shape"][3] == 2
        assert want["cache_k_shape"][3] == 4
    if layout == "dense":  # decode == forward on the CPU, as on one rank
        np.testing.assert_array_equal(groups[2][0]["lm"][layout]["decode"],
                                      want["full"])


@pytest.mark.parametrize("layout", list(cases.LM_LAYOUTS))
def test_tp_engine_streams_equal_the_one_rank_engines(groups, one_rank,
                                                      layout):
    """The seeded loadgen through the chief's scheduler and a follower:
    the one-rank engine's streams exactly; each rank holds half the KV
    bytes, `kv_stats` reports the whole cache as the reference does, and
    the follower ran every decode step the chief did."""
    want = one_rank[layout]["engine"]
    chief, follower = (r["engine"][layout] for r in groups[2])
    assert chief["ok"] == 6 and chief["streams"] == want["streams"]
    assert chief["rank_kv_bytes"] * 2 == want["rank_kv_bytes"]
    assert follower["rank_kv_bytes"] == chief["rank_kv_bytes"]
    assert chief["kv_stats"]["kv_bytes_pool"] == \
        want["kv_stats"]["kv_bytes_pool"]
    assert follower["decode_steps"] == chief["decode_steps"]
    assert follower["follower_calls"] > chief["decode_steps"]


# -- the ViT step -------------------------------------------------------------

def _key_bias(path: str, arr: np.ndarray) -> np.ndarray | None:
    """The key third of a qkv bias: softmax is invariant to it, so its
    gradient is rounding noise that AdamW scales to whole steps."""
    if path.endswith("attn/qkv/b"):
        d = arr.shape[-1] // 3
        return arr[..., d:2 * d]
    return None


def _check_vit(res, reference):
    losses = res["losses"]
    for got, want in zip(losses, reference["vit_losses"]):
        assert abs(got - want) <= LOSS_TOL * abs(want), (losses,
                                                         reference[
                                                             "vit_losses"])
    got = _nflat(res["params"])
    lr = tconfigs.get_config("vit_tiny_cifar_tp").learning_rate
    for path, want in reference["vit_params"].items():
        g = got[path]
        kb = _key_bias(path, want)
        if kb is not None:
            # the key bias: held to 3 steps of the rate from its start
            start = _key_bias(path, reference["vit_params0"][path])
            assert np.abs(_key_bias(path, g) - start).max() <= 3 * lr
            keep = np.ones(want.shape[-1], bool)
            keep[want.shape[-1] // 3:2 * want.shape[-1] // 3] = False
            g, want = g[..., keep], want[..., keep]
        err = np.abs(g - want).max() / (np.abs(want).max() + 1e-30)
        assert err <= PARAM_TOL, (path, err)
    assert len(set(losses)) == 3  # the params moved


def test_tp_vit_step_matches_the_references_unsharded_step(groups,
                                                          reference):
    """Two ranks, model = 2, three steps of the config's recipe with the
    reference's dropout masks: losses within 2e-4 relative and every
    updated leaf within 5e-4 of its largest reference value; both ranks
    the same losses; the replicated leaves' first-step gradients and
    final values the same bits on both ranks; `qkv/w` local
    ``[L, D, 3D/2]``."""
    a, b = groups[2]
    for res in (a, b):
        _check_vit(res["vit"], reference)
        assert res["vit"]["local_shapes"]["blocks/attn/qkv/w"] == (2, 32, 48)
        assert res["vit"]["local_shapes"]["blocks/attn/out/w"] == (2, 16, 32)
    assert a["vit"]["losses"] == b["vit"]["losses"]
    for key in ("replicated_grads", "replicated_digest"):
        assert set(a["vit"][key]) == set(b["vit"][key])
        for path in a["vit"][key]:
            np.testing.assert_array_equal(a["vit"][key][path],
                                          b["vit"][key][path])


def _predicted_bytes(rules: str, data: int, model: int) -> int:
    """Per-rank params + AdamW slots under the reference's rules on a
    data x model mesh: each leaf's bytes over the sizes of the axes that
    split it."""
    jstate, _ = _model_state("vit_tiny")
    jmesh = jmake_mesh(JMeshSpec(data=data, model=model),
                       devices=jax.devices()[:data * model])
    specs = jsharding.derive_state_specs(jstate, jmesh,
                                         jsharding.resolve_rules(rules))
    total = 0
    for part in ("params", "opt_state"):
        leaves = jax.tree_util.tree_leaves(getattr(jstate, part))
        parts = jax.tree_util.tree_leaves(
            getattr(specs, part), is_leaf=lambda x: isinstance(x, JP))
        for leaf, spec in zip(leaves, parts):
            split = math.prod({"data": data, "model": model}[a]
                              for a in spec if a is not None)
            total += leaf.size * leaf.dtype.itemsize // split
    return total


def test_fsdp_tp_vit_step_matches_the_reference_and_the_rules_bytes(
        groups, reference):
    """Four ranks, data = 2 x model = 2: the same step within the same
    tolerances on every rank, and each rank's params + slots the bytes
    the reference's FSDP x TP rules predict."""
    four = groups[4]
    want = _predicted_bytes("fsdp_tp", 2, 2)
    assert sorted((r["rank"], r["model_index"]) for r in four) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for res in four:
        _check_vit(res["vit"], reference)
        b = res["vit"]["bytes"]
        assert b["param_bytes"] + b["opt_state_bytes"] == want
        assert res["vit"]["local_shapes"]["blocks/attn/qkv/w"] == (2, 16, 48)
        assert res["stats"]["tp_all_reduce_calls"] > 0
        assert res["stats"]["reduce_scatter_calls"] > 0
    assert len({tuple(r["vit"]["losses"]) for r in four}) == 1
    # the leaves no TP rule splits (FSDP slices here): the same bits on
    # the two ranks of each model group
    by_group: dict = {}
    for res in four:
        by_group.setdefault(res["rank"], []).append(
            res["vit"]["model_replicated"])
    for x, y in by_group.values():
        assert x and set(x) == set(y)
        for path in x:
            np.testing.assert_array_equal(x[path], y[path])


def test_tp_checkpoint_restores_under_dp_and_back(groups):
    """The chief writes the gathered tree; both ranks restore it under DP
    (full leaves) and then under TP again (their slices), bit for bit."""
    for res in groups[2]:
        dp, tp = res["ckpt"]["trips"]
        assert dp == {"step": 7, "equal": True, "qkv_local": (2, 32, 96)}
        assert tp == {"step": 7, "equal": True, "qkv_local": (2, 32, 48)}
        assert res["ckpt"]["wrote"] == ["7", "commits"]


def test_training_cli_runs_vit_tp_on_two_ranks(groups):
    """`cli.train.run_config` of `vit_tiny_cifar_tp` (small width) on the
    model = 2 group: both ranks end at the same replicated bits and the
    same gathered params, hold half the Megatron leaves, count the
    model group's collectives apart, and write a checkpoint."""
    a, b = (r["cli"] for r in groups[2])
    assert a["step"] == b["step"] == 4 and np.isfinite(a["loss"])
    assert a["replicated"] == b["replicated"] and a["full"] == b["full"]
    # data = 1: the leaves no TP rule splits are every unsplit leaf
    assert a["model_replicated"] == a["replicated"] == b["model_replicated"]
    assert a["qkv_local"] == (2, 32, 48)
    assert a["mesh"]["model"] == 2 and a["mesh"]["data"] == 1
    assert a["collectives"]["tp_all_gather_calls"] > 0
    assert "all_reduce_calls" not in a["collectives"]
    assert a["bytes"] == b["bytes"]
    assert {"4", "commits"} <= set(os.listdir(groups["ckpt2"] / "cli"))


def test_tp_collectives_are_counted_apart_from_dp(groups):
    """The model group's all-gathers and all-reduces count under ``tp_``
    keys; on data = 1 there is no data-axis collective at all."""
    for res in groups[2]:
        assert res["stats"]["tp_all_gather_calls"] > 0
        assert res["stats"]["tp_all_reduce_calls"] > 0


# -- the flash entry ---------------------------------------------------------

@pytest.mark.parametrize("entry", ["flash", "masked"])
def test_sharded_flash_entries_bitwise_the_unsharded_plain_versions(groups,
                                                                    entry):
    """Heads 4 on model = 2: each rank's output and q/k/v gradients are
    the unsharded plain version's bits (the same math on each head)."""
    for res in groups[2]:
        assert res["flash"][entry]["equal"] == [True] * 4


def _fake_mesh(model: int) -> Mesh:
    """A rank's view of a model axis (no group: nothing may reach a
    collective)."""
    return Mesh(shape={**{a: 1 for a in AXES}, "model": model})


def test_heads_indivisible_mesh_raises_the_references_valueerror():
    q = torch.zeros(2, 5, 3, 8)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    for call in (lambda: flash_attention_sharded(q, q, q,
                                                 mesh=_fake_mesh(2)),
                 lambda: masked_flash_attention_sharded(
                     q, q, q, lengths, mesh=_fake_mesh(2))):
        with pytest.raises(ValueError, match="heads=3 % model=2 != 0"):
            call()
    lm = CausalLMTiny(**cases.LM_KW)
    with pytest.raises(ValueError, match="heads=4 not divisible by model "
                                         "axis 3"):
        lm.init_cache(2, mesh=_fake_mesh(3))
    params, _ = lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="heads=4 not divisible by model "
                                         "axis 3"):
        DecodeEngine(lm, params, "cpu", mesh=_fake_mesh(3))


# -- the launchers -----------------------------------------------------------

@pytest.mark.parametrize("name", ["vit_tiny_cifar_tp",
                                  "vit_tiny_cifar_fsdp_tp"])
def test_bench_runs_a_tp_config_on_one_rank_as_dp(name):
    """One rank cannot hold a model axis: the bench's config mode runs the
    config as DP at the 16-chip ladder's per-chip batch, and its note
    says so (PR 14's rule for `resnet20_cifar_fsdp`)."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.data.datasets import Dataset

    rng = np.random.default_rng(0)
    ds = Dataset(name="cifar10", train_images=rng.integers(
                     0, 256, (64, 32, 32, 3), dtype=np.uint8),
                 train_labels=rng.integers(0, 10, (64,), dtype=np.int32),
                 test_images=np.zeros((1, 32, 32, 3), np.uint8),
                 test_labels=np.zeros((1,), np.int32), num_classes=10,
                 synthetic=True)
    small = {k: v for k, v in cases.VIT_KW.items() if k != "compute_dtype"}
    cfg = dataclasses.replace(tconfigs.get_config(name), model_kwargs=small)
    rec = bench.run_config(cfg, torch.device("cpu"), 2, dataset=ds, chunk=2)
    extra = rec["extra"]
    assert extra["sharding"] == "dp" and extra["chips"] == 1
    assert f"benched as DP, not {cfg.sharding_rules!r}" in extra["mesh_note"]
    assert extra["global_batch"] == 64
    assert np.isfinite(extra["chunk_losses"]).all()

def test_launch_refuses_a_mesh_of_another_rank_count():
    assert tlaunch.mesh_ranks(["--mesh=data=2,model=2"]) == 4
    assert tlaunch.mesh_ranks(["--mesh", "data=1,model=2"]) == 2
    assert tlaunch.mesh_ranks(["--mesh=data=-1,model=2"]) is None
    assert tlaunch.mesh_ranks(["--config=x"]) is None
    with pytest.raises(SystemExit, match="names 4 ranks"):
        tlaunch.main(["--num_processes=2", "--platform=cpu", "--",
                      "--mesh=data=2,model=2"])


def test_serve_decode_over_a_model_mesh_on_cpu_ranks():
    """`cli.serve --decode --mesh=model=2` spawns two ranks: the chief
    prints the summary with every request ok, the follower follows."""
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.serve", "--decode",
         "--device=cpu", "--mesh=model=2", "--requests=8",
         "--concurrency=4"], cwd=ROOT, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    body = "\n".join(line[5:] for line in proc.stdout.splitlines()
                     if line.startswith("[p0] ") and "INFO" not in line
                     and "WARNING" not in line)
    summary = json.loads(body[body.index("{"):])
    assert summary["ok"] == summary["n_requests"] == 8
    assert summary["mesh"] == {"model": 2}
    assert summary["rank_kv_bytes"] * 2 == summary["kv"]["kv_bytes_pool"]
    assert "follower rank 1 ran" in proc.stdout
