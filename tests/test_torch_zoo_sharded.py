"""The zoo's sharded placement in the port against the JAX package, on the
CPU: a narrow ViT (dim 32, depth 2, 4 heads, 8x8 patches, f32) served
resident-sharded over gloo ranks (`torch_zoo_cases.py` through
`torch_ranks.run_ranks`; one group of two ranks and one of four, started
at once), the chief predicting while the others follow.

- ``tp`` over model = 2, at the native height and a sub-native bucket:
  within 2e-4 of the reference's `InferenceEngine` on a 2-device CPU mesh
  with the same converted weights, and of the port's one-rank engine.
- ``fsdp`` over data = 2 and data = 4 and ``fsdp_tp`` over 2 x 2: the
  one-rank logits, each rank's resident bytes the reference engine's per
  device on the same mesh shape, and the smallest bucket the least power
  of two at or above the data axis.
- A checkpoint trained by `cli.train` under ``dp`` and served under
  ``tp``: the one-rank engine's logits of the same checkpoint.
- A narrow MoE ViT over model = 2 (experts split over the ranks) within
  1e-2 of the one-rank engine (all experts local, the dense oracle).
- `cli.serve --mesh=model=2 --serve_rules=tp --device=cpu` answers every
  request.
"""

from __future__ import annotations

import dataclasses
import json
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

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.serve import build_zoo_engine as jbuild_zoo_engine
from dist_mnist_tpu.serve import load_for_serving as jload_for_serving
from dist_mnist_tpu_torch.cli import train as train_cli
from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.serve import build_zoo_engine, load_for_serving

import torch_ranks
import torch_zoo_cases as cases

ROOT = Path(__file__).resolve().parents[1]
#: logits of a sharded engine against the reference and the one-rank port
LOGIT_TOL = 2e-4
#: the MoE ViT over model = 2 against the one-rank (dense) engine
MOE_TOL = 1e-2
VIT_KW = dict(dim=32, depth=2, heads=4, patch=8, scan_blocks=True)
MOE_KW = dict(VIT_KW, mlp_impl="moe", n_experts=4, pool="mean")
#: the flash ViT's shape under TP: 3 heads that 2 model ranks cannot split
FLASH3_KW = dict(VIT_KW, dim=48, heads=3, attention_impl="flash")


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


def _cfg(name="vit_tiny_cifar", **kw):
    return get_config(name,
                      model_kwargs={**kw, "compute_dtype": torch.float32})


def _jcfg(name="vit_tiny_cifar", **kw):
    return jconfigs.get_config(
        name, model_kwargs={**kw, "compute_dtype": jnp.float32})


def _batches():
    """A native-height batch and one in the height-16 bucket (real heights
    16, 13, 9, 16; the rows past each zeroed)."""
    rng = np.random.default_rng(4)
    native = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    short = rng.integers(0, 256, (4, 16, 32, 3), dtype=np.uint8)
    heights = np.array([16, 13, 9, 16])
    for row, h in enumerate(heights):
        short[row, h:] = 0
    return [(native, None), (short, heights)]


def _jmesh(data: int, model: int):
    return jmake_mesh(JMeshSpec(data=data, model=model),
                      devices=jax.devices()[:data * model])


@pytest.fixture(scope="module")
def reference():
    """The JAX side: the ViT's params (a fresh seeded init), the tp
    engine's logits on a model = 2 mesh, and the per-device resident
    bytes of the fsdp and fsdp_tp placements."""
    batches = _batches()
    jcfg = _jcfg(**VIT_KW)
    bundle = jload_for_serving(jcfg, _jmesh(1, 2), sharding_rules="tp")
    eng = jbuild_zoo_engine(bundle, _jmesh(1, 2), model_name="vit_tiny",
                            max_bucket=8, seq_buckets="auto")
    out = {"params": jax.device_get(bundle.params), "batches": batches,
           "tp": [np.asarray(eng.predict(x, heights=h))
                  for x, h in batches], "bytes": {}}
    for rules, (data, model) in (("fsdp", (2, 1)), ("fsdp", (4, 1)),
                                 ("fsdp_tp", (2, 2))):
        mesh = _jmesh(data, model)
        b = jload_for_serving(jcfg, mesh, sharding_rules=rules)
        e = jbuild_zoo_engine(b, mesh, model_name="vit_tiny", max_bucket=8)
        out["bytes"][(rules, data, model)] = e.state_bytes_per_device()
    return out


@pytest.fixture(scope="module")
def moe_params():
    """A narrow MoE ViT's seeded params (from the reference's init)."""
    bundle = jload_for_serving(_jcfg("vit_tiny_cifar_moe", **MOE_KW),
                               _jmesh(1, 1))
    return jax.device_get(bundle.params)


@pytest.fixture(scope="module")
def dp_checkpoint(tmp_path_factory):
    """A checkpoint of the narrow ViT trained two steps by `cli.train`
    under dp on one rank (a small CIFAR-10 twin)."""
    root = tmp_path_factory.mktemp("dp_ckpt")
    tdatasets._write_synth_cache(root / "data", "cifar10",
                                 tdatasets._synth("cifar10", 64, 16, 0))
    cfg = dataclasses.replace(_cfg(**VIT_KW), batch_size=8, train_steps=2,
                              eval_every=0, sharding_rules="dp")
    train_cli.run_config(cfg, device="cpu", data_dir=str(root / "data"),
                         checkpoint_dir=str(root / "ckpt"),
                         checkpoint_every_steps=2)
    return str(root / "ckpt")


@pytest.fixture(scope="module")
def groups(reference, moe_params, dp_checkpoint, tmp_path_factory):
    """Every run on a group of two ranks and one of four, started at
    once."""
    params = reference["params"]
    batches = reference["batches"]
    vit, moe = _cfg(**VIT_KW), _cfg("vit_tiny_cifar_moe", **MOE_KW)
    runs = [
        ((vit, {"model": 2}, "tp", batches), {"params": params}),
        ((vit, {"data": 2}, "fsdp", batches), {"params": params}),
        ((vit, {"model": 2}, "tp", batches),
         {"checkpoint_dir": dp_checkpoint}),
        ((moe, {"model": 2}, "dp", batches), {"params": moe_params}),
        ((_cfg(**FLASH3_KW), {"model": 2}, "tp", batches), {}),
        ((vit, {"data": 2, "model": 2}, "fsdp_tp", batches),
         {"params": params}),
        ((vit, {"data": 4}, "fsdp", batches), {"params": params}),
    ]
    out: dict = {}

    def run(n):
        try:
            out[n] = torch_ranks.run_ranks(
                cases.zoo_cases, n, tmp_path_factory.mktemp(f"zoo{n}"),
                runs, timeout=240)
        except BaseException as err:  # noqa: BLE001 — raised below
            out[n] = err

    threads = [threading.Thread(target=run, name=f"ZooGroup-{n}", args=(n,))
               for n in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in (2, 4):
        if isinstance(out[n], BaseException):
            raise out[n]
    two, four = out[2], out[4]
    return {"tp": [r[0] for r in two], "fsdp2": [r[1] for r in two],
            "tp_from_dp": [r[2] for r in two], "moe": [r[3] for r in two],
            "flash3": [r[4] for r in two],
            "fsdp_tp": [r[0] for r in four], "fsdp4": [r[1] for r in four]}


def _one_rank(cfg, batches, **kw) -> list:
    bundle = load_for_serving(cfg, "cpu", **kw)
    eng = build_zoo_engine(bundle, "cpu", model_name=cfg.model,
                           max_bucket=8, seq_buckets="auto")
    return [eng.predict(x, heights=h) for x, h in batches]


def _max_rel(got, want) -> float:
    return max(float(np.max(np.abs(g - w))) / float(np.max(np.abs(w)))
               for g, w in zip(got, want))


def test_tp_serving_matches_the_reference_and_one_rank(reference, groups):
    chief, follower = groups["tp"]
    one = _one_rank(_cfg(**VIT_KW), reference["batches"],
                    params=params_from_jax(reference["params"]))
    assert _max_rel(chief["logits"], reference["tp"]) < LOGIT_TOL
    assert _max_rel(chief["logits"], one) < LOGIT_TOL
    # the follower ran each cell the chief ran (no prewarm here)
    assert follower["cells"] == chief["cells"] == {"4x16/masked": 1,
                                                   "4x32/dense": 1}
    assert follower["calls"] == 2
    # each rank holds half the TP-split leaves
    assert chief["bytes"] == follower["bytes"]


@pytest.mark.parametrize("run,rules,data,model", [
    ("fsdp2", "fsdp", 2, 1), ("fsdp4", "fsdp", 4, 1),
    ("fsdp_tp", "fsdp_tp", 2, 2)])
def test_fsdp_placements_hold_the_rules_share(reference, groups, run, rules,
                                              data, model):
    ranks = groups[run]
    one = _one_rank(_cfg(**VIT_KW), reference["batches"],
                    params=params_from_jax(reference["params"]))
    assert _max_rel(ranks[0]["logits"], one) < LOGIT_TOL
    want = reference["bytes"][(rules, data, model)]
    assert all(r["bytes"] == want for r in ranks)
    assert all(r["buckets"] == [b for b in (1, 2, 4, 8) if b >= data]
               for r in ranks)
    assert all(r["cells"] == ranks[0]["cells"] for r in ranks)


def test_dp_checkpoint_serves_under_tp(groups, dp_checkpoint, reference):
    chief, follower = groups["tp_from_dp"]
    assert chief["restored"] and follower["restored"]
    one = _one_rank(_cfg(**VIT_KW), reference["batches"],
                    checkpoint_dir=dp_checkpoint)
    assert _max_rel(chief["logits"], one) < LOGIT_TOL


def test_moe_vit_over_a_model_axis_matches_the_dense_oracle(groups,
                                                             moe_params,
                                                             reference):
    chief, follower = groups["moe"]
    one = _one_rank(_cfg("vit_tiny_cifar_moe", **MOE_KW),
                    reference["batches"], params=params_from_jax(moe_params))
    assert _max_rel(chief["logits"], one) < MOE_TOL
    # expert parallelism keeps the whole tree on each rank (dp rules)
    assert chief["bytes"] == follower["bytes"]


def test_flash_tp_with_indivisible_heads_runs_attention_replicated(
        groups, reference):
    """The TP block replicates attention: with 3 heads over model = 2 the
    flash entries run all heads on every rank (the plain versions here,
    on the CPU) and give the one-rank engine's logits."""
    chief, follower = groups["flash3"]
    one = _one_rank(_cfg(**FLASH3_KW), reference["batches"])
    assert _max_rel(chief["logits"], one) < LOGIT_TOL
    assert follower["cells"] == chief["cells"]


def test_quant_over_ranks_refuses():
    from dist_mnist_tpu_torch.cli import serve as serve_cli

    with pytest.raises(SystemExit, match="item 12"):
        serve_cli.main(["--device=cpu", "--config=vit_tiny_cifar",
                        "--mesh=model=2", "--quant=int8"])


def test_serve_cli_over_a_model_mesh_on_cpu_ranks():
    """`cli.serve --mesh=model=2 --serve_rules=tp` spawns two ranks: the
    chief prints the summary with every request ok and the follower runs
    its cells."""
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.serve",
         "--config=vit_tiny_cifar", "--device=cpu", "--mesh=model=2",
         "--serve_rules=tp", "--requests=8", "--concurrency=4",
         "--max_batch=4"], cwd=ROOT, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    body = "\n".join(line[5:] for line in proc.stdout.splitlines()
                     if line.startswith("[p0] ") and "INFO" not in line
                     and "WARNING" not in line)
    summary = json.loads(body[body.index("{"):])
    assert summary["ok"] == summary["n_requests"] == 8
    assert summary["mesh"] == {"model": 2}
    assert summary["serve_rules"] == "tp"
    assert "[p1]" in proc.stdout and "follower ran" in proc.stdout
