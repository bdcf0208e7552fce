"""The FSDP overlap schedule (`parallel/overlap.py`) on the CPU: gloo
ranks (`torch_ranks.run_ranks`, the cases in `torch_overlap_cases.py`:
one group of 2 and one of 2 x 2) against each other and against the
reference's `make_train_step(..., overlap=OverlapConfig(...))` on a
2-device CPU mesh.

- The MLP's plain, serial, overlapped and ring trajectories bit for bit
  (8 steps), ResNet-20's (synchronized batch norm) plain, overlapped and
  ring ones; under FSDP x TP on 2 x 2 the narrow ViT (remat) and the MLP
  overlapped bit for bit the plain step, the TP collectives untouched.
- The collectives a step: one gather and one reduce-scatter a bucket,
  ring hops n - 1 a leaf.
- The gather is an identity with the gathered layout; the layer prefetch
  equals the serial loop bit for bit.
- The overlapped step within 2e-4 (loss) / 5e-4 (params) of the
  reference's; `plan_stats` equal to the reference's.
- `OverlapConfig` validation, the refusal without FSDP.
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
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.parallel.overlap import OverlapConfig as JOverlapConfig
from dist_mnist_tpu.parallel.overlap import plan_stats as jplan_stats
from dist_mnist_tpu.parallel.sharding import FSDP_RULES as JFSDP_RULES
from dist_mnist_tpu.parallel.sharding import shard_train_state as jshard
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu.train.state import TrainState as JTrainState
from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cluster.mesh import Mesh
from dist_mnist_tpu_torch.compilecache import store as store_mod
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.parallel.overlap import (
    OverlapConfig,
    build_param_gather,
    plan_stats,
)
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    FSDP_RULES,
    TP_RULES,
)
from dist_mnist_tpu_torch.train import make_train_step
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

import torch_overlap_cases as cases
import torch_ranks

#: the bucket size of the MLP and ResNet-20 cases: the MLP splits into 2
#: buckets, ResNet-20 into 4 (the card's `--overlap_bucket_mb=0.25`)
BUCKET_MB = 0.25
#: the narrow ViT's (its 130,216 B split into 5 buckets)
VIT_BUCKET_MB = 0.01
MLP_HIDDEN = 128  # the bench's width on two ranks: max(64, 64 n)
MLP_STEPS = 8


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


@pytest.fixture(autouse=True)
def _no_port_leaks():
    """The port's own state after each test: no store temp file pending,
    no launched child alive."""
    yield
    assert not store_mod._PENDING_TMP, store_mod._PENDING_TMP
    assert not [p for p in launch_mod._LIVE_CHILDREN if p.poll() is None]


def _batches(n, shape, k, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (n, *shape), np.uint8),
             "label": rng.integers(0, 10, (n,), np.int32)}
            for _ in range(k)]


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)) / (
        float(np.max(np.abs(want), initial=0.0)) + 1e-30)


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in flatten_with_path(tree)}


def _same(a: dict, b: dict) -> bool:
    """Bit-equal losses and final params of two schedule runs."""
    fa, fb = _flat(a["params"]), _flat(b["params"])
    return (a["losses"].tobytes() == b["losses"].tobytes()
            and fa.keys() == fb.keys()
            and all(fa[k].tobytes() == fb[k].tobytes() for k in fa))


@pytest.fixture(scope="module")
def spec():
    """The inputs every group and the reference share: the reference's
    MLP (hidden 128) and f32 ResNet-20 inits, the port's narrow ViT init
    and its dropout masks, their batches, and the prefetch operands."""
    mlp = jget_model("mlp", hidden_units=MLP_HIDDEN)
    mparams = jax.device_get(jax.jit(lambda k: mlp.init(
        k, jnp.zeros((1, 28, 28, 1), jnp.float32)))(jax.random.PRNGKey(0))
        [0])
    resnet = jget_model("resnet20", compute_dtype=jnp.float32)
    rparams, rstate = jax.device_get(jax.jit(lambda k: resnet.init(
        k, jnp.zeros((1, 32, 32, 3), jnp.float32)))(jax.random.PRNGKey(1)))
    vit = ViTTiny(**cases.VIT_KW)
    vparams, _ = vit.init(torch.Generator().manual_seed(2),
                          torch.zeros((1, 32, 32, 3)))
    vbatches = _batches(8, (32, 32, 3), 3, 5)
    masks = [vit.dropout_masks(torch.Generator().manual_seed(10 + i),
                               torch.zeros((8, 32, 32, 3))).numpy()
             for i in range(3)]
    rng = np.random.default_rng(6)
    return {
        "bucket_mb": BUCKET_MB,
        "mlp": {"hidden": MLP_HIDDEN, "params": mparams,
                "batches": _batches(16, (28, 28, 1), MLP_STEPS, 1)},
        "resnet": {"params": rparams, "model_state": rstate,
                   "batches": _batches(8, (32, 32, 3), 2, 3)},
        "vit": {"params": _tree_numpy(vparams), "batches": vbatches,
                "masks": masks, "bucket_mb": VIT_BUCKET_MB},
        "prefetch": {"ws": rng.standard_normal((3, 16, 16), np.float32),
                     "x": rng.standard_normal((8, 16), np.float32)},
    }


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.fixture(scope="module")
def groups(spec, tmp_path_factory):
    """The two groups, started at once, each running every one of its
    cases once."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("groups")
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(torch_ranks.run_ranks, cases.two_rank_cases, 2,
                          root / "two", spec, timeout=300)
        four = pool.submit(torch_ranks.run_ranks, cases.four_rank_cases, 4,
                           root / "four", spec, timeout=300)
        return {2: two.result(), 4: four.result()}


@pytest.fixture(scope="module")
def reference(spec):
    """The reference's overlapped FSDP step on a 2-device CPU mesh over
    the MLP's batches: each step's loss and the final params."""
    mesh = jmake_mesh(JMeshSpec(data=2), devices=jax.devices()[:2])
    model = jget_model("mlp", hidden_units=MLP_HIDDEN)
    opt = jopt.adam(1e-3)
    params = jax.tree.map(jnp.asarray, spec["mlp"]["params"])
    with mesh:
        state = jshard(JTrainState(
            step=jnp.zeros((), jnp.int32), params=params, model_state={},
            opt_state=opt.init(params), rng=jax.random.PRNGKey(0)), mesh,
            JFSDP_RULES)
        step = jmake_train_step(model, opt, mesh, rules=JFSDP_RULES,
                                donate=False,
                                overlap=JOverlapConfig(bucket_mb=BUCKET_MB))
        losses = []
        for b in spec["mlp"]["batches"]:
            state, m = step(state, shard_batch(b, mesh))
            losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.device_get(state.params)}


# -- the schedules against each other ---------------------------------------

def test_mlp_schedules_are_bit_for_bit_equal(groups):
    """Plain, serial, overlapped and ring: the same losses at each of 8
    steps and the same final params, bit for bit, on both ranks (two data
    ranks: each reduce-scatter element is one addition)."""
    for rank in groups[2]:
        runs = rank["mlp"]
        assert len(runs["plain"]["losses"]) == MLP_STEPS
        for name in cases.SCHEDULES[1:]:
            assert _same(runs[name], runs["plain"]), name
    assert _same(groups[2][0]["mlp"]["overlapped"],
                 groups[2][1]["mlp"]["overlapped"])


def test_resnet_schedules_are_bit_for_bit_equal(groups):
    """ResNet-20 (the card's path): its synchronized batch norms issue
    all-reduces over the data group while the buckets' gathers are in
    flight, and the trajectories still match bit for bit."""
    for rank in groups[2]:
        runs = rank["resnet"]
        for name in ("overlapped", "ring"):
            assert _same(runs[name], runs["plain"]), name


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_collective_calls_follow_the_buckets(groups, model):
    """A step of the overlapped schedule: one all-gather and one
    reduce-scatter a bucket (the plain step: one each), the other leaves'
    all-reduce unchanged; the ring: n - 1 = 1 `ring_shift` a sharded leaf
    and no all-gather."""
    for rank in groups[2]:
        runs = rank[model]
        plan = runs["overlapped"]["plan"]
        plain, over, ring = (runs[k]["collectives"]
                             for k in ("plain", "overlapped", "ring"))
        assert plain["all_gather_calls"] == plain["reduce_scatter_calls"] == 1
        assert over["all_gather_calls"] >= plan["buckets"] > 1
        assert over["reduce_scatter_calls"] == plan["buckets"]
        assert over["all_reduce_calls"] == plain["all_reduce_calls"]
        for key in ("all_gather_bytes", "reduce_scatter_bytes"):
            assert over[key] == plain[key]
        assert "all_gather_calls" not in ring
        assert ring["ring_shift_calls"] == plan["sharded_leaves"]
        assert ring["reduce_scatter_calls"] == plan["buckets"]


def test_gather_is_an_identity_with_the_gathered_layout(groups):
    for rank in groups[2]:
        assert rank["identity"] and all(rank["identity"].values())


def test_prefetched_layer_matmul_equals_the_serial_loop(groups):
    for rank in groups[2]:
        got, want = rank["prefetch"]["got"], rank["prefetch"]["serial"]
        assert got.shape == (4, 16) and got.tobytes() == want.tobytes()


def test_fsdp_tp_overlapped_equals_plain_and_leaves_tp_alone(groups):
    """2 x 2: the narrow ViT (remat, dropout masks given) and the MLP
    (no TP rule matches its leaves) overlapped, bit for bit the plain
    step on every rank; the tensor-parallel collectives are the plain
    step's, call for call and byte for byte."""
    for rank in groups[4]:
        for model in ("vit", "mlp"):
            runs = rank[model]
            assert _same(runs["overlapped"], runs["plain"]), model
            tp = {k: v for k, v in runs["plain"]["collectives"].items()
                  if k.startswith("tp_")}
            assert {k: v for k, v in runs["overlapped"]["collectives"].items()
                    if k.startswith("tp_")} == tp
        assert rank["vit"]["plain"]["collectives"]["tp_all_gather_calls"]
        assert rank["vit"]["overlapped"]["plan"]["buckets"] > 1


# -- against the reference ---------------------------------------------------

def test_overlapped_step_matches_the_reference(groups, reference, spec):
    """The port's overlapped MLP step on 2 ranks against the reference's
    overlapped step on a 2-device mesh from the same init: every loss
    within 2e-4 relative, every final leaf within 5e-4 of its largest
    reference value."""
    want = _flat(reference["params"])
    for rank in groups[2]:
        got = rank["mlp"]["overlapped"]
        for g, w in zip(got["losses"], reference["losses"]):
            assert abs(float(g) - w) <= 2e-4 * abs(w)
        flat = _flat(got["params"])
        for path, w in want.items():
            assert _rel_err(flat[path], w) <= 5e-4, path


def _port_mesh(data: int) -> Mesh:
    return Mesh(shape={"data": data, "model": 1, "seq": 1, "pipe": 1})


#: (sharded leaves, gathered bytes, buckets) the plans must have:
#: ResNet-20's at 0.25 MB (the card's run) and at the default 4 MB, and
#: the stacked ViT-Tiny's at 4 MB, whose first block needs every bucket
PLANS = {("resnet", BUCKET_MB): (82, 1_092_264, 4),
         ("resnet", 4.0): (82, 1_092_264, 1),
         ("vit_tiny_cifar", 4.0): (20, 21_451_048, 4)}


@pytest.mark.parametrize("model,bucket_mb", [
    ("mlp", BUCKET_MB), ("resnet", BUCKET_MB), ("resnet", 4.0),
    ("vit_tiny_cifar", 4.0)])
def test_plan_stats_equal_the_reference(groups, spec, model, bucket_mb):
    """`plan_stats` of the same full params on a data = 2 mesh equals the
    reference's (ViT-Tiny: the reference's init at full width, the
    stacked layout); at 0.25 MB the ranks' plan over their placed slices
    is the same too."""
    jmesh = jmake_mesh(JMeshSpec(data=2), devices=jax.devices()[:2])
    if model in spec:
        params = spec[model]["params"]
        port_params = params_from_jax(params)
    else:  # the plan reads shapes alone: the reference's abstract init
        cfg = jconfigs.get_config(model)
        vit = jget_model(cfg.model, **cfg.model_kwargs)
        params = jax.eval_shape(lambda k: vit.init(
            k, jnp.zeros((1, 32, 32, 3), jnp.float32)),
            jax.random.PRNGKey(0))[0]
        port_params, _ = get_model(cfg.model, **cfg.model_kwargs).init(
            torch.Generator().manual_seed(0), torch.zeros((1, 32, 32, 3)))
    want = jplan_stats(params, jmesh, JFSDP_RULES,
                       JOverlapConfig(bucket_mb=bucket_mb))
    got = plan_stats(port_params, _port_mesh(2), FSDP_RULES,
                     OverlapConfig(bucket_mb=bucket_mb))
    assert got == want
    if bucket_mb == BUCKET_MB:
        for rank in groups[2]:
            assert rank[model]["overlapped"]["plan"] == want
    if (model, bucket_mb) in PLANS:
        assert (want["sharded_leaves"], want["gathered_bytes"],
                want["buckets"]) == PLANS[model, bucket_mb]


# -- validation --------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"chunk": "tree"}, "unknown overlap chunk mode"),
    ({"bucket_mb": 0.0}, "bucket_mb must be > 0"),
    ({"bucket_mb": -1.0}, "bucket_mb must be > 0"),
])
def test_overlap_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        OverlapConfig(**kw)


@pytest.mark.parametrize("rules", [DP_RULES, TP_RULES], ids=["dp", "tp"])
def test_overlap_refuses_rules_without_fsdp(rules):
    """At step-build time, with the reference's message."""
    with pytest.raises(ValueError, match="needs an fsdp strategy"):
        build_param_gather(None, rules, OverlapConfig())
    with pytest.raises(ValueError, match="needs an fsdp strategy"):
        make_train_step(MLP(), optim.adam(1e-3), rules=rules,
                        overlap=OverlapConfig())
