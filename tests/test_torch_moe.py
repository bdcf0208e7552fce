"""Expert parallelism in the port against the JAX package, on the CPU: the
dense MoE oracle on one process, then a group of four gloo ranks
(`torch_ranks.run_ranks`, the cases in `torch_mp_cases.py`) against the
reference's `moe_ffn` on CPU meshes of the same shapes, its ViT and its
training step.

- `moe_ffn_dense`: the output, aux and stats of the reference's
  `moe_ffn_dense` (k = 1 and 2, generous and tight capacity, tied
  scores) within rtol 1e-5, atol 1e-6; the capacity's drops exactly the
  reference's.
- `moe_ffn` on data = 1 x model = 4 and data = 2 x model = 2 (each
  rank's token shard routed with its own capacity, as the reference's
  `moe_ffn_inner`): the output, aux and stats within rtol 1e-5 / atol
  1e-6 of the reference's `moe_ffn` on the same mesh shape, drops
  included, the gradients of ``sum(out**2)/data + 0.01 aux`` (reduced by
  the step's rule) within rtol 1e-4 / atol 1e-6; every model rank the
  same bits; and each rank's output the port's dense oracle on its shard
  bit for bit.
- The MoE ViT (the reference's TestMoEInViT geometry) on data = 2 x
  model = 2: logits within 2e-4 / 2e-5, aux within 2e-4, ep_engaged 1.
- One remat step of `sgd(1.0)` of a stacked two-block MoE ViT on data = 2
  x model = 2 in f32: the loss (with aux) within 2e-4 relative, the
  `_metric` outputs within 1e-5, every updated leaf within 5e-4 of its
  largest reference value.
- The collective matmul (the reference's tests/test_collective_matmul.py
  shapes) over model = 4: each rank's block within 1e-5 of the dense
  product and of the reference's on a model = 4 mesh, and its gradient.
- `vit_tiny_cifar_moe` through `run_config` at a small width on model =
  4: the ``ep_`` collectives a step as the shapes predict, and its
  checkpoint restored on one process bit for bit.
- The aux and metric contracts, zoo serving at an inference-time
  capacity, and the CLI commands the acceptance names.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import tempfile
import threading
import types
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
from dist_mnist_tpu.optim import sgd as jsgd
from dist_mnist_tpu.parallel import moe as jmoe
from dist_mnist_tpu.parallel.collective_matmul import (
    allgather_matmul as jallgather_matmul,
)
from dist_mnist_tpu.parallel.collective_matmul import (
    matmul_reducescatter as jmatmul_reducescatter,
)
from dist_mnist_tpu.serve.engine import InferenceEngine as JEngine
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data import datasets as tdatasets
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.ops import losses
from dist_mnist_tpu_torch.parallel import moe
from dist_mnist_tpu_torch.serve.zoo import build_zoo_engine
from dist_mnist_tpu_torch.train.step import (
    loss_and_grads,
    model_aux_loss,
    model_metrics,
)

import torch_mp_cases as cases
import torch_ranks

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL, PARAM_TOL = 2e-4, 5e-4
J_KW = {k: v for k, v in cases.VIT_MOE_KW.items() if k != "compute_dtype"}
J_STEP_KW = {k: v for k, v in cases.VIT_MOE_STEP_KW.items()
             if k != "compute_dtype"}
MESHES = {"d1m4": (1, 4), "d2m2": (2, 2)}


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


def _jmesh(data: int, model: int):
    return jmake_mesh(JMeshSpec(data=data, model=model),
                      devices=jax.devices()[:data * model])


def _spec() -> dict:
    rng = np.random.default_rng(0)
    layer = {}
    for name, e in (("e4", 4), ("e2", 2)):
        layer[name] = {
            "params": _np(jmoe.init_moe(jax.random.PRNGKey(2 + e), dim=16,
                                        hidden=32, n_experts=e)),
            "x": rng.normal(size=(64, 16)).astype(np.float32)}
    jvit = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_KW)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    params, state = jvit.init(jax.random.PRNGKey(0), jnp.asarray(x))
    vit = {"params": _np(params), "state": _np(state), "x": x}
    step = {"batch": {"image": rng.integers(0, 256, (8, 32, 32, 3), np.uint8),
                      "label": rng.integers(0, 10, (8,), np.int32)}}
    cmm = {"ag": {"x": rng.normal(size=(16, 12)).astype(np.float32),
                  "w": rng.normal(size=(12, 24)).astype(np.float32)},
           "rs": {"x": rng.normal(size=(16, 32)).astype(np.float32),
                  "w": rng.normal(size=(32, 8)).astype(np.float32)},
           "grad": {"x": rng.normal(size=(8, 12)).astype(np.float32),
                    "w": rng.normal(size=(12, 16)).astype(np.float32)}}
    return {"layer": layer, "vit": vit, "step": step, "cmm": cmm}


def _reference(spec: dict) -> dict:
    """The JAX side: `moe_ffn` per case on each mesh shape (output, aux,
    stats and the gradients of the cases' loss), the MoE ViT's forward
    and one remat step on data = 2 x model = 2, the collective matmul on
    model = 4."""
    out: dict = {"layer": {}}
    for mesh_name, (data, model) in MESHES.items():
        jmesh = _jmesh(data, model)
        sub = spec["layer"]["e4" if model == 4 else "e2"]
        x = jnp.asarray(sub["x"])
        for cf, k in cases.MOE_CASES:
            def loss(p, xx, cf=cf, k=k):
                o, aux, stats = jmoe.moe_ffn(p, xx, jmesh,
                                             capacity_factor=cf, top_k=k)
                return (jnp.sum(o ** 2) / data + cases.AUX_W * aux,
                        (o, aux, stats))

            (_, (o, aux, stats)), (g, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(sub["params"], x)
            out["layer"][(mesh_name, cf, k)] = {
                "out": np.asarray(o), "aux": float(aux),
                "stats": _np(stats), "grads": _np(g),
                "x_grad": np.asarray(gx)}
    jmesh = _jmesh(2, 2)
    jvit = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_KW)
    with jactivate(jmesh):
        logits, state = jax.jit(lambda p, s, xx: jvit.apply(
            p, s, xx, train=False))(spec["vit"]["params"],
                                    spec["vit"]["state"],
                                    jnp.asarray(spec["vit"]["x"]))
    out["vit"] = {"logits": np.asarray(logits), "state": _np(state)}
    jstep_model = jget_model("vit_tiny", compute_dtype=jnp.float32,
                             **J_STEP_KW)
    opt = jsgd(1.0)
    with jactivate(jmesh):
        state = jcreate_state(jstep_model, opt, jax.random.PRNGKey(1),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
        step = jmake_train_step(jstep_model, opt, jmesh, donate=False,
                                remat=True)
        new, metrics = step(state, shard_batch(spec["step"]["batch"], jmesh))
    out["step"] = {"metrics": _np(metrics), "params": _jflat(new.params),
                   "params0": _jflat(state.params)}
    m4 = _jmesh(1, 4)
    c = spec["cmm"]
    out["cmm"] = {
        "ag": np.asarray(jallgather_matmul(jnp.asarray(c["ag"]["x"]),
                                           jnp.asarray(c["ag"]["w"]), m4)),
        "rs": np.asarray(jmatmul_reducescatter(
            jnp.asarray(c["rs"]["x"]), jnp.asarray(c["rs"]["w"]), m4)),
        "w_grad": np.asarray(jax.grad(lambda w: jnp.sum(jallgather_matmul(
            jnp.asarray(c["grad"]["x"]), w, m4) ** 2))(
                jnp.asarray(c["grad"]["w"])))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's: the step's params are
    the reference's fresh init, so the reference's init runs first; the
    group then runs while this process computes the rest."""
    spec = _spec()
    tmp = tmp_path_factory.mktemp("moe4")
    data_dir = tmp / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 256, 64, 0))
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_STEP_KW)
    with jactivate(_jmesh(2, 2)):
        st = jcreate_state(jmodel, jsgd(1.0), jax.random.PRNGKey(1),
                           jnp.zeros((1, 32, 32, 3), jnp.uint8))
    spec["step"]["params"] = _np(st.params)
    spec["step"]["state"] = _np(st.model_state)
    out: dict = {"spec": spec, "ckpt": tmp / "ckpt"}

    def run():
        try:
            out["ranks"] = torch_ranks.run_ranks(
                cases.moe4_cases, 4, tmp / "store", spec, str(tmp / "ckpt"),
                str(data_dir), timeout=300)
        except BaseException as err:  # noqa: BLE001 — raised below
            out["ranks"] = err

    thread = threading.Thread(target=run, name="MoEGroup-4")
    thread.start()
    try:
        out["ref"] = _reference(spec)
    finally:
        thread.join()
    if isinstance(out["ranks"], BaseException):
        raise out["ranks"]
    return out


# -- the dense oracle, one process --------------------------------------------

def _gate(kind: str, e: int, rng) -> np.ndarray:
    """A router: random; all zero (every score tied); or experts 0 and 1
    the same column (a tie between two of them on every token)."""
    g = rng.normal(size=(16, e)).astype(np.float32) / 4
    if kind == "tied":
        return np.zeros_like(g)
    if kind == "pair":
        g[:, 1] = g[:, 0]
    return g


@pytest.mark.parametrize("kind", ["random", "tied", "pair"])
@pytest.mark.parametrize("cf,k", cases.MOE_CASES)
def test_dense_matches_reference(kind, cf, k):
    """`moe_ffn_dense` against the reference's on the same params and
    tokens: output, aux and stats within rtol 1e-5 / atol 1e-6; with
    tied scores the lower expert index wins, as in `jax.lax.top_k`."""
    rng = np.random.default_rng(5)
    params = _np(jmoe.init_moe(jax.random.PRNGKey(9), dim=16, hidden=32,
                               n_experts=4))
    params["gate"] = _gate(kind, 4, rng)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    want = jmoe.moe_ffn_dense(params, jnp.asarray(x), capacity_factor=cf,
                              top_k=k)
    got = moe.moe_ffn_dense(params_from_jax(params), torch.from_numpy(x),
                            cf, k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), **TOL)
    for key in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(got[2][key].numpy(),
                                   np.asarray(want[2][key]), **TOL,
                                   err_msg=key)


def test_top_k_keeps_the_lower_index_on_a_tie():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                          [0.3, 0.2, 0.3, 0.2]])
    assert moe.top_k_lower_index(probs, 1).tolist() == [[0], [1], [0]]
    assert moe.top_k_lower_index(probs, 2).tolist() == [[0, 1], [1, 2],
                                                        [0, 2]]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert np.asarray(want).tolist() == [[0, 1], [1, 2], [0, 2]]


def test_capacity_drops_tokens():
    """The reference's test: every token forced to expert 0 at capacity 4
    of 16 tokens; tokens 4.. contribute exactly zero, and the stats say
    12 of 16 assignments were dropped, expert 0 full, expert 1 idle."""
    params = moe.init_moe(torch.Generator().manual_seed(6), 8, 16, 2)
    params["gate"] = torch.from_numpy(np.stack(
        [np.full((8,), 10.0), np.full((8,), -10.0)], axis=1).astype(
            np.float32))
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(7)).abs() \
        + 0.1
    out, _, stats = moe.moe_ffn_dense(params, x, capacity_factor=0.5)
    assert torch.equal(out[4:], torch.zeros_like(out[4:]))
    assert float(stats["drop_fraction"]) == 12 / 16
    assert stats["expert_load"].tolist() == [1.0, 0.0]


# -- expert parallelism over four ranks ---------------------------------------

def _gather_rows(ranks: list, mesh_name: str, case,
                 key: str = "out") -> np.ndarray:
    """The data ranks' `key` rows in data order (each model rank of a data
    rank holds the same rows)."""
    data, model = MESHES[mesh_name]
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["rank"][0] if mesh_name == "d2m2" else 0,
                           r["layer"][mesh_name][case][key])
    return np.concatenate([by_data[d] for d in range(data)])


@pytest.mark.parametrize("cf,k", cases.MOE_CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ep_matches_the_reference_moe_ffn(runs, mesh_name, cf, k):
    ranks = runs["ranks"]
    want = runs["ref"]["layer"][(mesh_name, cf, k)]
    got = _gather_rows(ranks, mesh_name, (cf, k))
    np.testing.assert_allclose(got, want["out"], **TOL)
    first = ranks[0]["layer"][mesh_name][(cf, k)]
    np.testing.assert_allclose(first["aux"], want["aux"], **TOL)
    np.testing.assert_allclose(first["drop_fraction"],
                               want["stats"]["drop_fraction"], **TOL)
    np.testing.assert_allclose(first["expert_load"],
                               want["stats"]["expert_load"], **TOL)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(first["grads"][name], g, **GRAD_TOL,
                                   err_msg=name)
    # each data rank's objective is data x its share of the mean: its
    # tokens' gradient is data x the reference's
    data = MESHES[mesh_name][0]
    np.testing.assert_allclose(
        _gather_rows(ranks, mesh_name, (cf, k), "x_grad") / data,
        want["x_grad"], **GRAD_TOL)
    for r in ranks[1:]:
        row = r["layer"][mesh_name][(cf, k)]
        for name in first["grads"]:
            np.testing.assert_array_equal(row["grads"][name],
                                          first["grads"][name])
        assert row["aux"] == first["aux"]
    if cf == 0.5:
        assert first["drop_fraction"] > 0  # the tight capacity drops


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ep_equals_the_dense_oracle_on_each_shard(runs, mesh_name):
    """Each (data, model) shard's output through EP is the port's dense
    oracle on that shard's tokens, bit for bit, drops included."""
    data, model = MESHES[mesh_name]
    sub = runs["spec"]["layer"]["e4" if model == 4 else "e2"]
    params = params_from_jax(sub["params"])
    x = torch.from_numpy(sub["x"])
    per = x.shape[0] // (data * model)
    for cf, k in cases.MOE_CASES:
        got = _gather_rows(runs["ranks"], mesh_name, (cf, k))
        for s in range(data * model):
            rows = slice(s * per, (s + 1) * per)
            want, _, _ = moe.moe_ffn_dense(params, x[rows], cf, k)
            np.testing.assert_array_equal(got[rows], want.numpy())


def test_ep_collectives_per_call(runs):
    """One forward and backward of `moe_ffn` on data = 1 x model = 4 moves
    what the shapes say: two all-to-alls of the [E, C, D] f32 buffer each
    way; the tokens' and the expert stacks' cotangents all-gathered and
    the outputs gathered (this rank's share each); the packed routing
    statistics (3E + 1 f32) and the gate's cotangent all-reduced."""
    e, t, d, h = 4, 64 // 4, 16, 32
    for cf, k in cases.MOE_CASES:
        c = moe.capacity_of(t, e, k, cf)
        got = runs["ranks"][0]["layer"]["d1m4"][(cf, k)]["stats"]
        assert got == {
            "ep_all_to_all_bytes": 4 * e * c * d * 4,
            "ep_all_to_all_calls": 4,
            "ep_all_gather_bytes": t * d * 4 * 2
            + (d * h + h + h * d + d) * 4,
            "ep_all_gather_calls": 3,
            "ep_all_reduce_bytes": (3 * e + 1) * 4 + d * e * 4,
            "ep_all_reduce_calls": 2}, (cf, k)


def test_ep_refuses_a_mismatched_expert_count():
    mesh = types.SimpleNamespace(model=4)
    params = moe.init_moe(torch.Generator().manual_seed(8), 8, 16, 2)
    with pytest.raises(ValueError, match="n_experts"):
        moe.moe_ffn(params, torch.ones(32, 8), mesh)


# -- the ViT ------------------------------------------------------------------

def test_vit_moe_forward_matches_the_reference(runs):
    """Data = 2 x model = 2: each data rank's logits within 2e-4 / 2e-5 of
    the reference's on its data = 2 x model = 2 mesh, aux within 2e-4,
    and EP engaged (1.0) in both."""
    want = runs["ref"]["vit"]
    for r in runs["ranks"]:
        rows = slice(2 * r["rank"][0], 2 * r["rank"][0] + 2)
        got = r["vit_forward"]
        np.testing.assert_allclose(got["logits"], want["logits"][rows],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got["state"]["moe_aux"],
                                   want["state"]["moe_aux"], rtol=2e-4)
        assert got["state"]["moe_ep_engaged_metric"] == 1.0
    assert float(want["state"]["moe_ep_engaged_metric"]) == 1.0


def test_moe_step_matches_the_reference(runs):
    """One remat step of `sgd(1.0)` on data = 2 x model = 2, f32: the loss
    (aux included) within 2e-4 relative, the `_metric` outputs
    (moe_drop_fraction, moe_expert_load, moe_ep_engaged) within 1e-5, every leaf
    within 5e-4 of its largest reference value, the same on every rank."""
    want = runs["ref"]["step"]
    base = runs["ranks"][0]["step"]
    for r in runs["ranks"]:
        got = r["step"]
        assert abs(float(got["metrics"]["loss"]) - float(
            want["metrics"]["loss"])) <= LOSS_TOL * abs(
            float(want["metrics"]["loss"]))
        for key in ("moe_drop_fraction", "moe_expert_load",
                    "moe_ep_engaged"):
            np.testing.assert_allclose(got["metrics"][key],
                                       want["metrics"][key], atol=1e-5,
                                       err_msg=key)
        for path, w in want["params"].items():
            err = np.abs(got["params"][path] - w).max() / (
                np.abs(w).max() + 1e-30)
            assert err <= PARAM_TOL, (path, err)
        for path in base["params"]:
            np.testing.assert_array_equal(got["params"][path],
                                          base["params"][path])
    # the step moved the gate and the experts
    for leaf in ("moe/gate", "moe/w1"):
        path = f"blocks/{leaf}"
        assert np.abs(want["params"][path] - want["params0"][path]).max() > 0
    assert base["stats"]["ep_all_to_all_calls"] == 2 * 3 * 2


def test_aux_loss_reaches_the_gradients():
    """The `_aux` contract: the step's loss is the cross-entropy plus the
    model's weighted aux, and the gate's gradient moves with the aux
    weight (the balance signal reaches the router)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (4, 32, 32, 3), generator=gen,
                      dtype=torch.uint8)
    batch = {"image": x, "label": torch.tensor([1, 2, 3, 4],
                                               dtype=torch.int32)}
    grads = {}
    for w in (0.0, 1.0):
        model = ViTTiny(**{**cases.VIT_MOE_KW, "moe_aux_weight": w})
        params, state = model.init(torch.Generator().manual_seed(1), x)
        loss, logits, new_state, g = loss_and_grads(
            model, losses.softmax_cross_entropy, params, state, batch)
        ce = losses.softmax_cross_entropy(logits, batch["label"])
        assert torch.allclose(loss, ce + new_state["moe_aux"])
        assert model_aux_loss(new_state) is new_state["moe_aux"]
        grads[w] = g["block0"]["moe"]["gate"]
    assert not torch.equal(grads[0.0], grads[1.0])


def test_model_state_contracts():
    state = {"moe_aux": torch.tensor(0.5), "b_aux": torch.tensor(0.25),
             "vec_aux": torch.ones(2), "moe_drop_fraction_metric":
             torch.tensor(0.1), "moe_expert_load_metric": torch.ones(3),
             "bn": torch.zeros(2)}
    assert float(model_aux_loss(state)) == 0.75
    assert model_aux_loss({"bn": torch.zeros(2)}) is None
    assert set(model_metrics(state)) == {"moe_drop_fraction",
                                         "moe_expert_load"}


# -- the collective matmul ----------------------------------------------------

def test_collective_matmul_matches_the_reference(runs):
    """Over model = 4: `allgather_matmul`'s column block and
    `matmul_reducescatter`'s row block of each rank, and the gradient of
    this rank's columns of w, within 1e-5 of the dense product and of the
    reference's."""
    c, want = runs["spec"]["cmm"], runs["ref"]["cmm"]
    dense_ag = c["ag"]["x"] @ c["ag"]["w"]
    dense_rs = c["rs"]["x"] @ c["rs"]["w"]
    dense_g = 2 * c["grad"]["x"].T @ (c["grad"]["x"] @ c["grad"]["w"])
    for r in runs["ranks"]:
        got, i = r["cmm"], r["cmm"]["index"]
        cols = slice(i * 6, (i + 1) * 6)
        for ref in (dense_ag, want["ag"]):
            np.testing.assert_allclose(got["ag"], ref[:, cols], rtol=1e-5,
                                       atol=1e-5)
        for ref in (dense_rs, want["rs"]):
            np.testing.assert_allclose(got["rs"], ref[i * 4:(i + 1) * 4],
                                       rtol=1e-5, atol=1e-5)
        for ref in (dense_g, want["w_grad"]):
            np.testing.assert_allclose(got["w_grad"],
                                       ref[:, i * 4:(i + 1) * 4], rtol=1e-5,
                                       atol=1e-4)


# -- the CLI ------------------------------------------------------------------

def test_cli_moe_run_collectives_and_checkpoint(runs):
    """`vit_tiny_cifar_moe` through `run_config` on model = 4 (batch 8,
    dim 32, depth 4, 16 tokens, 4 experts): the same final params on every
    rank, EP engaged at every step, and a step's ``ep_`` traffic the
    shapes' prediction (remat: the forward's collectives run again in the
    recompute); the chief's step-4 checkpoint restores on one process bit
    for bit."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.state import params_digest

    rows = [r["cli"] for r in runs["ranks"]]
    assert len({r["digest"] for r in rows}) == 1
    a = rows[0]
    assert a["step"] == 4 and a["mesh"]["model"] == 4
    assert np.isfinite(a["loss"])
    assert all(float(o["moe_ep_engaged"]) == 1.0 for o in a["outputs"])
    assert all(o["moe_expert_load"].shape == (4,) for o in a["outputs"])
    assert not any(a["launches"].values())
    depth, t, d, h, e = 4, 8 * 16, 32, 128, 4
    c = moe.capacity_of(t // e, e, 1, 1.25)
    grads = a["param_elements"]
    want = {
        "ep_all_to_all_bytes": 3 * 2 * depth * e * c * d * 4,
        "ep_all_to_all_calls": 3 * 2 * depth,
        # the tokens' bf16 cotangents (backward), the bf16 outputs
        # (forward and recompute), the expert stacks' f32 cotangents
        # (backward)
        "ep_all_gather_bytes": depth * (3 * (t // e) * d * 2
                                        + (d * h + h + h * d + d) * 4),
        "ep_all_gather_calls": 4 * depth,
        "ep_all_reduce_bytes": depth * (2 * (3 * e + 1) * 4 + d * e * 4),
        "ep_all_reduce_calls": 3 * depth}
    got = {k: v for k, v in a["collectives"].items() if v}
    assert got == want
    assert grads > 0
    cfg = get_config("vit_tiny_cifar_moe")
    model = get_model(cfg.model, **{**cfg.model_kwargs, **cases.SMALL})
    target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                np.zeros((1, 32, 32, 3), np.uint8), "cpu")
    mgr = CheckpointManager(runs["ckpt"] / "vit_tiny_cifar_moe",
                            async_save=False)
    try:
        restored = mgr.restore(target)
    finally:
        mgr.close()
    assert restored.step_int == 4
    assert params_digest(restored.params) == a["digest"]


# -- serving ------------------------------------------------------------------

def test_zoo_serves_moe_at_an_inference_capacity(runs):
    """`build_zoo_engine(moe_capacity_factor=...)` replaces the model's
    factor and keeps the weights; the engine returns each batch's routed
    drop fraction beside the logits, as the reference's does: the logits
    within 2e-4 / 2e-5 and the drop fraction within 1e-6 of the
    reference engine's on the same params, and a tight factor drops
    more than the trained one."""
    spec = runs["spec"]["vit"]
    model = ViTTiny(**cases.VIT_MOE_KW)
    bundle = types.SimpleNamespace(
        model=model, params=params_from_jax(spec["params"]),
        model_state=params_from_jax(spec["state"]),
        image_shape=(32, 32, 3), quant=None)
    images = (np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3))
              .astype(np.uint8))
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32, **J_KW)
    drops = {}
    for cf in (4.0, 0.3):
        eng = build_zoo_engine(bundle, "cpu", model_name="vit_tiny",
                               max_bucket=4, moe_capacity_factor=cf)
        assert eng.model.moe_capacity_factor == cf
        got = eng.predict(images)
        jeng = JEngine(dataclasses.replace(jmodel, moe_capacity_factor=cf),
                       spec["params"], spec["state"],
                       mesh=_jmesh(1, 1), image_shape=(32, 32, 3),
                       max_bucket=4)
        want = jeng.predict(images)
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        np.testing.assert_allclose(eng.last_moe_drop_fraction,
                                   jeng.last_moe_drop_fraction, atol=1e-6)
        drops[cf] = eng.last_moe_drop_fraction
    assert drops[0.3] > drops[4.0]
    assert bundle.model.moe_capacity_factor == 4.0  # the bundle's is kept


def test_cli_launch_moe_on_four_cpu_ranks(tmp_path, runs):
    """The acceptance's command on the CPU: `cli.launch --num_processes=4
    --platform=cpu -- --config=vit_tiny_cifar_moe --mesh=model=4` (full
    width, batch 8, 2 steps) exits 0, each rank logs EP engaged and the
    same final digest."""
    data_dir = tmp_path / "data"
    tdatasets._write_synth_cache(data_dir, "cifar10", tdatasets._synth(
        "cifar10", 64, 16, 0))
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.launch",
         "--num_processes=4", "--platform=cpu", "--",
         "--config=vit_tiny_cifar_moe", "--mesh=model=4", "--batch_size=8",
         "--train_steps=2", "--eval_every=0", "--log_every=1",
         f"--data_dir={data_dir}"],
        cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    digests = {line.split("final params digest: ")[1]
               for line in proc.stdout.splitlines()
               if "final params digest: " in line}
    assert len(digests) == 1
    assert proc.stdout.count("moe_ep_engaged=1.0000") >= 4 * 2
    assert "'model': 4" in proc.stdout
