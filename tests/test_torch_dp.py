"""Data parallelism in the port against the JAX package's mesh step, on
the CPU: 2 and 4 gloo ranks (`torch_ranks.run_ranks`, the cases in
`torch_dp_cases.py`) against the reference's step on a 2- and a 4-device
mesh at the same global batch, and against the port on one rank.

- DP: one step of LeNet-5 (with the reference's dropout mask) and of
  ResNet-20 (batch norm synchronized over the ranks), f32 compute, under
  `sgd(1.0)` so that the update is minus the mean gradient; a per-replica
  batch norm (the explicit step) must miss the ResNet case.
- The random numbers a step draws (rows, crops and flips, dropout) are
  the same on 1, 2 and 4 ranks; metrics are equal on every rank.
- FSDP against DP: trajectories, per-rank bytes, the checkpoint round
  trip across strategies, evaluation and the MemoryHook.

Each group of ranks runs every case once (module fixtures), with a time
limit of its own. Each tolerance is stated beside its check.
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dist_mnist_tpu import optim as jopt
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.pipeline import shard_batch
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.parallel.sharding import shard_train_state as jshard
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu.train import make_train_step as jmake_train_step
from dist_mnist_tpu.train.state import TrainState as JTrainState

import torch_dp_cases
import torch_ranks


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


def _data(name, shape, n, n_test, seed):
    rng = np.random.default_rng(seed)
    return {"name": name,
            "train_images": rng.integers(0, 256, (n, *shape), np.uint8),
            "train_labels": rng.integers(0, 10, (n,), np.int32),
            "test_images": rng.integers(0, 256, (n_test, *shape), np.uint8),
            "test_labels": rng.integers(0, 10, (n_test,), np.int32)}


def _batch(n, shape, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, *shape), np.uint8),
            "label": rng.integers(0, 10, (n,), np.int32)}


@pytest.fixture(scope="module")
def spec():
    """The inputs every group and the reference share: LeNet-5 and
    ResNet-20 f32 inits of the reference, a batch for each (16 and 8
    rows), LeNet-5's dropout mask as the reference's step draws it, and
    two small datasets."""
    lenet = jget_model("lenet5", compute_dtype=jnp.float32)
    lstate = jax.jit(lambda k: jcreate_state(
        lenet, jopt.sgd(1.0), k, jnp.zeros((1, 28, 28, 1), jnp.uint8)))(
            jax.random.PRNGKey(0))
    resnet = jget_model("resnet20", compute_dtype=jnp.float32)
    rparams, rstate = jax.jit(lambda k: resnet.init(
        k, jnp.zeros((1, 32, 32, 3), jnp.float32)))(jax.random.PRNGKey(1))
    mask = np.asarray(jax.random.bernoulli(
        jax.random.fold_in(lstate.rng, 0), 0.5, (16, 512)))
    return {
        "lenet": {"params": jax.device_get(lstate.params),
                  "batch": _batch(16, (28, 28, 1), 2), "mask": mask,
                  "rng": lstate.rng},
        "resnet": {"params": jax.device_get(rparams),
                   "model_state": jax.device_get(rstate),
                   "batch": _batch(8, (32, 32, 3), 3)},
        "mnist": _data("mnist", (28, 28, 1), 512, 100, 4),
        "cifar": _data("cifar10", (32, 32, 3), 64, 20, 5),
    }


def _port_spec(spec):
    """The spec without the reference's key (the ranks import no JAX)."""
    return {**spec, "lenet": {k: v for k, v in spec["lenet"].items()
                              if k != "rng"}}


@pytest.fixture(scope="module")
def jax_steps(spec):
    """The reference's step on a `ranks`-device mesh: loss, accuracy,
    the update (minus the mean gradient) and the new BN statistics."""
    results = {}

    def run(ranks):
        if ranks in results:
            return results[ranks]
        mesh = jmake_mesh(JMeshSpec(data=ranks),
                          devices=jax.devices()[:ranks])
        out = {}
        sgd = jopt.sgd(1.0)
        for name, model, ms in (
                ("lenet", jget_model("lenet5", compute_dtype=jnp.float32),
                 {}),
                ("resnet", jget_model("resnet20", compute_dtype=jnp.float32),
                 spec["resnet"]["model_state"])):
            params = spec[name]["params"]
            rng = spec["lenet"]["rng"]
            with mesh:
                state = jshard(JTrainState(
                    step=jnp.zeros((), jnp.int32), params=params,
                    model_state=ms, opt_state=sgd.init(params), rng=rng),
                    mesh)
                step = jmake_train_step(model, sgd, mesh, donate=False)
                new, m = step(state, shard_batch(spec[name]["batch"], mesh))
            out[name] = {
                "loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
                "delta": jax.device_get(jax.tree.map(
                    lambda a, b: a - b, new.params, state.params)),
                "model_state": jax.device_get(new.model_state)}
        results[ranks] = out
        return out

    return run


@pytest.fixture(scope="module")
def groups(spec, tmp_path_factory):
    """Every case on 2 and on 4 gloo ranks, and on this process alone."""
    port = _port_spec(spec)
    out = {1: torch_dp_cases.all_cases(
        port, str(tmp_path_factory.mktemp("ckpt1")))}
    for ranks in (2, 4):
        root = tmp_path_factory.mktemp(f"group{ranks}")
        out[ranks] = torch_ranks.run_ranks(
            torch_dp_cases.all_cases, ranks, root / "store", port,
            str(root / "ckpt"), timeout=240)
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], (*prefix, str(k))))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _is_pre_bn_bias(path: str) -> bool:
    parts = path.split("/")
    return parts[-1] == "b" and parts[-2] in ("stem", "conv1", "conv2")


# -- DP against the reference's mesh step ------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_lenet_dp_step_matches_the_reference_mesh_step(groups, jax_steps,
                                                       ranks):
    """f32 LeNet-5 with the reference's dropout mask, each rank its slice:
    loss and accuracy within 1e-5 and every leaf's mean gradient within
    1e-5 of its largest reference value (the same arithmetic up to the
    order of the sums, the batch's split included)."""
    want = jax_steps(ranks)["lenet"]
    for res in groups[ranks]:
        got = res["dp"]["lenet"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
        for path, w in _flat(want["delta"]).items():
            assert _rel_err(got["delta"][path], w) <= 1e-5, path


@pytest.mark.parametrize("ranks", [2, 4])
def test_resnet_dp_step_with_synchronized_bn_matches_the_reference(
        groups, jax_steps, ranks):
    """f32 ResNet-20, batch norm over the global batch: loss within 1e-5,
    accuracy exact, the new BN statistics within 1e-4; each leaf's mean
    gradient within 1e-1 of its largest reference value (the reference's
    own f32 gradients lie up to 7% from an f64 evaluation: see
    test_torch_resnet.py), a conv bias that a norm follows 0 within 1e-6
    of the largest gradient."""
    want = jax_steps(ranks)["resnet"]
    wdelta = _flat(want["delta"])
    largest = max(float(np.abs(w).max()) for w in wdelta.values())
    for res in groups[ranks]:
        got = res["dp"]["resnet"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
        for path, w in _flat(want["model_state"]).items():
            assert _rel_err(_flat(got["model_state"])[path], w) <= 1e-4, path
        for path, w in wdelta.items():
            g = got["delta"][path]
            if _is_pre_bn_bias(path):
                assert float(np.abs(g).max()) <= 1e-6 * largest, path
            else:
                assert _rel_err(g, w) <= 1e-1, path


@pytest.mark.parametrize("ranks", [2, 4])
def test_per_replica_bn_misses_the_reference(groups, jax_steps, ranks):
    """The negative control: batch norm over each rank's slice only (the
    explicit step), its running statistics averaged afterwards. Its loss
    and its BN statistics' update both miss the synchronized reference by
    far more than the tolerances above (measured: the loss by more than
    1e-3 relative, some leaf's gradient by more than 0.3 of its largest
    value)."""
    want = jax_steps(ranks)["resnet"]
    got = groups[ranks][0]["dp"]["resnet_per_replica_bn"]
    assert abs(got["loss"] - want["loss"]) > 1e-3 * abs(want["loss"])
    worst = max(_rel_err(got["delta"][p], w)
                for p, w in _flat(want["delta"]).items()
                if not _is_pre_bn_bias(p))
    assert worst > 0.3


@pytest.mark.parametrize("ranks", [2, 4])
def test_dp_on_n_ranks_matches_one_rank(groups, ranks):
    """The port at the same global batch on 1 rank: loss within 1e-6, the
    update within 1e-4 (LeNet-5) and 2e-2 (ResNet-20, whose deepest
    leaves amplify the order of the sums; see test_torch_resnet.py) of
    each leaf's largest value."""
    one = groups[1]["dp"]
    for res in groups[ranks]:
        for name, tol in (("lenet", 1e-4), ("resnet", 2e-2)):
            got, want = res["dp"][name], one[name]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
            for path, w in want["delta"].items():
                if name == "resnet" and _is_pre_bn_bias(path):
                    continue
                assert _rel_err(got["delta"][path], w) <= tol, (name, path)


@pytest.mark.parametrize("ranks", [2, 4])
def test_metrics_and_state_are_equal_on_every_rank(groups, ranks):
    """Loss and accuracy are global means, bit-equal on every rank, and so
    are the updated params and the BN statistics."""
    first = groups[ranks][0]
    for res in groups[ranks][1:]:
        for name in ("lenet", "resnet"):
            a, b = first["dp"][name], res["dp"][name]
            assert a["loss"] == b["loss"] and a["accuracy"] == b["accuracy"]
            for path in a["delta"]:
                assert np.array_equal(a["delta"][path], b["delta"][path])
        for path, v in _flat(first["dp"]["resnet"]["model_state"]).items():
            assert np.array_equal(
                v, _flat(res["dp"]["resnet"]["model_state"])[path])


@pytest.mark.parametrize("ranks", [2, 4])
def test_draws_do_not_depend_on_the_number_of_ranks(groups, ranks):
    """Three fused steps sampling rows, ResNet-20's crops and flips and
    LeNet-5's dropout from one generator seed: each rank draws the global
    batch's numbers and keeps its slice, so the losses on N ranks equal
    one rank's within 1e-5 (summation order only). The params within 1e-4
    absolute: Adam(1e-3) moves a weight by up to 3e-3 in three steps, and
    a gradient near zero rounded the other way moves it differently
    (measured: 1.6e-5). A conv bias that a norm follows has a gradient of
    rounding noise, which Adam scales to full steps: not compared."""
    one = groups[1]["draws"]
    for res in groups[ranks]:
        for name in ("resnet", "lenet"):
            np.testing.assert_allclose(res["draws"][name]["losses"],
                                       one[name]["losses"], rtol=1e-5)
            for path, w in _flat(one[name]["params"]).items():
                if name == "resnet" and _is_pre_bn_bias(path):
                    continue
                got = _flat(res["draws"][name]["params"])[path]
                assert np.max(np.abs(got - w)) <= 1e-4, (name, path)


@pytest.mark.parametrize("ranks", [2, 4])
def test_evaluate_over_ranks_equals_one_rank(groups, ranks):
    """`evaluate` splits the test set over the ranks and all-reduces the
    sums: every rank reports the same numbers, the count of the whole set,
    and the one-rank evaluation of the same state (the DP and FSDP MLP
    states after two epochs are the same to 1e-5): accuracy equal, loss
    within 1e-5."""
    one = groups[1]["fsdp"]
    for res in groups[ranks]:
        for name in ("dp_eval", "fsdp_eval"):
            got = res["fsdp"][name]
            assert got == groups[ranks][0]["fsdp"][name]
            assert got["n"] == 100
            assert got["accuracy"] == one[name]["accuracy"]
            assert got["loss"] == pytest.approx(one[name]["loss"], rel=1e-5)
        assert res["draws"]["eval"]["n"] == 20


# -- FSDP ---------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_fsdp_trajectory_equals_dp(groups, ranks):
    """Two epochs of the host batcher (MLP, hidden 64, Adam): FSDP only
    changes where the bytes live, so its losses equal DP's within 1e-5
    and its final params within 1e-5 of each leaf's largest value; three
    ResNet-20 steps under its config's optimizer (global-norm clip over
    the slices, cosine Adam in warm-up, which moves a weight by at most
    3e-5 in three steps): losses within 1e-5, params within 5e-6
    absolute (measured: 1.1e-6) but for the conv biases a norm follows
    (their gradient is rounding noise), BN statistics within 1e-4 of each
    leaf's largest value."""
    for res in groups[ranks]:
        f = res["fsdp"]
        np.testing.assert_allclose(f["fsdp_traj"], f["dp_traj"], rtol=1e-5)
        assert f["dp_traj"][-1] < f["dp_traj"][0]
        for path, w in _flat(f["dp_params"]).items():
            assert _rel_err(_flat(f["fsdp_params"])[path], w) <= 1e-5, path
        np.testing.assert_allclose(f["resnet_fsdp_traj"],
                                   f["resnet_dp_traj"], rtol=1e-5)
        for path, w in _flat(f["resnet_dp_params"]).items():
            if _is_pre_bn_bias(path):
                continue
            got = _flat(f["resnet_fsdp_params"])[path]
            assert np.max(np.abs(got - w)) <= 5e-6, path
        for path, w in _flat(f["resnet_dp_model_state"]).items():
            assert _rel_err(_flat(f["resnet_fsdp_model_state"])[path],
                            w) <= 1e-4, path


@pytest.mark.parametrize("ranks", [2, 4])
def test_fsdp_per_rank_bytes_are_one_nth_of_dp(groups, ranks):
    """Per-rank params and Adam slots at 1/N of DP's give or take the
    leaves no rank count divides (here: the 10-wide output bias at 4
    ranks, the reference's test_fsdp.py:116), and the MemoryHook reports
    exactly the state's per-rank numbers."""
    for res in groups[ranks]:
        f = res["fsdp"]
        dp, fsdp = f["dp_bytes"], f["fsdp_bytes"]
        unsharded = 0 if ranks == 2 else 10 * 4
        for key, per_param in (("param_bytes", 1), ("opt_state_bytes", 2)):
            want = per_param * ((dp["param_bytes"] - unsharded) / ranks
                                + unsharded)
            assert fsdp[key] - (4 if key == "opt_state_bytes" else 0) == want
        hook = f["memory_hook"]
        now = f["fsdp_state_bytes_now"]
        for key in ("param_bytes", "opt_state_bytes", "model_state_bytes",
                    "total_bytes"):
            assert hook[f"memory/{key}_per_device"] == now[key]


@pytest.mark.parametrize("ranks", [2, 4])
def test_checkpoint_round_trip_across_strategies(groups, ranks):
    """DP -> FSDP -> DP: saved under DP, restored under FSDP, saved again
    (the chief gathers the slices and writes the full file) and restored
    under DP: every rank gets the step, the params and the Adam slots bit
    for bit, in the target's placement (1/N slices under FSDP, full
    leaves under DP); the chief wrote one step directory and the commit
    markers (the reference's test_fsdp.py:200)."""
    for res in groups[ranks]:
        f = res["fsdp"]
        want = f["trip_src"]
        (to_fsdp, to_dp) = f["trip"]
        assert to_dp["rules"] == "dp" and to_fsdp["rules"] == "fsdp"
        assert to_dp["hid_w_shape"] == (784, 64)
        assert to_fsdp["hid_w_shape"] == (784 // ranks, 64)
        assert to_fsdp["slot_shape"] == (784 // ranks, 64)
        for trip in (to_dp, to_fsdp):
            assert trip["step"] == 7
            for key in ("params", "opt"):
                for path, w in _flat(want[key]).items():
                    assert np.array_equal(_flat(trip[key])[path], w), path
        assert f["chief_wrote"] == ["7", "commits"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_gather_scatter_and_mean(groups, ranks):
    """The FSDP pair and the mean: all-gathering the reduce-scattered mean
    of rank r's ``x * (r + 1)`` gives ``x`` times the mean of 1..N; the
    mean of the ranks' indices is (N - 1) / 2."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for res in groups[ranks]:
        f = res["fsdp"]
        assert f["world"] == ranks
        np.testing.assert_allclose(f["scatter_gather"],
                                   x * (ranks + 1) / 2, rtol=1e-6)
        np.testing.assert_allclose(f["psum_mean"], (ranks - 1) / 2)
