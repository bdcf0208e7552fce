"""The port's mesh, placement rules, gradient accumulation and per-rank
input against the JAX package, on the CPU, in one process.

A rank's view is a `Mesh` built by hand (rank r of N) wherever no
collective runs: the specs, the slices a rank keeps, the rows its
batcher loads. The collectives themselves run on real gloo ranks in
`test_torch_dp.py`. Each tolerance is stated beside its check.
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from dist_mnist_tpu import optim as jopt
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.data.datasets import Dataset as JDataset
from dist_mnist_tpu.data.pipeline import DeviceDataset as JDeviceDataset
from dist_mnist_tpu.data.pipeline import epoch_batches as jepoch_batches
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.parallel.sharding import FSDP_RULES as JFSDP
from dist_mnist_tpu.parallel.sharding import derive_state_specs as jderive
from dist_mnist_tpu.train import create_train_state as jcreate_state
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.cluster.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    local_batch_slice,
    make_mesh,
)
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data.datasets import Dataset
from dist_mnist_tpu_torch.data.pipeline import DeviceDataset, ShardedBatcher
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    FSDP_RULES,
    P,
    ShardingRules,
    derive_state_specs,
    full_template,
    path_str,
    resolve_rules,
    shard_train_state,
)
from dist_mnist_tpu_torch.train import create_train_state, state_memory_bytes
from dist_mnist_tpu_torch.train.state import TrainState
from dist_mnist_tpu_torch.utils.tree import flatten_with_path


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


def _rank(rank: int, ranks: int) -> Mesh:
    """Rank `rank`'s view of an N-rank data mesh (no group: no collective
    may run on it)."""
    return Mesh(shape={**{a: 1 for a in AXES}, "data": ranks}, rank=rank)


# -- the mesh ---------------------------------------------------------------

def test_mesh_spec_resolution():
    assert MeshSpec(data=-1).resolve(8) == (8, 1, 1, 1)
    assert MeshSpec(data=-1, model=2).resolve(8) == (4, 2, 1, 1)
    assert MeshSpec(data=2, model=2, seq=2).resolve(8) == (2, 2, 2, 1)
    assert MeshSpec(data=-1, pipe=4).resolve(8) == (2, 1, 1, 4)
    with pytest.raises(ValueError):
        MeshSpec(data=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(data=-1, model=3).resolve(8)


def test_make_mesh_on_one_process():
    mesh = make_mesh(MeshSpec(data=-1))
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert make_mesh(MeshSpec(data=1)).size == 1
    # more ranks than exist: the bench's fallback keys on ValueError
    with pytest.raises(ValueError, match="only 1 visible"):
        make_mesh(MeshSpec(data=4))
    # a model axis is a mesh axis now: two ranks, of which one exists
    with pytest.raises(ValueError, match="only 1 visible"):
        make_mesh(MeshSpec(data=1, model=2))
    # a pipe axis is a mesh axis now (two ranks, of which one exists);
    # beside a model axis it refuses, as seq beside model does
    with pytest.raises(ValueError, match="only 1 visible"):
        make_mesh(MeshSpec(data=1, pipe=2))
    for spec, item in ((MeshSpec(data=1, model=2, seq=2), "item 11"),
                       (MeshSpec(data=1, model=2, pipe=2), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            make_mesh(spec)


def test_local_batch_slice():
    # one device per process: a rank's batch is both numbers
    assert local_batch_slice(64, _rank(0, 8)) == (8, 8)
    assert local_batch_slice(64, _rank(0, 1)) == (64, 64)
    with pytest.raises(ValueError):
        local_batch_slice(65, _rank(0, 8))


# -- the rules ---------------------------------------------------------------

def test_dp_rules_replicate_everything():
    tree = {"layer": {"w": torch.zeros(4, 4), "b": torch.zeros(4)}}
    mesh = _rank(0, 8)
    for path, leaf in flatten_with_path(tree):
        assert DP_RULES.leaf_spec(path_str(path), leaf, mesh) == P()


def test_fsdp_rule_picks_largest_divisible_free_dim():
    mesh = _rank(0, 8)
    assert FSDP_RULES.leaf_spec("w", torch.zeros(16, 128), mesh) == P(
        None, "data")
    assert FSDP_RULES.leaf_spec("w2", torch.zeros(128, 16), mesh) == P(
        "data", None)
    assert FSDP_RULES.leaf_spec("b", torch.zeros(8), mesh) == P("data")
    # integer leaves and non-divisible shapes stay replicated
    assert FSDP_RULES.leaf_spec("c", torch.zeros(8, dtype=torch.int32),
                                mesh) == P()
    assert FSDP_RULES.leaf_spec("d", torch.zeros(3, 5), mesh) == P()
    assert FSDP_RULES.leaf_spec("s", torch.zeros(()), mesh) == P()


@pytest.mark.parametrize("model", ["lenet5", "resnet20"])
@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_fsdp_specs_equal_the_references_leaf_for_leaf(model, ranks):
    """Every param, slot and BN leaf of LeNet-5 and ResNet-20 under the
    FSDP rule: the same leaves sharded along the same dims as the
    reference's `derive_state_specs` on a mesh of that many devices (the
    layouts are the reference's, HWIO and [in, out])."""
    shape = (1, 28, 28, 1) if model == "lenet5" else (1, 32, 32, 3)
    jmodel = jget_model(model)
    jstate = jax.eval_shape(lambda k: jcreate_state(
        jmodel, jopt.adam(1e-3), k, jnp.zeros(shape, jnp.uint8)),
        jax.random.PRNGKey(0))
    jmesh = jmake_mesh(JMeshSpec(data=ranks), devices=jax.devices()[:ranks])
    jspecs = jderive(jstate, jmesh, JFSDP)
    tmodel = tget_model(model)
    tstate = create_train_state(tmodel, topt.adam(1e-3), 0,
                                np.zeros(shape, np.uint8), "cpu")
    tspecs = derive_state_specs(tstate, _rank(0, ranks), FSDP_RULES)
    n_sharded = 0
    for part in ("params", "model_state", "opt_state"):
        t_flat = flatten_with_path(getattr(tspecs, part))
        j_flat = jax.tree_util.tree_flatten_with_path(
            getattr(jspecs, part), is_leaf=lambda x: isinstance(x, JP))[0]
        assert len(t_flat) == len(j_flat), part
        for (path, got), (_, want) in zip(t_flat, j_flat):
            assert tuple(got) == tuple(want), (part, path)
            n_sharded += got.dim() is not None
    assert n_sharded > 0


def test_opt_state_inherits_specs_through_chain_and_accumulation():
    """Adam slots, chained-transform slots and the accumulation buffer
    mirror the param tree, so each leaf takes its param's spec; counters
    never shard (the reference's test_fsdp.py:51, here against the
    reference's own specs leaf for leaf)."""
    shape = (1, 28, 28, 1)

    def chain(m):
        return m.gradient_accumulation(
            m.chain(m.clip_by_global_norm(1.0), m.adam(1e-3)), 2)

    jmodel = jget_model("mlp", hidden_units=64)
    jstate = jax.eval_shape(lambda k: jcreate_state(
        jmodel, chain(jopt), k, jnp.zeros(shape, jnp.uint8)),
        jax.random.PRNGKey(0))
    jmesh = jmake_mesh(JMeshSpec(data=8))
    jspecs = jderive(jstate, jmesh, JFSDP)
    tstate = create_train_state(tget_model("mlp", hidden_units=64),
                                chain(topt), 0, np.zeros(shape, np.uint8),
                                "cpu")
    tspecs = derive_state_specs(tstate, _rank(0, 8), FSDP_RULES)
    t_flat = flatten_with_path(tspecs.opt_state)
    j_flat = jax.tree_util.tree_flatten_with_path(
        jspecs.opt_state, is_leaf=lambda x: isinstance(x, JP))[0]
    assert len(t_flat) == len(j_flat)
    hid = 0
    for (path, got), (_, want) in zip(t_flat, j_flat):
        assert tuple(got) == tuple(want), path
        if path[-2:] == ("hid", "w"):
            assert got == P("data", None), path
            hid += 1
        if path[-1] in ("count", "calls"):
            assert got == P(), path
    assert hid == 3  # the accumulation buffer, and the chained adam's m, v
    assert tspecs.step == P() and tspecs.rng == P()


def test_named_strategy_matching_nothing_always_raises():
    """(3, 5) floats: no dim divides 8 and no regex matches, so both named
    strategies resolve to zero matches and shard_train_state refuses."""
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params={"conv": {"w": torch.zeros(3, 5)}},
                       model_state={}, opt_state={},
                       rng=torch.Generator())
    mesh = _rank(0, 8)
    named = ShardingRules(rules=((r"qkv/w$", (None, "model")),))
    for rules in (named, FSDP_RULES):
        assert rules.match_count(state.params, mesh) == 0
        with pytest.raises(ValueError, match="matched no parameter"):
            shard_train_state(state, mesh, rules)
    shard_train_state(state, mesh, DP_RULES)  # DP always passes


def test_custom_rule_ordering():
    rules = ShardingRules(rules=((r"special/w$", ("data",)),
                                 (r"w$", ("model",))))
    assert rules.spec_for("special/w", 1) == P("data")
    assert rules.spec_for("other/w", 1) == P("model")
    assert rules.spec_for("other/b", 1) == P()


@pytest.mark.parametrize("name", ["tp", "fsdp_tp"])
def test_tensor_parallel_rules_refuse_naming_their_item(name):
    # the tensor-parallel slice brought them: they resolve, to the
    # reference's regexes, and an unknown name still refuses
    from dist_mnist_tpu.parallel.sharding import resolve_rules as jresolve

    rules = resolve_rules(name)
    assert rules.rules == jresolve(name).rules
    assert (rules.fsdp_axis == "data") == (name == "fsdp_tp")
    assert resolve_rules("dp") is DP_RULES
    assert resolve_rules("fsdp") is FSDP_RULES
    with pytest.raises(ValueError):
        resolve_rules("zero3")


@pytest.mark.parametrize("ranks", [2, 4])
def test_each_rank_keeps_its_slice_and_a_1_over_n_share(ranks):
    """shard_train_state on rank r keeps slice r of every sharded leaf
    (its own memory); the slices put together are the full leaf; the
    per-rank param and slot bytes are 1/N of DP's give or take the
    unsharded leaves (the reference's test_fsdp.py:116); full_template
    restores the full shapes."""
    model = tget_model("lenet5")
    base = create_train_state(model, topt.adam(1e-3), 0,
                              np.zeros((1, 28, 28, 1), np.uint8), "cpu")
    dp = state_memory_bytes(shard_train_state(base, _rank(0, ranks),
                                              DP_RULES))
    states = [shard_train_state(base, _rank(r, ranks), FSDP_RULES)
              for r in range(ranks)]
    specs = dict(flatten_with_path(states[0].placement.specs.params))
    unsharded = 0
    for path, full in flatten_with_path(base.params):
        d = specs[path].dim()
        parts = [dict(flatten_with_path(s.params))[path] for s in states]
        if d is None:
            unsharded += full.numel() * 4
            continue
        assert torch.equal(torch.cat(parts, dim=d), full), path
        assert parts[0].untyped_storage().data_ptr() != \
            full.untyped_storage().data_ptr()
    for s in states:
        mem = state_memory_bytes(s)
        # params once, Adam m and v twice, the 4-byte counter once
        want = (dp["param_bytes"] - unsharded) / ranks + unsharded
        assert mem["param_bytes"] == want
        assert mem["opt_state_bytes"] == 2 * want + 4
        assert mem["model_state_bytes"] == dp["model_state_bytes"]
        template = full_template(s)
        for (path, a), (_, b) in zip(flatten_with_path(template.params),
                                     flatten_with_path(base.params)):
            assert a.shape == b.shape, path


# -- gradient accumulation ----------------------------------------------------

def test_gradient_accumulation_matches_large_batch():
    """k accumulated microbatches == one update on the averaged gradient
    (the reference's test_optim.py:76); params stay put before the
    boundary; within 1e-5."""
    k = 4
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(k)]
    accum = topt.gradient_accumulation(topt.adam(0.01), every=k)
    params = {"w": torch.zeros(5)}
    state, p = accum.init(params), params
    seen = []
    for g in grads:
        updates, state = accum.update({"w": torch.from_numpy(g)}, state, p)
        p = topt.apply_updates(p, updates)
        seen.append(p["w"].clone())
    for snap in seen[:-1]:
        assert torch.equal(snap, torch.zeros(5))
    base = topt.adam(0.01)
    updates, _ = base.update({"w": torch.from_numpy(np.mean(grads, 0))},
                             base.init(params), params)
    want = topt.apply_updates(params, updates)
    np.testing.assert_allclose(p["w"].numpy(), want["w"].numpy(), rtol=1e-5)
    assert int(state["inner"]["count"]) == 1


def test_gradient_accumulation_every_one_is_identity():
    inner = topt.adam(0.01)
    assert topt.gradient_accumulation(inner, 1) is inner
    with pytest.raises(ValueError):
        topt.gradient_accumulation(inner, 0)


def test_gradient_accumulation_matches_the_reference_leaf_for_leaf():
    """Accumulated clip + Adam over 6 calls (3 boundaries), LeNet-5's
    leaves, against the reference's: updates, state and params within
    1e-6 of the largest value of each leaf."""
    shapes = {"conv1": {"w": (5, 5, 1, 32), "b": (32,)},
              "fc2": {"w": (512, 10), "b": (10,)}}
    rng = np.random.default_rng(0)

    def tree(scale=1.0):
        return {k: {n: (scale * rng.standard_normal(v)).astype(np.float32)
                    for n, v in d.items()} for k, d in shapes.items()}
    params_np = tree()
    j_opt = jopt.gradient_accumulation(
        jopt.chain(jopt.clip_by_global_norm(1.0), jopt.adam(1e-3)), 2)
    t_opt = topt.gradient_accumulation(
        topt.chain(topt.clip_by_global_norm(1.0), topt.adam(1e-3)), 2)
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = params_from_jax(params_np)
    js, ts = j_opt.init(jp), t_opt.init(tp)

    def close(t_tree, j_tree):
        t_flat = flatten_with_path(t_tree)
        j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
        assert len(t_flat) == len(j_flat)
        for (path, got), (_, want) in zip(t_flat, j_flat):
            want = np.asarray(want)
            err = np.max(np.abs(got.numpy() - want), initial=0.0)
            assert err <= 1e-6 * (np.max(np.abs(want), initial=0.0) + 1e-30)\
                or err == 0, path

    for _ in range(6):
        g = tree(3.0)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = t_opt.update(params_from_jax(g), ts, tp)
        close(tu, ju)
        close(ts, js)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        close(tp, jp)


# -- per-rank input -----------------------------------------------------------

def _dataset(n=96, shape=(4, 4, 1), seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        train_images=rng.integers(0, 256, (n, *shape), dtype=np.uint8),
        train_labels=rng.integers(0, 10, (n,), dtype=np.int32),
        test_images=rng.integers(0, 256, (8, *shape), dtype=np.uint8),
        test_labels=rng.integers(0, 10, (8,), dtype=np.int32))
    return (Dataset(name="toy", **arrays, synthetic=True),
            JDataset(name="toy", **arrays, synthetic=True))


@pytest.mark.parametrize("start", [0, 5])
def test_sharded_batcher_slices_equal_the_references(start):
    """Rank r of 2 loads rows ``idx[r * local:(r + 1) * local]`` of the
    reference's `epoch_batches` permutation, byte for byte, across an
    epoch boundary; `start_step` seeks (96 rows, batch 16: 6 steps an
    epoch)."""
    ds, _ = _dataset()
    want = []
    for epoch in range(3):
        want += list(jepoch_batches(96, 16, seed=3, epoch=epoch))
    for r in range(2):
        it = ShardedBatcher(ds, 16, "cpu", seed=3, start_step=start,
                            mesh=_rank(r, 2)).host_batches()
        for step in range(start, start + 8):
            got = next(it)
            mine = want[step][r * 8:(r + 1) * 8]
            assert got["image"].tobytes() == ds.train_images[mine].tobytes()
            assert np.array_equal(got["label"], ds.train_labels[mine])
    with pytest.raises(ValueError, match="divide evenly"):
        next(ShardedBatcher(ds, 15, "cpu", mesh=_rank(0, 2)).host_batches())


@pytest.mark.parametrize("ranks", [2, 4])
def test_device_dataset_shard_residency_equals_the_references(ranks):
    """shard=True: rank r holds the reference's shard r of the seeded
    global shuffle (its `DeviceDataset(shard=True)` rows on a mesh of
    that many devices), 1/N of the bytes; a draw keeps rows of its own
    shard."""
    ds, jds = _dataset(n=98)
    jmesh = jmake_mesh(JMeshSpec(data=ranks), devices=jax.devices()[:ranks])
    jdd = JDeviceDataset(jds, jmesh, shard=True, seed=5)
    j_images = np.asarray(jax.device_get(jdd.images))
    j_labels = np.asarray(jax.device_get(jdd.labels))
    per = j_images.shape[0] // ranks
    full = DeviceDataset(ds, "cpu")
    for r in range(ranks):
        dd = DeviceDataset(ds, "cpu", mesh=_rank(r, ranks), shard=True,
                           seed=5)
        assert dd.n == jdd.n
        assert np.array_equal(dd.images.numpy(),
                              j_images[r * per:(r + 1) * per])
        assert np.array_equal(dd.labels.numpy(),
                              j_labels[r * per:(r + 1) * per])
        assert dd.nbytes() * ranks <= full.nbytes()
        batch = dd.sample(torch.Generator().manual_seed(0), 4 * ranks)
        assert batch["image"].shape == (4, 4, 4, 1)
        mine = {row.tobytes() for row in dd.images.numpy()}
        assert all(img.numpy().reshape(-1).tobytes() in mine
                   for img in batch["image"])


def test_device_dataset_full_residency_keeps_a_slice_of_the_global_draw():
    """Full residency: every rank draws the GLOBAL batch's indices from
    the same generator and keeps its rows, so the ranks' slices put
    together are the one-rank batch."""
    ds, _ = _dataset()
    one = DeviceDataset(ds, "cpu").sample(torch.Generator().manual_seed(1),
                                          12)
    parts = [DeviceDataset(ds, "cpu", mesh=_rank(r, 3)).sample(
        torch.Generator().manual_seed(1), 12) for r in range(3)]
    for k in ("image", "label"):
        assert torch.equal(torch.cat([p[k] for p in parts]), one[k])


def test_bench_runs_the_fsdp_config_on_one_rank_as_dp():
    """`bench.run_config` on one rank: the config's 8-device mesh is not
    there, so it falls back to the one rank, at the per-chip batch 128,
    and a strategy a one-rank mesh cannot measure is benched as DP and
    the record says so (the reference's `bench_config`); ResNet-20's
    analytic FLOPs are the MFU numerator. Cut to 2-step chunks on a
    64-image set."""
    from dist_mnist_tpu_torch import bench, configs

    rng = np.random.default_rng(0)
    ds = Dataset(name="cifar10",
                 train_images=rng.integers(0, 256, (64, 32, 32, 3),
                                           dtype=np.uint8),
                 train_labels=rng.integers(0, 10, (64,), dtype=np.int32),
                 test_images=np.zeros((1, 32, 32, 3), np.uint8),
                 test_labels=np.zeros((1,), np.int32), synthetic=True)
    rec = bench.run_config(configs.get_config("resnet20_cifar_fsdp"),
                           torch.device("cpu"), 2, dataset=ds, chunk=2)
    extra = rec["extra"]
    assert extra["global_batch"] == 128 and extra["chips"] == 1
    assert extra["sharding"] == "dp"
    assert "benched as DP, not 'fsdp'" in extra["mesh_note"]
    model = tget_model("resnet20")
    assert extra["flops_per_step"] == 3 * 128 * model.flops_per_example(
        (1, 32, 32, 3))
    assert len(extra["chunk_losses"]) == 2
    assert "resnet20_cifar" in bench.CONFIGS
