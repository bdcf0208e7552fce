"""The serving stack's rest on the CPU, against the JAX package where it
has a counterpart: `q_einsum` and its spec parser, the engine's hot swap
(an int8 engine re-quantizing a float tree), the cell cache and the serve
memory budget, the server's background prewarm, `cli.router` in both
fleet shapes (in process, and `cli.serve --serve_forever` children over
HTTP), and `bench --serve --fleet` / `--serve --autoscale` with their
gates.

Side by side with the reference on seeded inputs: `_matmul_spec` over a
list of specs (the same answers); `q_einsum` against the reference's
XLA path (the dequantized einsum) within 1e-5 of the largest output in
f32; and an int8 port engine after `swap_weights` of a float tree
against the reference's `InferenceEngine` after the same swap on the
converted weights: the same int8 leaves bit for bit, logits within 1e-4
of the largest (f32 compute: summation order only).

The reference's swap and budget cases (tests/test_serve_quant.py,
tests/test_serve_zoo.py) are ported to the port's engine. On the CPU a
cell counts 0 bytes against the budget (the reference's rule for a
backend without a memory analysis); the cases that need a cell's bytes
give `WarmCell.measure` a fixed size, as a card's peak allocation would.
"""

from __future__ import annotations

import json
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_mnist_tpu.models.registry import get_model as jget_model
from dist_mnist_tpu.ops import quant as jquant
from dist_mnist_tpu.serve.engine import InferenceEngine as JaxEngine
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.cli import router as router_cli
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.ops import quant as tquant
from dist_mnist_tpu_torch.ops.quant import is_quantized, quantize_tree
from dist_mnist_tpu_torch.serve import (
    CompiledModelCache,
    InferenceEngine,
    InferenceServer,
    ServeConfig,
    ServeMemoryBudgetError,
    build_zoo_engine,
    default_seq_grid,
    load_for_serving,
    make_images,
)
from dist_mnist_tpu_torch.serve import engine as engine_mod
from dist_mnist_tpu_torch.utils.tree import leaves, tree_map

MNIST = (28, 28, 1)
#: the small zoo of tests/test_torch_zoo.py: 16 x 16 RGB in patches of 4
IMAGE_SHAPE = (16, 16, 3)
SMALL_VIT = dict(depth=1, dim=16, heads=2, patch=4, dropout_rate=0.0)


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
    """Every port router, exporter and replica child a test starts is
    gone by its end (the suite's own check reads the reference's lists
    only)."""
    from dist_mnist_tpu_torch.obs import exporter as exporter_mod
    from dist_mnist_tpu_torch.serve import router as router_mod

    yield
    assert not router_mod._LIVE_ROUTERS
    assert not exporter_mod._LIVE_EXPORTERS
    assert not [p for p in router_cli._LIVE_REPLICA_PROCS
                if p.poll() is None]


def _images(n, h=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, *IMAGE_SHAPE[1:]),
                        dtype=np.uint8)


def _tiny_vit():
    model = get_model("vit_tiny", compute_dtype=torch.float32, **SMALL_VIT)
    params, ms = model.init(torch.Generator().manual_seed(0),
                            torch.zeros(1, *IMAGE_SHAPE))
    return model, params, ms


# -- q_einsum against the reference -------------------------------------------

SPECS = ["bk,kh->bh", "bsk,kh->bsh", "...k,kh->...h", "b s k , k h -> b s h",
         "abk,kh->abh", "bk,kh->hb", "bk,hk->bh", "bsk,kh->bh",
         "bk,kh", "bk,kh,hj->bj", "bkk,kh->bkh", "bk,kb->bb", "k,kh->h",
         "bk,k->b", "bsk,kh->bsk", "bq,kh->bh"]


@pytest.mark.parametrize("spec", SPECS)
def test_matmul_spec_equals_the_reference(spec):
    assert tquant._matmul_spec(spec) == jquant._matmul_spec(spec)


@pytest.mark.parametrize("spec,x_shape", [
    ("bk,kh->bh", (5, 24)), ("bsk,kh->bsh", (3, 4, 24)),
    ("...k,kh->...h", (2, 3, 4, 24)), ("bk,kh->hb", (5, 24)),
    ("bsk,kh->bh", (3, 4, 24))])
def test_q_einsum_equals_the_reference_xla_path(monkeypatch, spec, x_shape):
    """Seeded inputs through both packages' `q_einsum` with an int8
    weight quantized by each (bit-equal leaves): the reference on its
    XLA path (the dequantized einsum), the port on the CPU (the plain
    `quant_matmul` for a matmul spec, the dequantized einsum otherwise),
    within 1e-5 of the largest output."""
    monkeypatch.setattr(jquant, "FUSED_MATMUL", "xla")
    rng = np.random.default_rng(len(spec) + len(x_shape))
    w = (0.05 * rng.standard_normal((24, 10))).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    tw, jw = tquant.quantize(torch.from_numpy(w)), jquant.quantize(
        jnp.asarray(w))
    assert np.array_equal(tw.q.numpy(), np.asarray(jw.q))
    got = tquant.q_einsum(spec, torch.from_numpy(x), tw).numpy()
    want = np.asarray(jquant.q_einsum(spec, jnp.asarray(x), jw))
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= \
        1e-5 * float(np.max(np.abs(want)))


def test_q_einsum_matmul_spec_takes_the_kernel_route(monkeypatch):
    """A last-axis matmul spec with a 2-D int8 weight goes through
    `quant_matmul` (its plain version here, for CPU tensors); another
    spec, and a float weight, never do."""
    calls = []
    real = tquant.quant_matmul

    def spy(x, q, scale):
        calls.append(tuple(x.shape))
        return real(x, q, scale)

    monkeypatch.setattr(tquant, "quant_matmul", spy)
    w = tquant.quantize(torch.randn(8, 3, generator=torch.Generator()
                                    .manual_seed(1)))
    x = torch.ones(2, 5, 8)
    tquant.q_einsum("bsk,kh->bsh", x, w)
    tquant.q_einsum("bsk,kh->bh", x, w)
    tquant.q_einsum("bsk,kh->bsh", x, tquant.dequantize(w))
    assert calls == [(2, 5, 8)]


# -- hot swap against the reference -------------------------------------------

def test_int8_swap_of_a_float_tree_equals_the_reference(mesh1):
    """Both packages' int8 `mlp` engines on converted weights, each
    swapped to the same float tree (+0.5): the engine re-quantizes it,
    its int8 leaves equal the reference's bit for bit, logits within 1e-4
    of the largest, and neither engine ran a cell for the first time."""
    jmodel = jget_model("mlp")
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *MNIST)))
    jeng = JaxEngine(jmodel, jparams, {}, mesh1, model_name="mlp_swap",
                     image_shape=MNIST, max_bucket=8, quant="int8")
    teng = InferenceEngine(get_model("mlp"),
                           params_from_jax(jax.device_get(jparams)), {},
                           device="cpu", model_name="mlp_swap",
                           image_shape=MNIST, max_bucket=8, quant="int8")
    jeng.prewarm()
    teng.prewarm()
    misses = (jeng.cache.misses, teng.misses)
    new = jax.tree.map(lambda p: p + 0.5, jparams)
    jeng.swap_weights(new, {}, version=7)
    teng.swap_weights(params_from_jax(jax.device_get(new)), {}, version=7)
    assert teng.weights_version == jeng.weights_version == 7
    for layer in ("hid", "sm"):
        got, want = teng.params[layer]["w"], jeng.params[layer]["w"]
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert np.array_equal(got.scale.numpy().view(np.int32),
                              np.asarray(want.scale).view(np.int32))
    images = make_images(MNIST, seed=4, n=8)
    got, want = teng.predict(images), jeng.predict(images)
    assert float(np.max(np.abs(got - want))) <= \
        1e-4 * float(np.max(np.abs(want)))
    assert (jeng.cache.misses, teng.misses) == misses


def test_swap_refuses_a_mismatch_and_keeps_the_old_weights():
    """A tree of another structure or another leaf shape refuses, and the
    engine keeps serving the weights it had, bit for bit."""
    bundle = load_for_serving("mlp_mnist", "cpu")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=4)
    images = make_images(MNIST, seed=2, n=3)
    before = eng.predict(images)
    wrong_shape = tree_map(lambda p: p, bundle.params)
    wrong_shape["sm"]["w"] = torch.zeros(100, 11)
    for params in (wrong_shape, {"hid": bundle.params["hid"]}):
        with pytest.raises(ValueError, match="swap"):
            eng.swap_weights(params, bundle.model_state, version=3)
    assert eng.weights_version == 0
    np.testing.assert_array_equal(eng.predict(images), before)


def test_a_running_batch_keeps_the_old_weights(monkeypatch):
    """A swap while a batch runs: that batch finishes on the tensors it
    read at its start; the next predict sees the new ones."""
    bundle = load_for_serving("mlp_mnist", "cpu")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=4)
    images = make_images(MNIST, seed=3, n=2)
    old = eng.predict(images)
    entered, release = threading.Event(), threading.Event()
    real = eng.model

    class Slow:
        def apply(self, params, *args, **kwargs):
            entered.set()
            release.wait(10)
            return real.apply(params, *args, **kwargs)

        def __getattr__(self, name):
            return getattr(real, name)

    monkeypatch.setattr(eng, "model", Slow())
    box = []
    t = threading.Thread(target=lambda: box.append(eng.predict(images)))
    t.start()
    assert entered.wait(10)
    eng.swap_weights(tree_map(lambda p: p + 0.5, bundle.params), {},
                     version=1)
    release.set()
    t.join(10)
    monkeypatch.setattr(eng, "model", real)
    np.testing.assert_array_equal(box[0], old)
    assert not np.allclose(eng.predict(images), old)


# -- the memory budget (reference tests/test_serve_quant.py) ------------------

def test_budget_admits_int8_where_float_refuses():
    """A budget between the int8 and float weight footprints (the wide
    MLP) refuses the float engine at construction and admits the int8
    one, whose grid then sits resident under it."""
    model = get_model("mlp", hidden_units=2048)
    params, ms = model.init(torch.Generator().manual_seed(0),
                            torch.zeros(1, *MNIST))
    kw = dict(device="cpu", image_shape=MNIST, max_bucket=8)
    qparams = quantize_tree(params)
    q_total = InferenceEngine(model, qparams, ms, model_name="mlpw_q",
                              **kw).state_bytes_per_device()["total_bytes"]
    f_total = InferenceEngine(model, params, ms, model_name="mlpw_f",
                              **kw).state_bytes_per_device()["total_bytes"]
    assert q_total < 0.30 * f_total
    budget = (q_total + f_total) // 2
    with pytest.raises(ServeMemoryBudgetError, match="weights alone"):
        InferenceEngine(model, params, ms, model_name="mlpw_refuse",
                        memory_budget_bytes=budget, **kw)
    eng = InferenceEngine(model, qparams, ms, model_name="mlpw_admit",
                          memory_budget_bytes=budget, **kw)
    assert eng.prewarm() > 0  # the int8 grid sits resident under budget
    assert eng.cache.stats()["evictions"] == 0
    assert eng.predict(make_images(MNIST, seed=1, n=4)).shape == (4, 10)


def test_hot_swap_requantizes_float_tree_without_first_runs():
    bundle = load_for_serving("mlp_mnist", "cpu", quant="int8")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp_swap",
                           max_bucket=8)
    eng.prewarm()
    misses0 = eng.cache.misses
    # the rollout hands full-width float checkpoints to an int8 replica:
    # swap quantizes on the fly, never refuses or runs a cell again
    float_bundle = load_for_serving("mlp_mnist", "cpu")
    new_params = tree_map(lambda p: p + 0.5, float_bundle.params)
    eng.swap_weights(new_params, float_bundle.model_state, version=2)
    assert is_quantized(eng.params) and eng.weights_version == 2
    eng.predict(make_images(MNIST, seed=7, n=8))
    assert eng.cache.misses == misses0, "the swap caused a first run"


def test_engine_cache_keys_fold_quant_in():
    bundle_f = load_for_serving("mlp_mnist", "cpu")
    bundle_q = load_for_serving("mlp_mnist", "cpu", quant="int8")
    eng_f = build_zoo_engine(bundle_f, "cpu", model_name="mlp",
                             max_bucket=8)
    eng_q = build_zoo_engine(bundle_q, "cpu", model_name="mlp",
                             max_bucket=8)
    # one model name, one cell: an int8 engine never shares a float cell
    assert eng_f._key(8, 28, "dense") != eng_q._key(8, 28, "dense")
    assert eng_f._key(8, 28, "dense")[3] == "uint8->float32"
    assert "wint8" in eng_q._key(8, 28, "dense")[3]


# -- the cell cache (reference tests/test_serve_zoo.py) -----------------------

class _FakeCell:
    def __init__(self, n):
        self.nbytes = n


def test_budget_lru_evicts_coldest_and_counts():
    cache = CompiledModelCache()
    cache.set_budget(1000, base_bytes=400)
    cache.get("a", lambda: _FakeCell(300))
    cache.get("b", lambda: _FakeCell(300))  # resident 1000 == budget: fits
    cache.get("a", lambda: _FakeCell(300))  # touch a -> b is now coldest
    cache.get("c", lambda: _FakeCell(300))  # must evict b, never c
    assert cache.evictions == 1
    stats = cache.stats()
    assert stats["entries"] == 2
    misses0 = stats["misses"]
    cache.get("a", lambda: _FakeCell(300))  # still resident
    assert cache.stats()["misses"] == misses0
    cache.get("b", lambda: _FakeCell(300))  # evicted -> runs again
    assert cache.stats()["misses"] == misses0 + 1


def test_budget_refusals():
    cache = CompiledModelCache()
    with pytest.raises(ServeMemoryBudgetError, match="weights alone"):
        cache.set_budget(300, base_bytes=400)
    cache.set_budget(1000, base_bytes=400)
    with pytest.raises(ServeMemoryBudgetError, match="even alone"):
        cache.get("big", lambda: _FakeCell(700))
    assert cache.stats()["entries"] == 0  # the unfittable entry was popped


def _sized_cells(monkeypatch, nbytes):
    """Give every cell's first run `nbytes` on the budget (a card's peak
    allocation over the run; the CPU's is 0)."""
    real = engine_mod.WarmCell.measure

    def measure(fn, device):
        real(fn, device)
        return engine_mod.WarmCell(nbytes)

    monkeypatch.setattr(engine_mod.WarmCell, "measure",
                        staticmethod(measure))


def _weight_bytes(params):
    return sum(p.numel() * p.element_size() for p in leaves(params))


@pytest.mark.parametrize("headroom", [1, 1500])
def test_engine_prewarm_refuses_a_grid_that_cannot_stay(monkeypatch,
                                                         headroom):
    """1,000-byte cells beside the weights: one byte of headroom cannot
    hold the first cell (refused as it runs); 1,500 bytes hold one cell,
    so the second evicts the first and prewarm refuses the grid."""
    _sized_cells(monkeypatch, 1000)
    model, params, ms = _tiny_vit()
    engine = InferenceEngine(
        model, params, ms, device="cpu", model_name="vit_tight",
        image_shape=IMAGE_SHAPE, max_bucket=8,
        seq_grid=default_seq_grid(IMAGE_SHAPE, 4),
        memory_budget_bytes=_weight_bytes(params) + headroom)
    with pytest.raises(ServeMemoryBudgetError,
                       match="even alone" if headroom == 1 else "does not"):
        engine.prewarm()


def test_live_traffic_evicts_instead_of_refusing(monkeypatch):
    """Room for two cells: prewarming two buckets fits; traffic in a third
    evicts the least recently used cell, which then runs as a miss
    again."""
    _sized_cells(monkeypatch, 1000)
    bundle = load_for_serving("mlp_mnist", "cpu")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=4)
    eng.cache.set_budget(_weight_bytes(bundle.params) + 2000,
                         base_bytes=_weight_bytes(bundle.params))
    assert eng.prewarm([1, 2]) == 2
    eng.predict(make_images(MNIST, seed=1, n=2))  # bucket 2: a hit
    eng.predict(make_images(MNIST, seed=1, n=3))  # bucket 4 evicts 1
    assert eng.cache.evictions == 1 and eng.misses == 3
    eng.predict(make_images(MNIST, seed=1, n=1))  # bucket 1 runs again
    assert eng.misses == 4


def test_weights_over_budget_refused_at_construction():
    model, params, ms = _tiny_vit()
    with pytest.raises(ServeMemoryBudgetError, match="weights alone"):
        InferenceEngine(model, params, ms, device="cpu",
                        model_name="vit_nofit", image_shape=IMAGE_SHAPE,
                        max_bucket=8, memory_budget_bytes=16)


@pytest.mark.parametrize("budget_mb,refused", [(0.1, True), (8.0, False)])
def test_build_zoo_engine_takes_the_budget_and_a_store(tmp_path, budget_mb,
                                                  refused):
    """`build_zoo_engine`'s `memory_budget_mb` refuses only over its
    bound (the MLP's float weights are 318,040 B), and `store` (the
    kernel-library store) rides the engine's cache into its stats."""
    from dist_mnist_tpu_torch.compilecache.store import ExecutableStore

    bundle = load_for_serving("mlp_mnist", "cpu")
    store = ExecutableStore(tmp_path / "kernels")
    if refused:
        with pytest.raises(ServeMemoryBudgetError, match="weights alone"):
            build_zoo_engine(bundle, "cpu", model_name="mlp",
                             memory_budget_mb=budget_mb, store=store)
        return
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=4,
                           memory_budget_mb=budget_mb, store=store)
    assert eng.prewarm() == 3
    stats = eng.cache.stats()
    assert stats["budget_bytes"] == int(budget_mb * 2**20)
    assert stats["resident_bytes_weights"] == 318_040
    assert stats["store"]["builds"] == 0  # no kernel builds on the CPU


def test_shared_cache_warms_a_later_replica_without_misses():
    """Replicas of one model share one cache: the first runs each cell
    once, a replica added later finds every cell warm (hits, no miss),
    and a cell's first run is journaled once."""
    bundle = load_for_serving("mlp_mnist", "cpu")
    cache = CompiledModelCache()
    first = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=8,
                             cache=cache)
    assert first.prewarm() == 4
    later = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=8,
                             cache=cache)
    assert later.prewarm() == 0
    stats = cache.stats()
    assert (stats["misses"], stats["hits_memory"]) == (4, 4)
    later.predict(make_images(MNIST, seed=1, n=8))
    assert cache.stats()["misses"] == 4
    assert later.cache_stats()["per_bucket"] == {"8": 1}


def test_async_prewarm_warms_grid_in_background_and_joins():
    model, params, ms = _tiny_vit()
    engine = InferenceEngine(
        model, params, ms, device="cpu", model_name="vit_async",
        image_shape=IMAGE_SHAPE, max_bucket=8,
        seq_grid=default_seq_grid(IMAGE_SHAPE, 4))
    server = InferenceServer(engine, ServeConfig(
        max_batch=8, max_wait_ms=1.0, queue_depth=32, prewarm_async=True))
    with server:
        # serving is live at once; a request may pay its own first run
        fut = server.submit(_images(1, h=16)[0])
        assert fut.result(timeout=60.0).logits.shape == (10,)
        deadline = time.monotonic() + 60.0
        want = len(engine.buckets()) * (1 + len(engine.seq_grid.heights))
        while engine.cache.stats()["entries"] < want:
            assert time.monotonic() < deadline, "background prewarm stalled"
            time.sleep(0.05)
    # close() joined the ZooPrewarm thread (the suite's leak check would
    # fail this test otherwise); no refusal was recorded
    assert "prewarm_error" not in server.stats()


def test_roll_weights_rewarm_retouches_grid_without_first_runs():
    """A zoo replica (the 2-D grid) rolled through the router: the
    rewarm walks every cell as a memory hit, and short and native
    requests serve on the new weights."""
    from dist_mnist_tpu_torch.serve import (
        InProcessReplica,
        Router,
        RouterConfig,
    )

    model, params, ms = _tiny_vit()
    cache = CompiledModelCache()

    def make_server():
        engine = InferenceEngine(
            model, params, ms, device="cpu", model_name="vit_roll",
            image_shape=IMAGE_SHAPE, max_bucket=4, cache=cache,
            seq_grid=default_seq_grid(IMAGE_SHAPE, 4))
        return InferenceServer(engine, ServeConfig(
            max_batch=4, max_wait_ms=1.0, queue_depth=32)).start()

    def load_weights(step):
        return tree_map(lambda p: p + 1.0, params), ms

    replica = InProcessReplica(0, make_server,
                               load_weights=load_weights).start()
    router = Router([replica], RouterConfig(health_interval_s=0.05)).start()
    try:
        misses_warm = cache.stats()["misses"]
        res = router.roll_weights(9)
        assert not res["failed"]
        eng = replica.server.engine
        assert eng.weights_version == 9
        assert cache.stats()["misses"] == misses_warm
        for h in (8, 16):
            fut = router.submit(_images(1, h=h, seed=4)[0])
            assert fut.result(timeout=30.0).logits.shape == (10,)
    finally:
        router.close()
        replica.close()


# -- the entry points ----------------------------------------------------------

def _router_args(*argv):
    return router_cli.build_parser().parse_args(
        ["--device=cpu", "--max_batch=8", "--health_interval_s=0.05",
         *argv])


def _commit(ckpt, step, shift=0.0):
    state, mgr = bench._fleet_checkpoint(torch.device("cpu"), str(ckpt),
                                         step)
    if shift:
        import dataclasses

        mgr.save(dataclasses.replace(
            state, step=torch.tensor(step, dtype=torch.int32),
            params=tree_map(lambda p: p + shift, state.params)))
        mgr.wait()
    mgr.close()
    return state


def test_cli_router_in_process_int8_rolls_and_serves(tmp_path):
    """`cli.router`'s default shape, int8 with `--watch`: the fleet boots
    on step 100, a commit of step 200 rolls it (re-quantized), every
    request of both classes is served, and each replica then answers a
    fresh int8 step-200 engine's logits bit for bit."""
    ckpt = tmp_path / "ckpt"
    state = _commit(ckpt, bench.FLEET_BASE_STEP)
    args = _router_args(
        "--quant=int8", "--watch", "--watch_interval_s=0.05",
        f"--checkpoint_dir={ckpt}", "--replicas=2", "--requests=96",
        "--concurrency=8")
    images = make_images(MNIST, seed=9, n=8)
    seen = {}

    def on_router(router, replicas):
        import dataclasses

        from dist_mnist_tpu_torch.checkpoint.manager import (
            CheckpointManager,
        )

        mgr = CheckpointManager(str(ckpt), async_save=False)
        mgr.save(dataclasses.replace(
            state, step=torch.tensor(bench.FLEET_NEW_STEP,
                                     dtype=torch.int32),
            params=tree_map(lambda p: p + 1.0, state.params)))
        mgr.wait()
        mgr.close()

    def on_done(router, replicas, summary):
        deadline = time.monotonic() + 30
        while router.serving_step != bench.FLEET_NEW_STEP:
            assert time.monotonic() < deadline, "the roll never completed"
            time.sleep(0.02)
        seen["logits"] = [r.server.engine.predict(images) for r in replicas]
        seen["versions"] = [r.server.engine.weights_version
                            for r in replicas]

    summary = router_cli.run(args, on_router=on_router, on_done=on_done)
    assert summary["total_ok"] == 96 and summary["quant"] == "int8"
    assert sum(summary["errors"].values()) == 0
    assert sum(summary["dropped"].values()) == 0
    assert summary["cache"]["misses"] == 4  # buckets 1..8, once for both
    assert seen["versions"] == [bench.FLEET_NEW_STEP] * 2
    bundle = load_for_serving("mlp_mnist", "cpu", quant="int8",
                              checkpoint_dir=str(ckpt),
                              step=bench.FLEET_NEW_STEP)
    fresh = InferenceEngine(bundle.model, bundle.params, bundle.model_state,
                            device="cpu", image_shape=MNIST, max_bucket=8)
    want = fresh.predict(images)
    for got in seen["logits"]:
        np.testing.assert_array_equal(got, want)


def test_cli_router_http_replicas_swap_and_answer_bit_for_bit(tmp_path):
    """`--noinprocess`: two `cli.serve --serve_forever --quant=int8`
    children booted on step 100; one roll to step 200 through the router
    (POST /swap); the router's /metrics merges both replicas' series; a
    POST /predict answers the in-process int8 engine's logits for the
    same image and weights bit for bit; the children exit on SIGTERM."""
    from urllib.request import urlopen

    ckpt = tmp_path / "ckpt"
    _commit(ckpt, bench.FLEET_BASE_STEP)
    _commit(ckpt, bench.FLEET_NEW_STEP, shift=1.0)
    port = router_cli._free_port()
    args = _router_args(
        "--quant=int8", "--noinprocess", f"--checkpoint_dir={ckpt}",
        f"--step={bench.FLEET_BASE_STEP}", "--replicas=2",
        "--requests=32", "--concurrency=4", f"--metrics_port={port}")
    image = make_images(MNIST, seed=5, n=1)[0]
    seen = {}

    def on_router(router, replicas):
        seen["roll"] = router.roll_weights(bench.FLEET_NEW_STEP)

    def on_done(router, replicas, summary):
        deadline = time.monotonic() + 20
        while True:
            text = urlopen(f"http://127.0.0.1:{port}/metrics",
                           timeout=10).read().decode()
            count = [float(ln.split()[-1]) for ln in text.splitlines()
                     if ln.startswith("fleet_serve_latency_ms_count")]
            if count and count[0] >= 32 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        seen["metrics"] = text
        seen["logits"] = [r.submit(image).result(timeout=30).logits
                          for r in replicas]
        seen["procs"] = list(router_cli._LIVE_REPLICA_PROCS)

    summary = router_cli.run(args, on_router=on_router, on_done=on_done)
    assert summary["total_ok"] == 32 and summary["inprocess"] is False
    assert seen["roll"] == {"step": bench.FLEET_NEW_STEP, "swapped": [0, 1],
                            "failed": []}
    for host in (0, 1):
        assert f'fleet_host_up{{host="{host}"}} 1' in seen["metrics"]
    count = [ln for ln in seen["metrics"].splitlines()
             if ln.startswith("fleet_serve_latency_ms_count")]
    assert count and float(count[0].split()[-1]) >= 32
    bundle = load_for_serving("mlp_mnist", "cpu", quant="int8",
                              checkpoint_dir=str(ckpt),
                              step=bench.FLEET_NEW_STEP)
    fresh = InferenceEngine(bundle.model, bundle.params, bundle.model_state,
                            device="cpu", image_shape=MNIST, max_bucket=8)
    want = fresh.predict(image[None])[0]
    for got in seen["logits"]:
        np.testing.assert_array_equal(got, want)
    assert [p.returncode for p in seen["procs"]] == [0, 0]


def test_cli_router_refuses_what_the_reference_refuses(tmp_path):
    with pytest.raises(SystemExit, match="--autoscale requires"):
        router_cli.run(_router_args("--autoscale", "--noinprocess"))
    with pytest.raises(SystemExit, match="--watch requires"):
        router_cli.run(_router_args("--watch"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        router_cli.main(["--requests=1"]) if not torch.cuda.is_available() \
            else pytest.skip("a CUDA device is present")


def test_cli_serve_forever_needs_metrics_port():
    from dist_mnist_tpu_torch.cli import serve as serve_cli

    with pytest.raises(SystemExit, match="--metrics_port"):
        serve_cli.main(["--serve_forever", "--device=cpu"])


def test_bench_serve_fleet_prints_its_line_and_holds_its_gates(capsys):
    """`bench --serve --fleet` on the CPU: the reference's plan (replica 0
    stalls, replica 1 dies), seeds and roll, and its gates (zero LS
    errors or sheds, nothing dropped, a replica down with its recovery,
    >= 2 swaps, every serving replica on step 200)."""
    records = bench.main(["--serve", "--fleet", "--device=cpu",
                          "--requests=128", "--concurrency=16"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == records[0]
    assert rec["metric"] == "fleet_p99_latency_sensitive_ms"
    extra = rec["extra"]
    assert extra["serving_step"] == bench.FLEET_NEW_STEP
    assert extra["swaps"] >= 2 and extra["recovery_ms"] > 0
    assert [r["replica"] for r in extra["roll_ms"]] == [0, 2]
    assert all({"drain_ms", "swap_ms", "rewarm_ms"} <= set(r)
               for r in extra["roll_ms"])


def test_bench_serve_autoscale_prints_its_line_and_holds_its_gates(capsys):
    """`bench --serve --autoscale` on the CPU: the reference's seeded 10x
    flash crowd, paced replicas, its gates (>= 1 scale-up, every one with
    zero cache misses and under 1 ms of first runs, LS p99 within the
    SLO, autoscaled strictly cheaper than static)."""
    records = bench.main(["--serve", "--autoscale", "--device=cpu"])
    rec = records[0]
    assert rec["metric"] == "chip_seconds_per_1k_ok"
    assert rec["vs_baseline"] > 1.0
    warm = rec["extra"]["warm_start"]
    assert warm["cache_misses"] and set(warm["cache_misses"]) == {0}
    assert rec["extra"]["trace"]["arrivals"] == 1031


def test_bench_serve_modes_run_one_at_a_time():
    with pytest.raises(SystemExit, match="one serving mode"):
        bench.main(["--serve", "--fleet", "--autoscale", "--device=cpu"])
    with pytest.raises(SystemExit, match="takes --serve"):
        bench.main(["--fleet", "--device=cpu"])
