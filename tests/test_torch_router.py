"""The port's fleet router against the reference's (`serve/router.py`).

The reference's tests/test_router.py, ported to the port's modules: the
error taxonomy pins, tiered shedding, retry/failover/hedging, drain
integration, zero-downtime weight rolls, the commit-marker watcher, the
fleet load generator, and the HTTP replica transport. Policy tests run
against a scripted fake replica; lifecycle and swap tests run a real
fleet of port engines on the CPU (`device="cpu"`) with one shared cell
cache.
"""

from __future__ import annotations

import contextlib
import tempfile
import threading
import time
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest

from dist_mnist_tpu_torch.faults import Fault, FaultPlan
from dist_mnist_tpu_torch.obs import HealthState, MetricRegistry, RunJournal
from dist_mnist_tpu_torch.obs import events as events_mod
from dist_mnist_tpu_torch.serve import (
    BEST_EFFORT,
    LATENCY_SENSITIVE,
    AllReplicasDownError,
    CheckpointWatcher,
    CompiledModelCache,
    DeadlineExceededError,
    InferenceEngine,
    InferenceServer,
    InProcessReplica,
    QueueFullError,
    ReplicaKilledError,
    Router,
    RouterConfig,
    ServeConfig,
    ShedError,
    ShuttingDownError,
    classify_failure,
    load_for_serving,
    run_fleet_loadgen,
)
from dist_mnist_tpu_torch.serve.admission import InferenceResult
from dist_mnist_tpu_torch.serve.errors import REPLICA_FATAL, RETRYABLE, TERMINAL
from dist_mnist_tpu_torch.utils.tree import tree_map

IMAGE_SHAPE = (28, 28, 1)


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
    """Every port router and exporter a test starts is closed by its end
    (the suite's own check reads the reference's lists only)."""
    from dist_mnist_tpu_torch.obs import exporter as exporter_mod
    from dist_mnist_tpu_torch.serve import router as router_mod

    yield
    assert not router_mod._LIVE_ROUTERS
    assert not exporter_mod._LIVE_EXPORTERS


# -- shared real-fleet plumbing (one warmed cell set via the shared cache) --

@pytest.fixture(scope="module")
def bundle():
    return load_for_serving("mlp_mnist", "cpu")


@pytest.fixture(scope="module")
def shared_cache():
    return CompiledModelCache()


@pytest.fixture()
def make_fleet(bundle, shared_cache):
    """Factory for N started InProcessReplicas sharing one cell cache;
    everything it makes is closed at test end."""
    made: list = []

    def _make(n, *, plan=None, load_weights=None, queue_depth=64):
        def factory(rid):
            def make_server():
                eng = InferenceEngine(
                    bundle.model, bundle.params, bundle.model_state,
                    device="cpu", model_name="mlp",
                    image_shape=bundle.image_shape, max_bucket=8,
                    cache=shared_cache)
                if plan is not None:
                    eng = plan.wrap_engine(eng, replica_id=rid)
                return InferenceServer(
                    eng,
                    ServeConfig(max_batch=8, max_wait_ms=1.0,
                                queue_depth=queue_depth),
                    health=HealthState()).start()
            return make_server

        fleet = [InProcessReplica(i, factory(i), load_weights=load_weights)
                 .start() for i in range(n)]
        made.extend(fleet)
        return fleet

    yield _make
    for r in made:
        r.close()


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=IMAGE_SHAPE, dtype=np.uint8)


def wait_for(pred, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


@contextlib.contextmanager
def capture_journal(tmp_path):
    """Route ambient events.emit() into a JSONL file for the test."""
    path = tmp_path / "events.jsonl"
    journal = RunJournal(path)
    prev = events_mod.set_journal(journal)
    try:
        yield path
    finally:
        events_mod.set_journal(prev)
        journal.close()


def _kinds(path):
    return [e["event"] for e in events_mod.read_journal(path)]


# -- scripted replica for policy tests ---------------------------------------

class FakeReplica:
    """Deterministic replica double: completes submits immediately with a
    canned result, or with the next scripted exception; backlog inputs
    (queue_depth/capacity) are plain attributes the test sets."""

    def __init__(self, rid, *, depth=0, cap=10):
        self.id = rid
        self.generation = 0
        self.depth = depth
        self.cap = cap
        self.state = "serving"
        self.fail_with: list = []  # popped per submit; empty = succeed
        self.hang = False  # leave the attempt future unresolved
        self.submits = 0

    def submit(self, image, *, deadline_ms=None, cancel_event=None):
        self.submits += 1
        fut: Future = Future()
        if self.hang:
            return fut
        if self.fail_with:
            fut.set_exception(self.fail_with.pop(0))
        else:
            fut.set_result(InferenceResult(
                logits=np.zeros(10, np.float32), label=0, latency_ms=0.1))
        return fut

    @property
    def queue_depth(self):
        return self.depth

    @property
    def capacity(self):
        return self.cap

    def probe(self):
        return {"state": self.state, "healthy": self.state == "serving",
                "generation": self.generation}

    def quiesce(self, timeout=30.0):
        return True

    def swap_to(self, step):
        pass

    def rewarm(self):
        return 0.0

    def close(self, timeout=30.0):
        return True


FAST = RouterConfig(health_interval_s=0.02, retry_base_ms=1.0,
                    retry_max_ms=5.0)


# -- error taxonomy pins ------------------------------------------------------

def test_classify_failure_is_type_first():
    # the message says "queue full" but the TYPE is unrecognized -> the
    # generic transient clause, never the admission-pushback one (no
    # string matching anywhere in the classifier)
    assert classify_failure(ValueError("queue full at capacity")) == RETRYABLE
    # a TimeoutError IS an OSError since 3.10: the deadline must classify
    # as a dead REQUEST before the connection clause calls it a dead REPLICA
    assert isinstance(DeadlineExceededError("x"), OSError)
    assert classify_failure(DeadlineExceededError("x")) == TERMINAL
    assert classify_failure(CancelledError()) == TERMINAL
    assert classify_failure(ShedError("x")) == TERMINAL
    assert classify_failure(AllReplicasDownError("x")) == TERMINAL
    assert classify_failure(QueueFullError("x")) == RETRYABLE
    assert classify_failure(ShuttingDownError("x")) == RETRYABLE
    assert classify_failure(RuntimeError("injected")) == RETRYABLE
    assert classify_failure(ReplicaKilledError("x")) == REPLICA_FATAL
    assert classify_failure(ConnectionRefusedError("x")) == REPLICA_FATAL
    assert classify_failure(BrokenPipeError("x")) == REPLICA_FATAL


# -- tiered shedding (scripted backlog) ---------------------------------------

def test_best_effort_sheds_before_latency_sensitive(tmp_path):
    with capture_journal(tmp_path) as jpath:
        fake = FakeReplica(0, depth=6, cap=10)  # backlog 0.6
        with Router([fake], FAST) as router:
            with pytest.raises(ShedError, match="backlog"):
                router.submit(_image(), request_class=BEST_EFFORT)
            # same backlog, the expensive tier still gets through
            res = router.submit(
                _image(), request_class=LATENCY_SENSITIVE).result(timeout=5)
            assert res.label == 0
            snap = router.metrics.snapshot()
            assert snap["shed"] == {BEST_EFFORT: 1, LATENCY_SENSITIVE: 0}
    assert "shed" in _kinds(jpath)


def test_latency_sensitive_sheds_only_when_full():
    fake = FakeReplica(0, depth=10, cap=10)  # backlog 1.0: every queue full
    with Router([fake], FAST) as router:
        with pytest.raises(ShedError):
            router.submit(_image(), request_class=LATENCY_SENSITIVE)
        assert fake.submits == 0  # shed at the router, not a replica queue


def test_hopeless_best_effort_deadline_sheds_under_pressure():
    fake = FakeReplica(0, depth=3, cap=10)  # 0.3 >= deadline_guard_at
    with Router([fake], FAST) as router:
        for _ in range(20):  # observed latency ~100ms
            router.metrics.latency_ms[LATENCY_SENSITIVE].observe(100.0)
        with pytest.raises(ShedError, match="deadline_hopeless"):
            router.submit(_image(), request_class=BEST_EFFORT, deadline_ms=5)
        # a generous deadline at the same backlog is fine
        router.submit(_image(), request_class=BEST_EFFORT,
                      deadline_ms=5000).result(timeout=5)
        # and the guard never applies to latency_sensitive
        router.submit(_image(), request_class=LATENCY_SENSITIVE,
                      deadline_ms=5).result(timeout=5)


def test_submit_validates_class_and_shutdown():
    fake = FakeReplica(0)
    router = Router([fake], FAST).start()
    try:
        with pytest.raises(ValueError, match="request class"):
            router.submit(_image(), request_class="bulk")
    finally:
        router.close()
    with pytest.raises(ShuttingDownError):
        router.submit(_image())


# -- retry / failover / hedging (scripted) ------------------------------------

def test_transient_errors_retry_with_backoff():
    fake = FakeReplica(0)
    fake.fail_with = [RuntimeError("flaky"), RuntimeError("flaky")]
    with Router([fake], FAST) as router:
        res = router.submit(_image()).result(timeout=5)
        assert res.label == 0
        snap = router.metrics.snapshot()
        assert snap["retries"] == 2
        assert fake.submits == 3


def test_replica_fatal_requeues_then_all_down(tmp_path):
    with capture_journal(tmp_path) as jpath:
        fakes = [FakeReplica(0), FakeReplica(1)]
        for f in fakes:
            f.fail_with = [ReplicaKilledError("boom")] * 8
        with Router(fakes, FAST) as router:
            fut = router.submit(_image())
            with pytest.raises(AllReplicasDownError):
                fut.result(timeout=5)
            snap = router.metrics.snapshot()
            assert snap["replica_downs"] == 2
            assert snap["requeues"] == 2  # one failover hop per replica
            assert router.replica_states() == {0: "down", 1: "down"}
            # probes say "serving" but the generation never moved: the
            # router must NOT re-admit a dead engine behind a live probe
            time.sleep(0.1)
            assert router.replica_states() == {0: "down", 1: "down"}
            # a restart (generation bump) is what clears the mark
            fakes[0].fail_with = []
            fakes[0].generation = 1
            assert wait_for(lambda: router.replica_states()[0] == "serving")
            assert router.metrics.snapshot()["replica_ups"] == 1
    assert "replica_down" in _kinds(jpath)
    assert "replica_up" in _kinds(jpath)


def test_router_close_fails_outstanding_flights():
    fake = FakeReplica(0)
    fake.hang = True
    router = Router([fake], FAST).start()
    fut = router.submit(_image())
    router.close()
    with pytest.raises(ShuttingDownError):
        fut.result(timeout=1)


def test_hedge_timeout_derivation():
    fake = FakeReplica(0)
    with Router([fake], RouterConfig(health_interval_s=0.02,
                                     hedge_after_ms=40.0)) as router:
        assert router._hedge_after_ms() == 40.0
    with Router([fake], FAST) as router:
        assert router._hedge_after_ms() is None  # no samples yet
        for _ in range(FAST.hedge_min_samples):
            router.metrics.latency_ms[LATENCY_SENSITIVE].observe(1.0)
        # derived from the live p99, never below the floor
        assert router._hedge_after_ms() == FAST.hedge_floor_ms


# -- real fleet: failover, hedging, drain -------------------------------------

def test_replica_kill_failover_completes_every_request(make_fleet, tmp_path):
    plan = FaultPlan([Fault.serve_replica_kill(replica=0, request=0)])
    with capture_journal(tmp_path) as jpath:
        fleet = make_fleet(2, plan=plan)
        with Router(fleet, FAST) as router:
            futs = [router.submit(_image(i)) for i in range(12)]
            results = [f.result(timeout=30) for f in futs]
            assert all(r.logits.shape == (10,) for r in results)
            snap = router.metrics.snapshot()
            assert snap["replica_downs"] == 1
            assert snap["requeues"] >= 1
            assert snap["failed"] == {LATENCY_SENSITIVE: 0, BEST_EFFORT: 0}
            assert len(snap["recovery_ms"]) == 1  # down -> first reroute
            assert router.replica_states()[0] == "down"
            # restart rebuilds the whole replica; the shared cache keeps it
            # free of first runs and the health loop re-admits it
            fleet[0].restart()
            assert wait_for(
                lambda: router.replica_states()[0] == "serving", timeout=10)
            router.submit(_image()).result(timeout=30)
    kinds = _kinds(jpath)
    for expected in ("replica_down", "request_requeued",
                     "failover_first_response", "replica_up"):
        assert expected in kinds, kinds


def test_stalled_replica_is_hedged_around(make_fleet, tmp_path):
    plan = FaultPlan([Fault.serve_replica_stall(replica=0, seconds=0.5,
                                                request=0)])
    with capture_journal(tmp_path) as jpath:
        fleet = make_fleet(2, plan=plan)
        cfg = RouterConfig(health_interval_s=0.02, hedge_after_ms=30.0)
        with Router(fleet, cfg) as router:
            res = router.submit(
                _image(), request_class=LATENCY_SENSITIVE).result(timeout=30)
            # the hedge (fires at 30ms) beats the 500ms stall
            assert res.latency_ms < 450
            assert router.metrics.snapshot()["hedges"] == 1
            # let the stalled loser finish so close() isn't racing it
            assert wait_for(
                lambda: fleet[0].server.queue_depth == 0
                and fleet[0].server.metrics.inflight == 0, timeout=5)
    assert "request_hedged" in _kinds(jpath)


def test_draining_replica_stops_receiving_new_work(make_fleet, tmp_path):
    with capture_journal(tmp_path) as jpath:
        fleet = make_fleet(2)
        with Router(fleet, FAST) as router:
            fleet[0].server.health.set("draining")
            assert wait_for(
                lambda: router.replica_states()[0] == "draining")
            admitted_before = fleet[0].server.metrics.snapshot()["admitted"]
            for i in range(6):
                router.submit(_image(i)).result(timeout=30)
            assert (fleet[0].server.metrics.snapshot()["admitted"]
                    == admitted_before)
            fleet[0].server.health.set("serving")
            assert wait_for(
                lambda: router.replica_states()[0] == "serving")
            snap = router.metrics.snapshot()
            assert snap["replica_drains"] == 1
            assert snap["replica_ups"] == 1
    assert "replica_drain" in _kinds(jpath)


# -- zero-downtime weight hot-swap --------------------------------------------

def test_weight_roll_is_zero_downtime_and_reversible(
        make_fleet, bundle, tmp_path):
    orig = bundle.params
    shifted = tree_map(lambda a: a + 0.5, orig)

    def load_weights(step):
        return (shifted if step == 7 else orig), bundle.model_state

    probe = _image(42)
    with capture_journal(tmp_path) as jpath:
        fleet = make_fleet(2, load_weights=load_weights)
        with Router(fleet, FAST) as router:
            logits_old = router.submit(probe).result(timeout=30).logits

            # requests in flight THROUGH the roll: none may drop, and each
            # must see a coherent weight set (pre- or post-swap, never torn)
            inflight_results: list = []
            stop = threading.Event()

            def pump():
                while not stop.is_set():
                    inflight_results.append(
                        router.submit(probe).result(timeout=30).logits)

            t = threading.Thread(target=pump, name="swap-pump")
            t.start()
            try:
                roll = router.roll_weights(7)
            finally:
                stop.set()
                t.join(timeout=60)
            assert not t.is_alive()
            assert roll == {"step": 7, "swapped": [0, 1], "failed": []}
            assert router.serving_step == 7
            assert all(r.server.engine.weights_version == 7 for r in fleet)

            logits_new = router.submit(probe).result(timeout=30).logits
            assert not np.allclose(logits_old, logits_new, atol=1e-3)
            assert inflight_results  # the pump made progress during the roll
            for got in inflight_results:
                assert (np.allclose(got, logits_old, atol=1e-4)
                        or np.allclose(got, logits_new, atol=1e-4)), \
                    "a request observed torn weights"

            # roll back to the original weights: same cell, same
            # batch composition -> bit-exact with the pre-swap answer
            assert router.roll_weights(8)["swapped"] == [0, 1]
            logits_back = router.submit(probe).result(timeout=30).logits
            np.testing.assert_array_equal(logits_back, logits_old)
    swaps = [e for e in events_mod.read_journal(jpath)
             if e["event"] == "weights_swap"]
    assert len(swaps) == 4 and all(e["ok"] for e in swaps)


def test_failed_swap_keeps_replica_on_old_weights(make_fleet, tmp_path):
    def load_weights(step):
        raise FileNotFoundError(f"no committed checkpoint at step {step}")

    probe = _image(43)
    with capture_journal(tmp_path) as jpath:
        fleet = make_fleet(1, load_weights=load_weights)
        with Router(fleet, FAST) as router:
            before = router.submit(probe).result(timeout=30).logits
            roll = router.roll_weights(9)
            assert roll["swapped"] == []
            assert roll["failed"][0]["replica"] == 0
            assert "FileNotFoundError" in roll["failed"][0]["reason"]
            assert router.serving_step is None
            # the replica is still serving its old weights, not wedged
            assert router.replica_states()[0] == "serving"
            assert fleet[0].server.engine.weights_version == 0
            after = router.submit(probe).result(timeout=30).logits
            np.testing.assert_array_equal(before, after)
            assert router.metrics.snapshot()["swap_failures"] == 1
    bad = [e for e in events_mod.read_journal(jpath)
           if e["event"] == "weights_swap"]
    assert bad and not bad[0]["ok"]


# -- commit-marker watcher ----------------------------------------------------

def test_checkpoint_watcher_follows_commit_markers(tmp_path):
    rolled: list = []
    w = CheckpointWatcher(tmp_path, rolled.append, initial_step=None)
    assert w.latest_committed() is None  # no commits dir yet
    commits = tmp_path / "commits"
    commits.mkdir()
    (commits / "not-a-step.committed").touch()  # strays are skipped
    assert w.poll_once() is None
    (commits / "5.committed").touch()
    assert w.poll_once() == 5
    (commits / "3.committed").touch()  # older than what we serve: ignored
    assert w.poll_once() is None
    (commits / "10.committed").touch()
    assert w.poll_once() == 10
    assert rolled == [5, 10]
    assert w.polls == 4 and w.rolls == 2


def test_checkpoint_watcher_consumes_a_failed_roll(tmp_path):
    calls: list = []

    def on_new_step(step):
        calls.append(step)
        if step == 20:
            raise RuntimeError("bad checkpoint")

    commits = tmp_path / "commits"
    commits.mkdir()
    w = CheckpointWatcher(tmp_path, on_new_step, initial_step=10)
    (commits / "10.committed").touch()
    assert w.poll_once() is None  # initial_step already served
    (commits / "20.committed").touch()
    assert w.poll_once() is None  # roll failed...
    assert w.poll_once() is None  # ...and is NOT retried every poll
    (commits / "30.committed").touch()
    assert w.poll_once() == 30  # the next commit retriggers naturally
    assert calls == [20, 30]


def test_watcher_drives_router_roll(make_fleet, bundle, tmp_path):
    shifted = tree_map(lambda a: a + 0.25, bundle.params)
    fleet = make_fleet(1, load_weights=lambda step: (shifted,
                                                    bundle.model_state))
    with Router(fleet, FAST) as router:
        w = CheckpointWatcher(tmp_path, router.roll_weights, initial_step=0)
        commits = tmp_path / "commits"
        commits.mkdir()
        (commits / "7.committed").touch()
        assert w.poll_once() == 7
        assert router.serving_step == 7
        assert fleet[0].server.engine.weights_version == 7


# -- fleet load generator -----------------------------------------------------

def test_fleet_loadgen_accounting_is_deterministic(make_fleet):
    fleet = make_fleet(2)
    with Router(fleet, FAST) as router:
        summary = run_fleet_loadgen(
            router, n_requests=40, concurrency=8,
            image_shape=IMAGE_SHAPE, seed=7, ls_fraction=0.5)
    n_ls = int((np.random.default_rng(7).random(40) < 0.5).sum())
    assert summary["offered"] == {LATENCY_SENSITIVE: n_ls,
                                  BEST_EFFORT: 40 - n_ls}
    assert summary["ok"] == summary["offered"]  # healthy fleet: all served
    assert summary["total_ok"] == 40
    for cls in (LATENCY_SENSITIVE, BEST_EFFORT):
        assert summary[f"latency_{cls}"]["p99_ms"] > 0
        assert summary["errors"][cls] == 0
        assert summary["dropped"][cls] == 0
    assert summary["router"]["completed"] == summary["ok"]
    # both replicas carried traffic (least-loaded spreading)
    assert all(r.server.metrics.snapshot()["admitted"] > 0 for r in fleet)


# -- HTTP replica transport ---------------------------------------------------

def test_http_replica_roundtrip_and_error_mapping():
    from dist_mnist_tpu_torch.obs import MetricsExporter
    from dist_mnist_tpu_torch.serve.router import HttpReplica

    seen: dict = {}
    fail: list = []

    def predict_fn(image, deadline_ms):
        seen["shape"] = image.shape
        seen["deadline_ms"] = deadline_ms
        if fail:
            raise fail.pop(0)
        return InferenceResult(logits=np.arange(10, dtype=np.float32),
                               label=3, latency_ms=1.0)

    def swap_fn(step):
        seen["swap"] = step
        return {"swapped": True, "step": step}

    exporter = MetricsExporter(
        MetricRegistry(), health=HealthState("serving"),
        predict_fn=predict_fn, swap_fn=swap_fn).start()
    replica = HttpReplica(0, f"http://127.0.0.1:{exporter.port}")
    try:
        res = replica.submit(_image(), deadline_ms=250.0).result(timeout=10)
        assert res.label == 3
        np.testing.assert_array_equal(
            res.logits, np.arange(10, dtype=np.float32))
        assert seen["shape"] == IMAGE_SHAPE
        assert seen["deadline_ms"] == 250.0

        snap = replica.probe()
        assert snap == {"state": "serving", "healthy": True, "generation": 0}

        # the typed statuses come back as the SAME exception types, so
        # classify_failure treats a remote replica exactly like a local one
        for sent, expect in ((QueueFullError("full"), QueueFullError),
                             (ShuttingDownError("bye"), ShuttingDownError),
                             (DeadlineExceededError("late"),
                              DeadlineExceededError)):
            fail.append(sent)
            with pytest.raises(expect):
                replica.submit(_image()).result(timeout=10)
        fail.append(ReplicaKilledError("dead engine"))
        with pytest.raises(ReplicaKilledError):
            replica.submit(_image()).result(timeout=10)

        replica.swap_to(12)
        assert seen["swap"] == 12
    finally:
        replica.close()
        exporter.close()
    # a closed exporter reads as a stopped replica, not an exception
    assert replica.probe()["state"] == "stopped"
