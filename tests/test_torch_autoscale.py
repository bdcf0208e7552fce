"""The port's autoscaler against the reference's (`serve/autoscale.py`
and the trace generators of `serve/loadgen.py`).

The reference's tests/test_autoscale.py, ported to the port's modules:
trace-generator determinism and rate-envelope pins, the ScalePolicy
unit matrix (up-triggers, down-hysteresis, cooldowns, min/max clamps,
no-flap), FleetSignalSource merging, the Autoscaler actuation loop
driven through tick() against stubbed routers and sources (no replicas),
and the Router's add/remove_replica seam against a scripted replica.
Then the two packages side by side on seeded inputs: the three traces'
arrival times bit for bit, and ScalePolicy's decisions over one canned
signal sequence on a fake clock, decision for decision.
"""

from __future__ import annotations

import contextlib
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from dist_mnist_tpu.serve import autoscale as jautoscale
from dist_mnist_tpu.serve import loadgen as jloadgen
from dist_mnist_tpu_torch.obs import RunJournal
from dist_mnist_tpu_torch.obs import events as events_mod
from dist_mnist_tpu_torch.serve import (
    BEST_EFFORT,
    LATENCY_SENSITIVE,
    Autoscaler,
    FleetSignals,
    FleetSignalSource,
    PolicyState,
    Router,
    RouterConfig,
    ScalePolicy,
    ShuttingDownError,
    burst_trace,
    diurnal_trace,
    flash_crowd_trace,
)

FAST = RouterConfig(health_interval_s=0.02, retry_base_ms=1.0,
                    retry_max_ms=5.0)


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
def _no_router_leaks():
    """Every port router a test starts is closed by its end (the suite's
    own check reads the reference's router list only)."""
    from dist_mnist_tpu_torch.serve import router as router_mod

    yield
    assert not router_mod._LIVE_ROUTERS


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


# -- trace generators: determinism + rate-envelope pins -----------------------
#
# The generators place arrival k where the cumulative rate envelope crosses
# k + u_k (u_k a seeded uniform), so the arrival COUNT is floor(integral of
# the envelope) — a seed-independent closed form the tests pin exactly —
# while the exact offsets are seeded and byte-reproducible.


def test_trace_same_seed_is_byte_identical():
    a = flash_crowd_trace(duration_s=8.0, base_rps=5.0, spike_at_s=2.0,
                          spike_len_s=1.0, spike_mult=10.0, seed=7)
    b = flash_crowd_trace(duration_s=8.0, base_rps=5.0, spike_at_s=2.0,
                          spike_len_s=1.0, spike_mult=10.0, seed=7)
    assert a.tobytes() == b.tobytes()


def test_trace_seed_moves_offsets_not_count():
    a = diurnal_trace(duration_s=10.0, base_rps=5.0, peak_rps=15.0, seed=0)
    b = diurnal_trace(duration_s=10.0, base_rps=5.0, peak_rps=15.0, seed=1)
    assert len(a) == len(b)  # count is a pure function of the envelope
    assert a.tobytes() != b.tobytes()  # but the jitter really is seeded


def test_traces_sorted_and_bounded():
    for arr, dur in [
        (diurnal_trace(duration_s=10.0, base_rps=5.0, peak_rps=15.0), 10.0),
        (burst_trace(duration_s=40.0, base_rps=2.0, burst_rps=10.0,
                     burst_every_s=10.0, burst_len_s=1.0), 40.0),
        (flash_crowd_trace(duration_s=8.0, base_rps=5.0, spike_at_s=2.0,
                           spike_len_s=1.0), 8.0),
    ]:
        assert np.all(np.diff(arr) >= 0.0)
        assert arr[0] >= 0.0 and arr[-1] <= dur


def test_diurnal_rate_envelope_pin():
    # raised cosine, one period: integral = base*T + (peak-base)*T/2
    arr = diurnal_trace(duration_s=10.0, base_rps=5.0, peak_rps=15.0, seed=3)
    assert len(arr) == 100  # 5*10 + 10*10/2 = 100 exactly
    # crest half (middle) must carry more arrivals than the troughs
    mid = np.count_nonzero((arr >= 2.5) & (arr < 7.5))
    assert mid > len(arr) - mid


def test_burst_rate_envelope_pin():
    # 4 periods of (1s @ 10rps + 9s @ 2rps) = 4 * (10 + 18) = 112
    arr = burst_trace(duration_s=40.0, base_rps=2.0, burst_rps=10.0,
                      burst_every_s=10.0, burst_len_s=1.0, seed=0)
    assert abs(len(arr) - 112) <= 1  # trapezoid edges cost < 1 arrival
    in_burst = np.count_nonzero(np.mod(arr, 10.0) < 1.0)
    # 40 of ~112 arrivals land inside the 10% of time that is burst
    assert in_burst >= 35


def test_flash_crowd_rate_envelope_pin():
    # base 5rps * 8s = 40, spike (50-5)*1s = 45... total envelope:
    # 5*8 + 45*1 (plateau) + 45*2/2 (linear decay triangle) = 130
    arr = flash_crowd_trace(duration_s=8.0, base_rps=5.0, spike_at_s=2.0,
                            spike_len_s=1.0, spike_mult=10.0, decay_s=2.0,
                            seed=0)
    assert abs(len(arr) - 130) <= 1
    # the spike window itself runs at peak: ~50 arrivals in [2, 3)
    spike = np.count_nonzero((arr >= 2.0) & (arr < 3.0))
    assert abs(spike - 50) <= 2  # jitter can slide edge arrivals by < 1


# -- ScalePolicy unit matrix --------------------------------------------------


def sig(t, *, n=2, total=None, backlog=0.0, shed=0.0, p99=None):
    return FleetSignals(t=t, serving_replicas=n,
                        total_replicas=total if total is not None else n,
                        backlog_fraction=backlog, be_shed_rate=shed,
                        ls_p99_ms=p99)


def test_policy_up_triggers_and_priority():
    pol = ScalePolicy(min_replicas=1, max_replicas=8, slo_p99_ms=500.0)
    d = pol.decide(sig(0.0, shed=1.0), PolicyState())
    assert (d.action, d.reason, d.target_replicas) == ("up", "be_shedding", 3)
    d = pol.decide(sig(0.0, p99=350.0), PolicyState())
    assert (d.action, d.reason) == ("up", "ls_headroom_collapse")
    d = pol.decide(sig(0.0, backlog=0.5), PolicyState())
    assert (d.action, d.reason) == ("up", "backlog")
    # shedding outranks the other symptoms in the journaled reason
    d = pol.decide(sig(0.0, shed=1.0, p99=499.0, backlog=0.9), PolicyState())
    assert d.reason == "be_shedding"
    # a pre-traffic fleet has no LS p99 yet: None must not trigger
    d = pol.decide(sig(0.0, p99=None), PolicyState())
    assert d.action == "hold" and d.reason == "steady"


def test_policy_max_clamp_and_up_cooldown():
    pol = ScalePolicy(min_replicas=1, max_replicas=4, up_cooldown_s=2.0)
    assert pol.decide(sig(0.0, n=4, shed=5.0), PolicyState()).reason == "at_max"
    st = PolicyState(last_up_t=0.0)
    assert pol.decide(sig(1.9, shed=5.0), st).reason == "up_cooldown"
    assert pol.decide(sig(2.1, shed=5.0), st).action == "up"


def test_policy_down_needs_sustained_idle():
    pol = ScalePolicy(min_replicas=1, max_replicas=8, idle_window_s=5.0,
                      down_cooldown_s=0.0)
    st = PolicyState()
    assert pol.decide(sig(0.0, n=3), st).reason == "steady"  # idle starts
    assert pol.decide(sig(4.9, n=3), st).reason == "steady"  # not yet
    d = pol.decide(sig(5.0, n=3), st)
    assert (d.action, d.reason, d.target_replicas) == (
        "down", "sustained_idle", 2)


def test_policy_busy_sample_resets_idle_clock():
    pol = ScalePolicy(idle_window_s=5.0, down_cooldown_s=0.0)
    st = PolicyState()
    pol.decide(sig(0.0, n=3), st)
    # backlog 0.2: above idle_backlog but below backlog_up -> steady busy
    assert pol.decide(sig(3.0, n=3, backlog=0.2), st).reason == "steady"
    assert st.idle_since is None
    pol.decide(sig(4.0, n=3), st)  # idle clock restarts here
    assert pol.decide(sig(8.0, n=3), st).reason == "steady"
    assert pol.decide(sig(9.1, n=3), st).action == "down"


def test_policy_min_clamp_and_down_cooldowns():
    pol = ScalePolicy(min_replicas=2, idle_window_s=1.0, down_cooldown_s=10.0)
    st = PolicyState()
    pol.decide(sig(0.0, n=2), st)
    assert pol.decide(sig(2.0, n=2), st).reason == "at_min"
    # a recent down blocks the next one
    st = PolicyState(last_down_t=1.0)
    pol.decide(sig(0.0, n=4), st)
    assert pol.decide(sig(2.0, n=4), st).reason == "down_cooldown"
    # fresh capacity: a recent UP also blocks teardown
    st = PolicyState(last_up_t=1.0)
    pol.decide(sig(0.0, n=4), st)
    assert pol.decide(sig(2.0, n=4), st).reason == "down_cooldown"
    st = PolicyState(last_up_t=-100.0, last_down_t=-100.0)
    pol.decide(sig(0.0, n=4), st)
    assert pol.decide(sig(2.0, n=4), st).action == "down"


def test_policy_no_flap_under_oscillating_load():
    """Alternating busy/idle seconds: the idle window never fills, so the
    policy may grow the fleet (cooldown-paced) but NEVER tears it down."""
    pol = ScalePolicy(min_replicas=1, max_replicas=8, idle_window_s=5.0,
                      up_cooldown_s=2.0, down_cooldown_s=10.0)
    st = PolicyState()
    n = 2
    actions = []
    for t in range(60):
        busy = t % 2 == 0
        d = pol.decide(sig(float(t), n=n, shed=2.0 if busy else 0.0), st)
        actions.append((float(t), d.action))
        if d.action == "up":
            st.last_up_t = float(t)  # what the Autoscaler does on actuation
            n = min(n + 1, 8)
    assert all(a != "down" for _, a in actions)
    ups = [t for t, a in actions if a == "up"]
    assert ups, "oscillating shed should still grow the fleet"
    assert all(b - a >= pol.up_cooldown_s for a, b in zip(ups, ups[1:]))


def test_policy_validates_bounds():
    with pytest.raises(ValueError):
        ScalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        ScalePolicy(min_replicas=4, max_replicas=2)


# -- FleetSignalSource --------------------------------------------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class SourceRouterStub:
    """Just enough Router surface for FleetSignalSource: metrics with a
    BE shed counter + LS p99, replica states, and a backlog fallback."""

    def __init__(self):
        self.shed = 0
        self.p99 = None
        self.states = {0: "serving", 1: "serving"}
        self.backlog = 0.0
        stub = self

        class _Metrics:
            def snapshot(self):
                return {"shed": {BEST_EFFORT: stub.shed,
                                 LATENCY_SENSITIVE: 0}}

            def latency_pct(self, cls, pct):
                assert (cls, pct) == (LATENCY_SENSITIVE, "p99")
                return stub.p99

        self.metrics = _Metrics()

    def replica_states(self):
        return dict(self.states)

    def backlog_fraction(self):
        return self.backlog


def test_signal_source_shed_rate_is_a_delta():
    router = SourceRouterStub()
    clock = FakeClock()
    src = FleetSignalSource(router, clock=clock)
    assert src.signals().be_shed_rate == 0.0  # no previous sample yet
    router.shed += 10
    clock.advance(2.0)
    s = src.signals()
    assert s.be_shed_rate == pytest.approx(5.0)  # 10 sheds / 2s
    clock.advance(1.0)
    assert src.signals().be_shed_rate == 0.0  # counter flat again
    assert s.serving_replicas == 2 and s.total_replicas == 2


def test_signal_source_prefers_scraped_queue_depth():
    router = SourceRouterStub()
    router.backlog = 0.9  # the in-process fallback would say "saturated"
    scraper = SimpleNamespace(
        _lock=threading.Lock(),
        _hosts={"h0": SimpleNamespace(
            reachable=True,
            scalars={"serve_queue_depth": 30.0,
                     "serve_queue_capacity": 100.0})},
        snapshot=lambda: {"hosts": 1})
    src = FleetSignalSource(router, scraper=scraper, clock=FakeClock())
    assert src.signals().backlog_fraction == pytest.approx(0.3)
    # a scraper with no serve gauges yet falls back to the router's view
    scraper._hosts["h0"].scalars = {}
    assert src.signals().backlog_fraction == pytest.approx(0.9)


# -- Autoscaler actuation via tick() -----------------------------------------


class StubReplica:
    def __init__(self, rid):
        self.id = rid
        self.closed = False

    def close(self, timeout=30.0):
        self.closed = True
        return True


class ActuationRouterStub:
    """Membership-seam double: add_replica admits (or refuses), states are
    a plain dict, remove_replica pops and returns the handle."""

    def __init__(self, states=None, admit=True):
        self.states = dict(states if states is not None else {0: "serving"})
        self.handles = {rid: StubReplica(rid) for rid in self.states}
        self.admit = admit
        self.added: list = []
        self.removed: list = []

    def replica_states(self):
        return dict(self.states)

    def add_replica(self, replica, *, wait_serving_s=30.0,
                    probe_interval_s=0.05):
        self.added.append(replica.id)
        if self.admit:
            self.states[replica.id] = "serving"
            self.handles[replica.id] = replica
        return self.admit

    def remove_replica(self, rid, *, quiesce_timeout_s=30.0):
        del self.states[rid]  # KeyError on unknown, matching Router
        return self.handles.pop(rid)


class ScriptedSource:
    """Pops one canned FleetSignals per tick; repeats the last forever."""

    def __init__(self, script):
        self.script = list(script)

    def signals(self):
        return self.script.pop(0) if len(self.script) > 1 else self.script[0]


class StubCache:
    def __init__(self):
        self.s = {"compile_secs": 0.0, "misses": 0,
                  "hits_memory": 0, "hits_disk": 0}

    def stats(self):
        return dict(self.s)


def _spawn_factory(router, cache=None, compile_on_spawn=False):
    """spawn closure exercising the StartupClock contract the CLI/bench
    factories follow: engine build under restore, prewarm under compile."""

    def spawn(rid, startup):
        with startup.phase("restore"):
            replica = StubReplica(rid)
        with startup.phase("compile"):
            if compile_on_spawn and cache is not None:  # a cold cache
                cache.s["misses"] += 1
                cache.s["compile_secs"] += 0.25
            elif cache is not None:
                cache.s["hits_memory"] += 1
        return replica

    return spawn


def test_scale_up_actuates_and_journals_warm_start(tmp_path):
    router = ActuationRouterStub()
    cache = StubCache()
    pol = ScalePolicy(min_replicas=1, max_replicas=4)
    scaler = Autoscaler(router, ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        _spawn_factory(router, cache), policy=pol,
                        cache=cache, clock=FakeClock())
    with capture_journal(tmp_path) as path:
        d = scaler.tick()
    assert d.action == "up" and router.added == [1]
    assert scaler.scale_ups == 1 and scaler.failed_scale_ups == 0
    assert router.replica_states() == {0: "serving", 1: "serving"}
    kinds = _kinds(path)
    assert "autoscale_decision" in kinds and "replica_scale_up" in kinds
    [receipt] = scaler.history
    assert receipt["replica"] == 1 and receipt["reason"] == "be_shedding"
    # the warm-start promise, as numbers: the spawn hit the shared cache
    assert receipt["cache_misses"] == 0
    assert receipt["cache_compile_ms"] == 0.0
    assert receipt["cache_hits_memory"] == 1
    assert receipt["restore_ms"] >= 0.0 and receipt["compile_ms"] >= 0.0
    # the cooldown stamp lands even on success (attempt-paced)
    assert scaler.state.last_up_t == 0.0


def test_scale_up_cold_cache_shows_in_receipt():
    router = ActuationRouterStub()
    cache = StubCache()
    scaler = Autoscaler(router, ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        _spawn_factory(router, cache, compile_on_spawn=True),
                        cache=cache, clock=FakeClock())
    scaler.tick()
    [receipt] = scaler.history
    assert receipt["cache_misses"] == 1  # a compiling scale-up is VISIBLE
    assert receipt["cache_compile_ms"] == pytest.approx(250.0)


def test_failed_admission_reaps_and_counts():
    router = ActuationRouterStub(admit=False)
    reaped: list = []
    scaler = Autoscaler(router, ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        _spawn_factory(router), reap=reaped.append,
                        clock=FakeClock())
    d = scaler.tick()
    assert d.action == "up"  # the decision fired; the actuation failed
    assert scaler.failed_scale_ups == 1 and scaler.scale_ups == 0
    assert [r.id for r in reaped] == [1]
    assert scaler.history == []
    # the cooldown still stamps: a failing spawn is not retried per-tick
    assert scaler.state.last_up_t == 0.0


def test_failed_spawn_survives_and_counts():
    def spawn(rid, startup):
        raise RuntimeError("no capacity at the provider")

    router = ActuationRouterStub()
    scaler = Autoscaler(router, ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        spawn, clock=FakeClock())
    scaler.tick()  # must not raise
    assert scaler.failed_scale_ups == 1 and router.added == []


def test_scale_down_drains_highest_id_and_reaps(tmp_path):
    router = ActuationRouterStub(
        states={0: "serving", 1: "serving", 2: "serving"})
    reaped: list = []
    pol = ScalePolicy(min_replicas=1, max_replicas=4, idle_window_s=5.0,
                      down_cooldown_s=0.0)
    scaler = Autoscaler(
        router, ScriptedSource([sig(0.0, n=3), sig(6.0, n=3)]),
        _spawn_factory(router), reap=reaped.append, policy=pol,
        clock=FakeClock())
    with capture_journal(tmp_path) as path:
        assert scaler.tick().action == "hold"  # idle clock starts
        d = scaler.tick()
    assert d.action == "down"
    assert router.removed == [] and 2 not in router.replica_states()
    assert [r.id for r in reaped] == [2]  # victim = max serving id
    assert scaler.scale_downs == 1
    assert "replica_scale_down" in _kinds(path)
    assert scaler.history[-1]["replica"] == 2


def test_replica_ids_are_monotonic_never_reused():
    router = ActuationRouterStub(states={0: "serving", 1: "serving"})
    pol = ScalePolicy(min_replicas=1, max_replicas=8, up_cooldown_s=1.0)
    scaler = Autoscaler(
        router,
        ScriptedSource([sig(0.0, n=2, shed=2.0), sig(5.0, n=2, shed=2.0)]),
        _spawn_factory(router), policy=pol, clock=FakeClock())
    scaler.tick()
    assert router.added == [2]
    # the new replica dies and is removed out-of-band...
    router.remove_replica(2)
    scaler.tick()
    # ...but its id is never handed out again (2's down-generation and
    # recovery bookkeeping in the real router must not alias)
    assert router.added == [2, 3]


def test_tick_holds_while_resize_in_flight():
    router = ActuationRouterStub()
    scaler = Autoscaler(router, ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        _spawn_factory(router), clock=FakeClock())
    assert scaler._resizing.acquire(blocking=False)
    try:
        d = scaler.tick()
    finally:
        scaler._resizing.release()
    assert (d.action, d.reason) == ("hold", "resize_in_flight")
    assert router.added == []  # nothing actuated under the in-flight guard


def test_replica_seconds_integrates_timeline_with_floor():
    clock = FakeClock(30.0)
    scaler = Autoscaler(ActuationRouterStub(), ScriptedSource([sig(0.0)]),
                        _spawn_factory(ActuationRouterStub()), clock=clock)
    scaler.timeline = [(0.0, 1), (10.0, 2), (20.0, 1)]
    assert scaler.replica_seconds(until=30.0) == pytest.approx(40.0)
    assert scaler.replica_seconds(until=30.0, floor=2) == pytest.approx(60.0)
    # until defaults to the live clock
    clock.t = 25.0
    assert scaler.replica_seconds() == pytest.approx(35.0)


def test_snapshot_shape():
    scaler = Autoscaler(ActuationRouterStub(),
                        ScriptedSource([sig(0.0, n=1, shed=2.0)]),
                        _spawn_factory(ActuationRouterStub()),
                        clock=FakeClock())
    snap = scaler.snapshot()
    assert set(snap) == {"ticks", "scale_ups", "scale_downs",
                         "failed_scale_ups", "timeline", "history"}


# -- Router membership seam (scripted replica, no compiles) ------------------


class SeamReplica:
    """Probe-only replica double for the add/remove lifecycle seam."""

    def __init__(self, rid, state="serving"):
        self.id = rid
        self.generation = 0
        self.state = state
        self.quiesced = False
        self.closed = False

    def probe(self):
        return {"state": self.state, "healthy": self.state == "serving",
                "generation": self.generation}

    def quiesce(self, timeout=30.0):
        self.quiesced = True
        return True

    def close(self, timeout=30.0):
        self.closed = True
        return True

    @property
    def queue_depth(self):
        return 0

    @property
    def capacity(self):
        return 10


def test_add_replica_admits_behind_warmup_gate(tmp_path):
    with Router([SeamReplica(0)], FAST) as router:
        with capture_journal(tmp_path) as path:
            assert router.add_replica(SeamReplica(1)) is True
        assert router.replica_states()[1] == "serving"
        assert router.metrics.snapshot()["replica_adds"] == 1
        assert "replica_up" in _kinds(path)


def test_add_replica_rejects_duplicates_and_closed_router():
    router = Router([SeamReplica(0)], FAST).start()
    try:
        with pytest.raises(ValueError):
            router.add_replica(SeamReplica(0))
    finally:
        router.close()
    with pytest.raises(ShuttingDownError):
        router.add_replica(SeamReplica(1))


def test_add_replica_warmup_timeout_withdraws_view():
    with Router([SeamReplica(0)], FAST) as router:
        cold = SeamReplica(1, state="starting")  # never reports healthy
        assert router.add_replica(cold, wait_serving_s=0.2) is False
        assert 1 not in router.replica_states()  # view withdrawn
        assert cold.closed is False  # the caller still owns the handle
        assert router.metrics.snapshot()["replica_ups"] == 0


def test_remove_replica_drains_and_returns_handle(tmp_path):
    r0, r1 = SeamReplica(0), SeamReplica(1)
    with Router([r0, r1], FAST) as router:
        with capture_journal(tmp_path) as path:
            handle = router.remove_replica(1, quiesce_timeout_s=1.0)
        assert handle is r1 and r1.quiesced is True
        assert r1.closed is False  # the router drains, the caller reaps
        assert list(router.replica_states()) == [0]
        snap = router.metrics.snapshot()
        assert snap["replica_removes"] == 1 and snap["replica_drains"] == 1
        assert "replica_drain" in _kinds(path)
        with pytest.raises(KeyError):
            router.remove_replica(7)


# -- the two packages side by side --------------------------------------------

TRACES = {
    "diurnal": ("diurnal_trace", dict(duration_s=10.0, base_rps=5.0,
                                      peak_rps=15.0)),
    "burst": ("burst_trace", dict(duration_s=40.0, base_rps=2.0,
                                  burst_rps=10.0, burst_every_s=10.0,
                                  burst_len_s=1.0)),
    "flash_crowd": ("flash_crowd_trace", dict(
        duration_s=12.0, base_rps=25.0, spike_at_s=3.0, spike_len_s=2.5,
        spike_mult=10.0, decay_s=1.5)),
}


@pytest.mark.parametrize("kind", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_traces_equal_the_reference_bit_for_bit(kind, seed):
    """Each trace's arrival times (the flash crowd at `bench --serve
    --autoscale`'s own envelope) equal the reference's bit for bit."""
    from dist_mnist_tpu_torch.serve import loadgen as tloadgen

    name, kw = TRACES[kind]
    got = getattr(tloadgen, name)(seed=seed, **kw)
    want = getattr(jloadgen, name)(seed=seed, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _canned_signals(seed: int) -> list:
    """A seeded sequence of fleet samples on a fake clock (0.25 s ticks):
    quiet stretches, a shedding spike, a p99 excursion, a backlog wave."""
    rng = np.random.default_rng(seed)
    out, n = [], 2
    for i in range(240):
        t = 0.25 * i
        phase = (i // 30) % 4
        backlog = float(rng.uniform(0.0, 0.04)) if phase == 0 else \
            float(rng.uniform(0.0, 0.6))
        shed = float(rng.choice([0.0, 0.0, 0.6, 3.0])) if phase == 1 else 0.0
        p99 = (None if i < 5 else
               float(rng.uniform(100.0, 450.0)) if phase == 2
               else float(rng.uniform(5.0, 60.0)))
        out.append(dict(t=t, serving_replicas=n, total_replicas=n,
                        backlog_fraction=backlog, be_shed_rate=shed,
                        ls_p99_ms=p99))
        n = 1 + (i * 7 + 3) % 6
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_policy_decides_as_the_reference(seed):
    """One canned signal sequence through both packages' ScalePolicy, the
    actuation bookkeeping (`last_up_t`/`last_down_t` at each resize) done
    alike: the same decision, reason and target at every tick, and the
    same idle clock after it."""
    kw = dict(min_replicas=1, max_replicas=4, slo_p99_ms=500.0,
              backlog_up=0.25, idle_backlog=0.05, idle_window_s=1.5,
              up_cooldown_s=0.4, down_cooldown_s=2.0)
    mine, theirs = ScalePolicy(**kw), jautoscale.ScalePolicy(**kw)
    st_m, st_t = PolicyState(), jautoscale.PolicyState()
    actions = set()
    for fields in _canned_signals(seed):
        dm = mine.decide(FleetSignals(**fields), st_m)
        dt = theirs.decide(jautoscale.FleetSignals(**fields), st_t)
        assert (dm.action, dm.reason, dm.target_replicas) == \
            (dt.action, dt.reason, dt.target_replicas), fields
        assert st_m.idle_since == st_t.idle_since
        for st, d in ((st_m, dm), (st_t, dt)):
            if d.action == "up":
                st.last_up_t = fields["t"]
            elif d.action == "down":
                st.last_down_t = fields["t"]
        actions.add(dm.action)
    assert actions == {"up", "down", "hold"}  # the sequence reaches all
