"""Fleet autoscaler: replica count as a control variable (a copy of the
reference package's `serve/autoscale.py`, its imports pointed at the
port).

The router (serve/router.py) made the latency-sensitive SLO survive a
replica dying; this module makes it survive TRAFFIC — diurnal waves and
10x flash crowds — by closing the loop from the fleet's own signals back
into capacity. Three pieces, layered so each is testable alone:

- ``FleetSignalSource`` merges the control inputs into one immutable
  ``FleetSignals`` sample per tick: backlog fraction (queued + inflight
  over serving capacity), the best-effort shed RATE (sheds/sec since the
  previous tick — the first structural symptom of saturation, because
  the router sheds BE before LS p99 moves), and the live LS p99 against
  its SLO. In-process fleets read the Router's own metrics; a subprocess
  fleet hands the source a ``FleetScraper`` (obs/fleet.py) and queue
  depth comes from the merged ``serve_queue_depth`` scrape instead.

- ``ScalePolicy`` is the deterministic, hysteresis-damped decision
  function: scale UP when BE shedding starts, LS p99 eats its headroom,
  or backlog crosses the trigger; scale DOWN only after a SUSTAINED idle
  window. Separate up/down cooldowns, min/max clamps, and an
  at-most-one-in-flight-resize guard make flapping structurally
  impossible rather than merely unlikely. Pure function of
  ``(FleetSignals, PolicyState)`` — the unit-test matrix drives it with
  canned signals and an advancing fake clock, no replicas involved.

- ``Autoscaler`` is the actuator thread (named ``Autoscaler`` for the
  conftest leak-check): each tick it samples, decides, and — on a
  decision — resizes through the Router's replica-lifecycle seam.
  Scale-up spawns a COLD replica through the caller's ``spawn`` factory,
  which loads weights from the live bundle/peer ring and prewarms
  through the SHARED cell cache; `Router.add_replica` admits it to
  routing only after its warm-up probe passes. The journaled
  ``replica_scale_up`` event carries the warm-start receipts: StartupClock
  restore-vs-compile attribution plus the shared cache's compile-seconds
  and miss deltas across the spawn — a scale-up that compiled anything
  is visible (and `bench.py --serve --autoscale` asserts it is ~zero).
  Scale-down picks the highest-id serving replica, drains it via
  `Router.remove_replica` (quiesce — in-flight requests finish), then
  hands it to the caller's ``reap`` to close.

Actuation is synchronous on the Autoscaler's own thread, so "at most one
in-flight resize" is structural: a second decision cannot fire while a
spawn or drain is still running. Stdlib only; the torch-touching parts
live behind the caller's spawn/reap closures.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time

from dist_mnist_tpu_torch.compilecache.startup import StartupClock
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.serve.router import BEST_EFFORT, LATENCY_SENSITIVE

log = logging.getLogger(__name__)

#: decision actions — strings, not enums, so journal payloads read plainly
HOLD = "hold"
SCALE_UP = "up"
SCALE_DOWN = "down"


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One tick's merged control inputs (immutable: a decision is a pure
    function of this sample plus the policy state)."""

    t: float                    # sample instant (the policy's clock)
    serving_replicas: int
    total_replicas: int
    backlog_fraction: float     # queued+inflight over serving capacity
    be_shed_rate: float         # best_effort sheds/sec since last sample
    ls_p99_ms: float | None     # live LS p99; None before any samples


class FleetSignalSource:
    """Merge Router metrics (and, when given, FleetScraper state) into
    ``FleetSignals`` samples. Shed counts and LS p99 always come from the
    router — shedding is a router-level act, replicas never see the
    traffic — while queue depth prefers the scraper's merged
    ``serve_queue_depth`` gauges when a subprocess fleet is scraped."""

    def __init__(self, router, *, scraper=None, clock=time.monotonic):
        self._router = router
        self._scraper = scraper
        self._clock = clock
        self._prev_shed: int | None = None
        self._prev_t: float | None = None

    def _scraped_backlog(self) -> float | None:
        snap = self._scraper.snapshot() if self._scraper is not None else None
        if snap is None:
            return None
        depth = cap = 0.0
        seen = False
        with self._scraper._lock:
            views = list(self._scraper._hosts.values())
        for view in views:
            if not view.reachable:
                continue
            d = view.scalars.get("serve_queue_depth")
            if d is None:
                continue
            seen = True
            depth += d
            cap += view.scalars.get("serve_queue_capacity", 0.0)
        if not seen:
            return None
        return min(1.0, depth / max(cap, 1.0))

    def signals(self) -> FleetSignals:
        now = self._clock()
        snap = self._router.metrics.snapshot()
        shed = snap["shed"][BEST_EFFORT]
        if self._prev_t is None:
            rate = 0.0
        else:
            dt = max(now - self._prev_t, 1e-6)
            rate = max(0, shed - self._prev_shed) / dt
        self._prev_shed, self._prev_t = shed, now
        states = list(self._router.replica_states().values())
        backlog = self._scraped_backlog()
        if backlog is None:
            backlog = self._router.backlog_fraction()
        return FleetSignals(
            t=now,
            serving_replicas=states.count("serving"),
            total_replicas=len(states),
            backlog_fraction=backlog,
            be_shed_rate=rate,
            ls_p99_ms=self._router.metrics.latency_pct(
                LATENCY_SENSITIVE, "p99"),
        )


@dataclasses.dataclass
class PolicyState:
    """Mutable hysteresis state the policy threads between decisions."""

    last_up_t: float = -math.inf
    last_down_t: float = -math.inf
    idle_since: float | None = None


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str          # HOLD | SCALE_UP | SCALE_DOWN
    reason: str
    target_replicas: int


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Deterministic hysteresis-damped scaling policy.

    Up triggers (any one, subject to max clamp + up cooldown):
    ``be_shed_rate >= be_shed_rate_up`` (the router started shedding
    best-effort — saturation's first symptom), ``ls_p99 >= headroom *
    slo_p99_ms`` (the expensive tier's headroom collapsed), or
    ``backlog_fraction >= backlog_up``. Down requires the fleet to look
    idle (backlog under ``idle_backlog``, zero BE shedding)
    CONTINUOUSLY for ``idle_window_s``, plus both cooldowns — one busy
    sample resets the idle clock, which is what keeps an oscillating
    load from flapping the fleet."""

    min_replicas: int = 1
    max_replicas: int = 8
    slo_p99_ms: float = 500.0
    #: scale up when ls_p99 crosses this fraction of the SLO
    headroom: float = 0.7
    #: best_effort sheds/sec that count as "shedding started"
    be_shed_rate_up: float = 0.5
    #: backlog fraction up-trigger; below the router's be_shed_at so the
    #: fleet grows BEFORE the tier policy must throw traffic away
    backlog_up: float = 0.45
    #: below this backlog (and with zero shedding) a sample counts idle
    idle_backlog: float = 0.10
    idle_window_s: float = 5.0
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 10.0

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")

    def _up_reason(self, sig: FleetSignals) -> str | None:
        if sig.be_shed_rate >= self.be_shed_rate_up:
            return "be_shedding"
        if (sig.ls_p99_ms is not None
                and sig.ls_p99_ms >= self.headroom * self.slo_p99_ms):
            return "ls_headroom_collapse"
        if sig.backlog_fraction >= self.backlog_up:
            return "backlog"
        return None

    def decide(self, sig: FleetSignals, state: PolicyState) -> Decision:
        """One decision; mutates only ``state`` (the idle clock)."""
        n = sig.serving_replicas
        idle = (sig.backlog_fraction < self.idle_backlog
                and sig.be_shed_rate == 0.0)
        if idle:
            if state.idle_since is None:
                state.idle_since = sig.t
        else:
            state.idle_since = None
        up_reason = self._up_reason(sig)
        if up_reason is not None:
            if n >= self.max_replicas:
                return Decision(HOLD, "at_max", n)
            if sig.t - state.last_up_t < self.up_cooldown_s:
                return Decision(HOLD, "up_cooldown", n)
            return Decision(SCALE_UP, up_reason, n + 1)
        if (idle and state.idle_since is not None
                and sig.t - state.idle_since >= self.idle_window_s):
            if n <= self.min_replicas:
                return Decision(HOLD, "at_min", n)
            if sig.t - state.last_down_t < self.down_cooldown_s:
                return Decision(HOLD, "down_cooldown", n)
            if sig.t - state.last_up_t < self.down_cooldown_s:
                # fresh capacity: do not tear down what just scaled up
                return Decision(HOLD, "down_cooldown", n)
            return Decision(SCALE_DOWN, "sustained_idle", n - 1)
        return Decision(HOLD, "steady", n)


class Autoscaler:
    """Control-loop thread actuating `ScalePolicy` decisions through the
    Router's `add_replica` / `remove_replica` seam.

    ``spawn(replica_id, startup)`` must return a started replica handle,
    noting its weight-load and prewarm time into ``startup`` (a
    `StartupClock`) under the ``restore`` / ``compile`` phases.
    ``reap(replica)`` owns disposal of a drained (or failed-admission)
    replica — the router never closes replicas, and neither does the
    autoscaler. ``cache`` (optional, a `CompiledModelCache`) provides the
    compile-seconds/miss deltas that turn the warm-start promise into a
    journaled, assertable number."""

    def __init__(self, router, source, spawn, *, reap=None,
                 policy: ScalePolicy | None = None,
                 interval_s: float = 0.25, registry=None, cache=None,
                 warmup_timeout_s: float = 60.0,
                 drain_timeout_s: float = 30.0,
                 clock=time.monotonic):
        self._router = router
        self._source = source
        self._spawn = spawn
        self._reap = reap if reap is not None else self._default_reap
        self.policy = policy if policy is not None else ScalePolicy()
        self.interval_s = interval_s
        self._registry = registry
        self._cache = cache
        self._warmup_timeout_s = warmup_timeout_s
        self._drain_timeout_s = drain_timeout_s
        self._clock = clock
        self.state = PolicyState()
        self.scale_ups = 0
        self.scale_downs = 0
        self.failed_scale_ups = 0
        self.ticks = 0
        #: (t, serving_replica_count) after every membership change plus
        #: one seed sample at start() — the bench integrates this into
        #: replica-seconds for the chip-economics headline
        self.timeline: list = []
        #: per-resize receipts (dicts mirroring the journal payloads)
        self.history: list = []
        self._resizing = threading.Lock()
        self._next_id: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _default_reap(replica) -> None:
        close = getattr(replica, "close", None)
        if close is not None:
            close()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self.timeline.append((self._clock(), self._serving_count()))
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="Autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must survive
                log.exception("autoscaler tick failed")

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=max(10.0, self._warmup_timeout_s))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- control loop --------------------------------------------------------
    def _serving_count(self) -> int:
        states = list(self._router.replica_states().values())
        return states.count("serving")

    def _pick_next_id(self) -> int:
        """Monotonic fresh replica id: above every id the router has ever
        shown us, never reused after a remove (a reused id would alias the
        router's down-generation and recovery bookkeeping)."""
        highest = max(self._router.replica_states(), default=-1)
        if self._next_id is None or self._next_id <= highest:
            self._next_id = highest + 1
        rid = self._next_id
        self._next_id += 1
        return rid

    def tick(self) -> Decision:
        """One sample -> decision -> (maybe) resize. Public so the policy
        tests and the bench can drive the loop without the thread."""
        sig = self._source.signals()
        if not self._resizing.acquire(blocking=False):
            # a resize from a concurrent tick() is still in flight
            return Decision(HOLD, "resize_in_flight",
                            sig.serving_replicas)
        try:
            decision = self.policy.decide(sig, self.state)
            self.ticks += 1
            self._export_gauges(decision)
            if decision.action == SCALE_UP:
                self._scale_up(sig, decision)
            elif decision.action == SCALE_DOWN:
                self._scale_down(sig, decision)
            return decision
        finally:
            self._resizing.release()

    def _export_gauges(self, decision: Decision) -> None:
        if self._registry is None:
            return
        self._registry.set_scalars({
            "fleet/target_replicas": decision.target_replicas,
            "fleet/scale_ups": self.scale_ups,
            "fleet/scale_downs": self.scale_downs,
        }, step=self.ticks)

    def _emit_decision(self, sig: FleetSignals, decision: Decision) -> None:
        events.emit(
            "autoscale_decision", action=decision.action,
            reason=decision.reason, serving=sig.serving_replicas,
            target=decision.target_replicas,
            backlog=round(sig.backlog_fraction, 3),
            be_shed_rate=round(sig.be_shed_rate, 3),
            ls_p99_ms=(round(sig.ls_p99_ms, 3)
                       if sig.ls_p99_ms is not None else None))

    # -- actuation -----------------------------------------------------------
    def _scale_up(self, sig: FleetSignals, decision: Decision) -> None:
        self._emit_decision(sig, decision)
        rid = self._pick_next_id()
        startup = StartupClock()
        cache0 = self._cache.stats() if self._cache is not None else None
        t0 = time.monotonic()
        # cooldown starts at the ATTEMPT: a failing spawn must not be
        # retried at tick cadence
        self.state.last_up_t = sig.t
        try:
            replica = self._spawn(rid, startup)
        except Exception:  # noqa: BLE001 — a failed spawn must not kill the loop
            self.failed_scale_ups += 1
            log.exception("scale-up spawn of replica %d failed", rid)
            return
        admitted = False
        try:
            admitted = self._router.add_replica(
                replica, wait_serving_s=self._warmup_timeout_s)
        except Exception:  # noqa: BLE001
            log.exception("scale-up admission of replica %d failed", rid)
        if not admitted:
            self.failed_scale_ups += 1
            log.warning("replica %d failed its warm-up probe within %.1fs; "
                        "reaping", rid, self._warmup_timeout_s)
            self._reap(replica)
            return
        startup.first_step_done()
        total_ms = (time.monotonic() - t0) * 1e3
        self.scale_ups += 1
        self.timeline.append((self._clock(), self._serving_count()))
        receipt = {
            "replica": rid,
            "reason": decision.reason,
            "total_ms": round(total_ms, 3),
        }
        snap = startup.snapshot()
        # load-vs-compile attribution: restore_ms is the weight/engine
        # build, compile_ms the prewarm wall (shared-cache hits)
        receipt["restore_ms"] = round(snap.get("restore_ms", 0.0), 3)
        receipt["compile_ms"] = round(snap.get("compile_ms", 0.0), 3)
        if cache0 is not None:
            cache1 = self._cache.stats()
            receipt["cache_compile_ms"] = round(
                (cache1["compile_secs"] - cache0["compile_secs"]) * 1e3, 3)
            receipt["cache_misses"] = cache1["misses"] - cache0["misses"]
            receipt["cache_hits_memory"] = (cache1["hits_memory"]
                                            - cache0["hits_memory"])
            receipt["cache_hits_disk"] = (cache1["hits_disk"]
                                          - cache0["hits_disk"])
        self.history.append({"action": SCALE_UP, **receipt})
        events.emit("replica_scale_up", **receipt)

    def _scale_down(self, sig: FleetSignals, decision: Decision) -> None:
        self._emit_decision(sig, decision)
        serving = [rid for rid, s in self._router.replica_states().items()
                   if s == "serving"]
        if len(serving) <= self.policy.min_replicas:
            return  # membership moved under us since the sample
        victim = max(serving)
        self.state.last_down_t = sig.t
        t0 = time.monotonic()
        try:
            replica = self._router.remove_replica(
                victim, quiesce_timeout_s=self._drain_timeout_s)
        except KeyError:
            return  # removed concurrently (e.g. a failed replica reaped)
        drain_ms = (time.monotonic() - t0) * 1e3
        self._reap(replica)
        self.scale_downs += 1
        self.timeline.append((self._clock(), self._serving_count()))
        receipt = {
            "replica": victim,
            "reason": decision.reason,
            "drain_ms": round(drain_ms, 3),
        }
        self.history.append({"action": SCALE_DOWN, **receipt})
        events.emit("replica_scale_down", **receipt)

    # -- reporting -----------------------------------------------------------
    def replica_seconds(self, *, until: float | None = None,
                        floor: int | None = None) -> float:
        """Integrate the membership timeline into replica-seconds (the
        chip-economics numerator, before the chips-per-replica factor).
        ``floor`` clamps each segment's count from below — a fleet never
        bills less than its minimum provisioning."""
        if not self.timeline:
            return 0.0
        end = until if until is not None else self._clock()
        total = 0.0
        for (t0, n), (t1, _n_next) in zip(
                self.timeline, self.timeline[1:] + [(end, 0)]):
            seg_n = max(n, floor) if floor is not None else n
            total += max(0.0, t1 - t0) * seg_n
        return total

    def snapshot(self) -> dict:
        return {
            "ticks": self.ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "failed_scale_ups": self.failed_scale_ups,
            "timeline": [(round(t, 3), n) for t, n in self.timeline],
            "history": list(self.history),
        }
