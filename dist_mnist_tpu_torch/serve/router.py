"""Fleet router: N `InferenceServer` replicas behind one `submit()` that
survives a replica kill, a slow replica, and a live weight rollout (a
copy of the reference package's `serve/router.py`, its imports pointed
at the port).

A single `InferenceServer` is one process — one admission queue, one
batcher, one set of weights; any crash is a full outage and any weight
update is downtime. The router puts the serving SLO above replicas the
way the elastic supervisor puts the training run above hosts
(docs/RESILIENCE.md): individual replicas are expendable, the fleet's
latency-sensitive tier is not.

Three mechanisms, layered on the per-replica contracts that already
exist (health states, quiesce, the admission error types):

1. **SLO-tiered admission.** Every request carries a class —
   `latency_sensitive` or `best_effort`. Under backlog the router sheds
   best-effort FIRST (a structured `ShedError` at submit, before any
   replica queue sees the request): best-effort sheds at a configurable
   backlog fraction and when its own deadline is hopeless against the
   currently observed latency; latency-sensitive sheds only when every
   queue is full. Rejecting cheap traffic early is what keeps the
   expensive tier's p99 flat through an incident.

2. **Replica lifecycle robustness.** Routing is least-loaded over
   replicas a health probe (and the error stream) says are serving; a
   `draining` replica stops receiving new work but finishes its queue.
   Failed attempts are classified TYPE-FIRST (serve/errors.py):
   retryables back off exponentially and try again (deadline-bounded),
   replica-fatal errors mark the replica down and requeue the in-flight
   request on a live replica immediately. Latency-sensitive requests
   additionally hedge: once enough samples exist, a duplicate attempt is
   dispatched to a second replica after the observed-p99-derived timeout,
   the first result wins, and the loser is withdrawn (admission
   cancel_event — a queued loser never occupies a batch slot). Request
   ids guard completion: exactly one result per request reaches the
   client, no matter how many attempts raced.

3. **Zero-downtime weight hot-swap.** A `CheckpointWatcher` polls the
   training run's commit markers (checkpoint/manager.py
   `commits/<step>.committed` — the only steps safe to serve) and rolls
   the fleet replica-by-replica: drain (stop routing, quiesce the
   pipeline so in-flight requests finish on the old weights) -> swap
   (`InferenceEngine.swap_weights`: a copy to the device, no cell runs
   again) -> rewarm (memory-tier hits of the warmed cells) -> serve. One
   replica swaps while the rest carry traffic, so the roll drops nothing.

4. **Replica membership as a control variable.** `add_replica` /
   `remove_replica` let a controller (serve/autoscale.py) grow and
   shrink the fleet under traffic: admission is gated on a warm-up
   probe (a ``starting`` view is never routed to), removal drains via
   the same quiesce machinery the weight roll uses, and every internal
   walk of the view set snapshots under the lock, so churn is safe
   against probes, timers, and rolls in flight.

Thread inventory (all named ``Router*`` for the conftest leak-check, all
joined by `close()`): RouterHealth (probe loop), RouterTimer (retry
backoff + hedge timers), RouterWatcher (commit-marker poll),
RouterHttp-* (HTTP replica transport pool).
"""

from __future__ import annotations

import dataclasses
import heapq
import io
import itertools
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    InferenceResult,
    QueueFullError,
    ShuttingDownError,
)
from dist_mnist_tpu_torch.serve.errors import (
    REPLICA_FATAL,
    RETRYABLE,
    TERMINAL,
    AllReplicasDownError,
    ReplicaKilledError,
    ShedError,
    classify_failure,
)

log = logging.getLogger(__name__)

LATENCY_SENSITIVE = "latency_sensitive"
BEST_EFFORT = "best_effort"
REQUEST_CLASSES = (LATENCY_SENSITIVE, BEST_EFFORT)

#: What each request class optimizes for on the DECODE path
#: (serve/decode.py): the same two classes the router sheds by map onto
#: autoregressive SLOs — latency_sensitive requests jump the admission
#: queue to minimize time-to-first-token, best_effort requests ride the
#: in-flight batch for per-token throughput. Keyed here, beside the
#: class constants, so the router and the decode scheduler can never
#: disagree about what a class means.
DECODE_SLO_TARGETS = {
    LATENCY_SENSITIVE: "ttft_ms",
    BEST_EFFORT: "tokens_per_s",
}

# conftest leak registry: every started-but-unclosed router is a leak (its
# health/timer threads would outlive the test).
_LIVE_ROUTERS: list = []


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    # -- tiered shedding ----------------------------------------------------
    #: backlog fraction (queued+inflight over total capacity of serving
    #: replicas) at which best_effort submits shed
    be_shed_at: float = 0.5
    #: latency_sensitive sheds only when effectively every queue is full
    ls_shed_at: float = 1.0
    #: above this fraction, a best_effort deadline shorter than the observed
    #: p50 latency is hopeless and sheds immediately (deadline-aware tier)
    deadline_guard_at: float = 0.25
    # -- retry / failover ---------------------------------------------------
    retry_max_attempts: int = 4
    retry_base_ms: float = 2.0
    retry_max_ms: float = 50.0
    # -- hedging ------------------------------------------------------------
    #: fixed hedge timeout; None = derive from the live latency_sensitive
    #: p99 once `hedge_min_samples` completions exist (disabled before that)
    hedge_after_ms: float | None = None
    hedge_min_samples: int = 50
    hedge_floor_ms: float = 5.0
    # -- lifecycle ----------------------------------------------------------
    health_interval_s: float = 0.2
    swap_quiesce_timeout_s: float = 30.0


class RouterMetrics:
    """Thread-safe fleet-level accounting: per-class counters + latency
    ladders, retry/hedge/failover counters, and the replica_down ->
    first-rerouted-response recovery samples."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = {c: 0 for c in REQUEST_CLASSES}
        self.completed = {c: 0 for c in REQUEST_CLASSES}
        self.shed = {c: 0 for c in REQUEST_CLASSES}
        self.failed = {c: 0 for c in REQUEST_CLASSES}
        self.retries = 0
        self.requeues = 0
        self.hedges = 0
        self.hedge_losses = 0
        self.replica_downs = 0
        self.replica_ups = 0
        self.replica_drains = 0
        self.replica_adds = 0
        self.replica_removes = 0
        self.swaps = 0
        self.swap_failures = 0
        self.latency_ms = {c: StreamingHistogram() for c in REQUEST_CLASSES}
        self.recovery_ms: list[float] = []

    def attach_to(self, registry) -> None:
        """Expose the live per-class ladders on a MetricRegistry; the
        `fleet/` prefix matches the training fleet series so one /metrics
        scrape shows training and serving fleet views side by side."""
        for cls in REQUEST_CLASSES:
            registry.attach_histogram(f"fleet/latency_ms_{cls}",
                                      self.latency_ms[cls])

    def record_submitted(self, cls: str) -> None:
        with self._lock:
            self.submitted[cls] += 1

    def record_completed(self, cls: str, latency_ms: float) -> None:
        self.latency_ms[cls].observe(latency_ms)
        with self._lock:
            self.completed[cls] += 1

    def record_shed(self, cls: str) -> None:
        with self._lock:
            self.shed[cls] += 1

    def record_failed(self, cls: str) -> None:
        with self._lock:
            self.failed[cls] += 1

    def record_recovery(self, ms: float) -> None:
        with self._lock:
            self.recovery_ms.append(ms)

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def latency_pct(self, cls: str, pct: str) -> float | None:
        s = self.latency_ms[cls].snapshot()
        return s[pct] if s["count"] else None

    def observed_p50_ms(self) -> float | None:
        """Merged-class p50 — the shed policy's 'what latency should a
        request expect right now' estimate."""
        merged = StreamingHistogram()
        for h in self.latency_ms.values():
            merged.merge(h)
        s = merged.snapshot()
        return s["p50"] if s["count"] else None

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "submitted": dict(self.submitted),
                "completed": dict(self.completed),
                "shed": dict(self.shed),
                "failed": dict(self.failed),
                "retries": self.retries,
                "requeues": self.requeues,
                "hedges": self.hedges,
                "hedge_losses": self.hedge_losses,
                "replica_downs": self.replica_downs,
                "replica_ups": self.replica_ups,
                "replica_drains": self.replica_drains,
                "replica_adds": self.replica_adds,
                "replica_removes": self.replica_removes,
                "swaps": self.swaps,
                "swap_failures": self.swap_failures,
                "recovery_ms": [round(v, 3) for v in self.recovery_ms],
            }
        for cls in REQUEST_CLASSES:
            s = self.latency_ms[cls].snapshot()
            out[f"latency_{cls}"] = (
                {"p50_ms": s["p50"], "p95_ms": s["p95"], "p99_ms": s["p99"],
                 "mean_ms": s["mean"], "count": s["count"]}
                if s["count"] else {"count": 0}
            )
        return out


# -- replica handles ----------------------------------------------------------


class InProcessReplica:
    """One in-process `InferenceServer` replica with restart and hot-swap.

    `make_server` is a zero-arg factory returning a STARTED (or startable)
    InferenceServer — the factory, not a server instance, so `restart()`
    can rebuild the whole replica (fresh engine, fresh batcher thread)
    after a kill; a shared `CompiledModelCache` inside the factory keeps
    that restart free of first runs (its cells are warm). `load_weights`
    (step -> (params, model_state)) is the hot-swap source, typically a
    `load_for_serving` closure over the training run's checkpoint dir.
    """

    def __init__(self, replica_id: int, make_server, *, load_weights=None):
        self.id = replica_id
        self._make = make_server
        self._load = load_weights
        #: bumped by restart(); a router clears a down-mark only when it
        #: sees a HIGHER generation (a dead engine can still probe healthy)
        self.generation = 0
        self.server = None

    def start(self) -> "InProcessReplica":
        if self.server is None:
            self.server = self._make()
            if not self.server._started:
                self.server.start()
        return self

    def submit(self, image, *, deadline_ms=None, cancel_event=None):
        if self.server is None:
            raise ReplicaKilledError(f"replica {self.id} is not running")
        return self.server.submit(image, deadline_ms=deadline_ms,
                                  cancel_event=cancel_event)

    @property
    def queue_depth(self) -> int:
        return self.server.queue_depth if self.server is not None else 0

    @property
    def capacity(self) -> int:
        return self.server.capacity if self.server is not None else 0

    def probe(self) -> dict:
        if self.server is None:
            return {"state": "stopped", "healthy": False,
                    "generation": self.generation}
        h = self.server.health
        if h is not None:
            snap = h.snapshot()
            return {"state": snap["state"], "healthy": snap["healthy"],
                    "generation": self.generation}
        state = ("stopped" if self.server._closed
                 else "serving" if self.server._started else "starting")
        return {"state": state, "healthy": state == "serving",
                "generation": self.generation}

    def quiesce(self, timeout: float = 30.0) -> bool:
        return self.server.quiesce(timeout=timeout)

    def swap_to(self, step: int) -> None:
        if self._load is None:
            raise RuntimeError(f"replica {self.id} has no weight loader")
        params, model_state = self._load(step)
        self.server.engine.swap_weights(params, model_state, version=step)

    def rewarm(self) -> float:
        """Re-touch every served grid cell post-swap; returns wall ms. Pure
        memory-tier hits for a live engine (the warmed cells survive the
        swap) and for a restarted one on a shared cache. On a zoo engine
        (serve/zoo.py) prewarm defaults its heights to the full sequence
        grid, so this walks the whole 2-D (batch, height) grid, not just
        batch buckets."""
        t0 = time.perf_counter()
        eng = self.server.engine
        eng.prewarm([b for b in eng.buckets()
                     if b <= max(self.server.config.max_batch,
                                 eng.min_bucket)])
        return (time.perf_counter() - t0) * 1e3

    def restart(self) -> "InProcessReplica":
        old, self.server = self.server, None
        if old is not None:
            try:
                old.close(timeout=5.0)
            except Exception:  # noqa: BLE001 — a dead server may not close cleanly
                log.warning("replica %d: close of old server failed", self.id,
                            exc_info=True)
        self.server = self._make()
        if not self.server._started:
            self.server.start()
        self.generation += 1
        return self

    def close(self, timeout: float = 30.0) -> bool:
        if self.server is None:
            return True
        return self.server.close(timeout=timeout)


def _error_from_http(code: int, body: bytes) -> Exception:
    """Reconstruct the TYPED replica error from an HTTP status + JSON body
    so classify_failure treats remote replicas exactly like local ones."""
    try:
        payload = json.loads(body)
    except Exception:  # noqa: BLE001
        payload = {}
    msg = payload.get("message", f"replica returned HTTP {code}")
    if code == 429:
        return QueueFullError(msg)
    if code == 503:
        return ShuttingDownError(msg)
    if code == 504:
        return DeadlineExceededError(msg)
    if payload.get("error") == "ReplicaKilledError":
        return ReplicaKilledError(msg)
    return RuntimeError(msg)


class HttpReplica:
    """Replica handle over HTTP: one `cli/serve.py --serve_forever` process
    exposing POST /predict and /swap next to /healthz + /metrics
    (obs/exporter.py). The data plane is a small thread pool turning each
    submit into a blocking POST; connection-level failures surface as
    OSErrors, which classify as REPLICA_FATAL — a vanished process reads
    exactly like a killed in-process engine."""

    def __init__(self, replica_id: int, base_url: str, *, pool_size: int = 16,
                 timeout_s: float = 60.0, capacity_hint: int = 256):
        self.id = replica_id
        self.base = base_url.rstrip("/")
        self.generation = 0
        #: routing weight inputs; a scraper (obs/fleet.py) may refresh
        #: depth_hint from the replica's serve/queue_depth gauge
        self.depth_hint = 0
        self.capacity_hint = capacity_hint
        self._timeout = timeout_s
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size, thread_name_prefix=f"RouterHttp-{replica_id}")

    def submit(self, image, *, deadline_ms=None, cancel_event=None) -> Future:
        # cancel_event is advisory here: an HTTP request already on the wire
        # cannot be withdrawn; the router discards the loser's result
        del cancel_event
        return self._pool.submit(self._predict, np.asarray(image), deadline_ms)

    def _predict(self, image: np.ndarray, deadline_ms) -> InferenceResult:
        buf = io.BytesIO()
        np.save(buf, image)
        query = f"?deadline_ms={deadline_ms}" if deadline_ms else ""
        req = urllib.request.Request(
            self.base + "/predict" + query, data=buf.getvalue(),
            headers={"Content-Type": "application/x-npy"})
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise _error_from_http(e.code, e.read()) from None
        # URLError wraps connection loss and IS an OSError -> REPLICA_FATAL
        logits = np.asarray(payload["logits"], dtype=np.float32)
        return InferenceResult(logits=logits, label=int(payload["label"]),
                               latency_ms=(time.monotonic() - t0) * 1e3)

    @property
    def queue_depth(self) -> int:
        return self.depth_hint

    @property
    def capacity(self) -> int:
        return self.capacity_hint

    def probe(self) -> dict:
        try:
            with urllib.request.urlopen(self.base + "/healthz",
                                        timeout=2.0) as r:
                snap = json.loads(r.read())
        except urllib.error.HTTPError as e:
            # 503 still carries the state machine in the body (draining etc.)
            try:
                snap = json.loads(e.read())
            except Exception:  # noqa: BLE001
                snap = {"state": "failed", "healthy": False}
        except OSError:
            return {"state": "stopped", "healthy": False,
                    "generation": self.generation}
        return {"state": snap.get("state", "unknown"),
                "healthy": bool(snap.get("healthy")),
                "generation": int(snap.get("generation", self.generation))}

    def quiesce(self, timeout: float = 30.0) -> bool:
        # the replica-side /swap handler quiesces its own pipeline; the
        # router only needs to have stopped routing first
        del timeout
        return True

    def swap_to(self, step: int) -> None:
        req = urllib.request.Request(f"{self.base}/swap?step={step}",
                                     data=b"", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise _error_from_http(e.code, e.read()) from None

    def rewarm(self) -> float:
        return 0.0  # included in the replica-side swap

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


# -- router internals ---------------------------------------------------------


class _Scheduler:
    """One timer thread for every delayed action (retry backoff, hedge
    checks): a heap of (due, seq, fn) under a condition variable. Cheaper
    and more inspectable than a threading.Timer per retry, and a single
    join point for close()."""

    def __init__(self, name: str = "RouterTimer"):
        self._heap: list = []
        self._cv = threading.Condition()
        self._stop = False
        self._seq = itertools.count()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def call_later(self, delay_s: float, fn) -> None:
        with self._cv:
            if self._stop:
                return
            heapq.heappush(self._heap,
                           (time.monotonic() + max(delay_s, 0.0),
                            next(self._seq), fn))
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if self._stop:
                        break
                    wait = (self._heap[0][0] - time.monotonic()
                            if self._heap else 0.5)
                    self._cv.wait(timeout=max(0.001, min(wait, 0.5)))
                if self._stop:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # noqa: BLE001 — a retry must not kill the timer
                log.exception("scheduled router action failed")

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._heap.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5)


class _Flight:
    """One client request's routing state: id, class, deadline, attempts.
    The `done` latch under `lock` is the at-most-once completion guard —
    however many attempts race (retries, requeues, hedges), exactly one
    settles the client future; the rest are discarded losers."""

    __slots__ = ("id", "image", "request_class", "deadline", "future",
                 "lock", "done", "attempts", "hedged", "tried", "pending",
                 "requeued_from", "t_submit")

    def __init__(self, fid: str, image: np.ndarray, request_class: str,
                 deadline: float | None):
        self.id = fid
        self.image = image
        self.request_class = request_class
        self.deadline = deadline
        self.future: Future = Future()
        self.lock = threading.Lock()
        self.done = False
        self.attempts = 0
        self.hedged = False
        self.tried: set = set()
        self.pending: list = []  # (replica_id, attempt future, cancel event)
        self.requeued_from: int | None = None
        self.t_submit = time.monotonic()

    def remaining_ms(self, now: float) -> float | None:
        if self.deadline is None:
            return None
        return max((self.deadline - now) * 1e3, 0.0)

    def settle(self) -> bool:
        """True exactly once — the caller owns the client future."""
        with self.lock:
            if self.done:
                return False
            self.done = True
            return True


@dataclasses.dataclass
class _View:
    """The router's opinion of one replica (its probe state can lag)."""

    replica: object
    state: str = "starting"  # serving | draining | swapping | down
    inflight: int = 0
    down_since: float | None = None
    down_generation: int = -1


class Router:
    """The fleet facade: `submit()` mirrors `InferenceServer.submit` plus a
    `request_class`, and everything else — spreading, shedding, retrying,
    hedging, failover, weight rolls — happens behind it."""

    def __init__(self, replicas, config: RouterConfig | None = None, *,
                 registry=None):
        self.config = config or RouterConfig()
        self.metrics = RouterMetrics()
        self._views: dict = {r.id: _View(replica=r) for r in replicas}
        if len(self._views) != len(list(replicas)):
            raise ValueError("duplicate replica ids")
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._flights: set = set()
        self._pending_recovery: dict = {}  # replica id -> down wall instant
        self._registry = registry
        if registry is not None:
            self.metrics.attach_to(registry)
        self.serving_step: int | None = None
        self._swap_lock = threading.Lock()
        self._scheduler: _Scheduler | None = None
        self._health_stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self._started = False
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Router":
        if self._started:
            return self
        self._started = True
        self._scheduler = _Scheduler()
        self._probe_all()  # seed states before the first submit
        self._health_thread = threading.Thread(
            target=self._health_loop, name="RouterHealth", daemon=True)
        self._health_thread.start()
        _LIVE_ROUTERS.append(self)
        events.emit("router_start", replicas=sorted(self._views))
        return self

    def close(self) -> None:
        """Stop the router's own threads and fail undispatched flights.
        Replicas are NOT closed — the router routes to them, it does not
        own them (the caller/CLI does)."""
        if self._closed or not self._started:
            self._closed = True
            return
        self._closed = True
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
        if self._scheduler is not None:
            self._scheduler.close()
        with self._lock:
            flights = list(self._flights)
        for flight in flights:
            self._fail(flight, ShuttingDownError("router closed"))
        if self in _LIVE_ROUTERS:
            _LIVE_ROUTERS.remove(self)
        events.emit("router_stop", **{
            k: v for k, v in self.metrics.snapshot().items()
            if isinstance(v, (int, float))})

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission (tiered shedding) ----------------------------------------
    def backlog_fraction(self) -> float:
        depth = cap = 0
        n = 0
        with self._lock:
            views = list(self._views.values())
        for v in views:
            if v.state != "serving":
                continue
            n += 1
            depth += v.replica.queue_depth + v.inflight
            cap += v.replica.capacity
        if n == 0:
            return 1.0
        return min(1.0, depth / max(cap, 1))

    def _maybe_shed(self, cls: str, deadline_ms: float | None) -> None:
        cfg = self.config
        with self._lock:
            any_serving = any(v.state == "serving"
                              for v in self._views.values())
        if not any_serving:
            # a failover/swap window, not backlog: the dispatch retry path
            # owns this (redispatch with backoff, AllReplicasDownError at
            # the attempt budget) — shedding here would drop LS traffic a
            # recovering replica could still serve in time
            return
        frac = self.backlog_fraction()
        threshold = cfg.be_shed_at if cls == BEST_EFFORT else cfg.ls_shed_at
        reason = None
        if frac >= threshold:
            reason = "backlog"
        elif (cls == BEST_EFFORT and deadline_ms is not None
              and frac >= cfg.deadline_guard_at):
            # deadline-aware tier: under pressure, a best-effort deadline
            # below the latency requests are OBSERVING right now is hopeless
            p50 = self.metrics.observed_p50_ms()
            if p50 is not None and deadline_ms < p50:
                reason = "deadline_hopeless"
        if reason is not None:
            self.metrics.record_shed(cls)
            events.emit("shed", request_class=cls, reason=reason,
                        backlog=round(frac, 3))
            raise ShedError(
                f"{cls} shed ({reason}, backlog {frac:.2f})")

    def submit(self, image, *, request_class: str = LATENCY_SENSITIVE,
               deadline_ms: float | None = None) -> Future:
        """One request -> Future[InferenceResult]. Never blocks; raises
        `ShedError` (tier policy) or `AllReplicasDownError` instead."""
        if request_class not in REQUEST_CLASSES:
            raise ValueError(
                f"unknown request class {request_class!r}; "
                f"one of {REQUEST_CLASSES}")
        if self._closed or not self._started:
            raise ShuttingDownError("router is not running")
        self.metrics.record_submitted(request_class)
        self._maybe_shed(request_class, deadline_ms)
        now = time.monotonic()
        flight = _Flight(
            f"req-{next(self._seq)}", np.asarray(image), request_class,
            now + deadline_ms / 1e3 if deadline_ms is not None else None)
        with self._lock:
            self._flights.add(flight)
        self._dispatch(flight)
        return flight.future

    # -- dispatch ------------------------------------------------------------
    def _pick(self, flight: _Flight, *, require_untried: bool = False):
        with self._lock:
            serving = [v for v in self._views.values()
                       if v.state == "serving"]
        fresh = [v for v in serving if v.replica.id not in flight.tried]
        pool = fresh if (fresh or require_untried) else serving
        if not pool:
            return None
        return min(pool, key=lambda v: (v.replica.queue_depth + v.inflight,
                                        v.replica.id))

    def _any_recoverable(self) -> bool:
        """Is any replica plausibly coming back (draining/swapping/starting,
        or down with a restart policy outside the router)? Down replicas
        count: the health loop re-admits them on a new generation."""
        with self._lock:
            return bool(self._views)

    def _dispatch(self, flight: _Flight, *, hedge: bool = False) -> None:
        if flight.done:
            return
        now = time.monotonic()
        if flight.deadline is not None and now > flight.deadline:
            self._fail(flight, DeadlineExceededError(
                f"{flight.id}: deadline passed before dispatch"))
            return
        view = self._pick(flight, require_untried=hedge)
        if view is None:
            if hedge:
                return  # nowhere to hedge to; the primary attempt stands
            self._retry_or_fail(
                flight, AllReplicasDownError("no serving replica"),
                retryable=self._any_recoverable())
            return
        cancel_ev = threading.Event()
        try:
            fut = view.replica.submit(flight.image,
                                      deadline_ms=flight.remaining_ms(now),
                                      cancel_event=cancel_ev)
        except Exception as err:  # noqa: BLE001 — classified below
            self._on_attempt_error(flight, view, err)
            return
        with self._lock:
            view.inflight += 1
        with flight.lock:
            flight.tried.add(view.replica.id)
            flight.pending.append((view.replica.id, fut, cancel_ev))
        fut.add_done_callback(
            lambda f, v=view: self._on_attempt_done(flight, v, f))
        if not hedge and flight.request_class == LATENCY_SENSITIVE:
            h_ms = self._hedge_after_ms()
            if h_ms is not None and self._scheduler is not None:
                self._scheduler.call_later(
                    h_ms / 1e3, lambda: self._maybe_hedge(flight, h_ms))

    def _hedge_after_ms(self) -> float | None:
        cfg = self.config
        if cfg.hedge_after_ms is not None:
            return cfg.hedge_after_ms
        h = self.metrics.latency_ms[LATENCY_SENSITIVE]
        if h.count < cfg.hedge_min_samples:
            return None  # not enough signal for a p99 yet
        return max(h.snapshot()["p99"], cfg.hedge_floor_ms)

    def _maybe_hedge(self, flight: _Flight, after_ms: float) -> None:
        with flight.lock:
            if flight.done or flight.hedged:
                return
            flight.hedged = True
        view = self._pick(flight, require_untried=True)
        if view is None:
            with flight.lock:
                flight.hedged = False  # nowhere to go; may re-arm later
            return
        self.metrics.bump("hedges")
        events.emit("request_hedged", request=flight.id,
                    to_replica=view.replica.id, after_ms=round(after_ms, 3))
        self._dispatch(flight, hedge=True)

    # -- attempt completion --------------------------------------------------
    def _on_attempt_done(self, flight: _Flight, view: _View, fut) -> None:
        with self._lock:
            view.inflight -= 1
        err = fut.exception()
        if err is None:
            self._on_attempt_success(flight, view, fut.result())
        else:
            self._on_attempt_error(flight, view, err)

    def _on_attempt_success(self, flight: _Flight, view: _View,
                            result) -> None:
        if not flight.settle():
            if flight.hedged:
                self.metrics.bump("hedge_losses")
            return
        latency_ms = (time.monotonic() - flight.t_submit) * 1e3
        self.metrics.record_completed(flight.request_class, latency_ms)
        self._cancel_losers(flight)
        self._note_recovery(flight)
        with self._lock:
            self._flights.discard(flight)
        # router-level latency (includes retries/hedges), replica's logits
        flight.future.set_result(InferenceResult(
            logits=result.logits, label=result.label, latency_ms=latency_ms))

    def _on_attempt_error(self, flight: _Flight, view: _View,
                          err: BaseException) -> None:
        disposition = classify_failure(err)
        if disposition == REPLICA_FATAL:
            # mark the replica down even when this flight already won via a
            # hedge — the ERROR is evidence about the replica either way
            self._mark_down(view, err)
        if flight.done:
            return
        if disposition == TERMINAL:
            self._fail(flight, err)
        elif disposition == REPLICA_FATAL:
            flight.requeued_from = view.replica.id
            if flight.attempts < self.config.retry_max_attempts:
                flight.attempts += 1
                self.metrics.bump("requeues")
                events.emit("request_requeued", request=flight.id,
                            from_replica=view.replica.id)
                self._dispatch(flight)  # immediate failover, no backoff
            else:
                self._fail(flight, err)
        else:
            self._retry_or_fail(flight, err, retryable=True)

    def _retry_or_fail(self, flight: _Flight, err: BaseException, *,
                       retryable: bool) -> None:
        if not retryable or flight.attempts >= self.config.retry_max_attempts:
            self._fail(flight, err)
            return
        backoff_s = min(self.config.retry_base_ms * (2 ** flight.attempts),
                        self.config.retry_max_ms) / 1e3
        flight.attempts += 1
        if (flight.deadline is not None
                and time.monotonic() + backoff_s > flight.deadline):
            self._fail(flight, err)
            return
        self.metrics.bump("retries")
        if self._scheduler is None:
            self._fail(flight, err)
            return
        self._scheduler.call_later(backoff_s, lambda: self._dispatch(flight))

    def _fail(self, flight: _Flight, err: BaseException) -> None:
        if not flight.settle():
            return
        self.metrics.record_failed(flight.request_class)
        self._cancel_losers(flight)
        with self._lock:
            self._flights.discard(flight)
        flight.future.set_exception(err)

    def _cancel_losers(self, flight: _Flight) -> None:
        with flight.lock:
            pending = list(flight.pending)
        for _rid, fut, ev in pending:
            if not fut.done():
                ev.set()  # dequeue-time drop; a mid-batch loser just finishes

    def _note_recovery(self, flight: _Flight) -> None:
        """replica_down -> first-rerouted-response: the recovery latency the
        bench reports. Sampled on the first completed flight that was
        requeued off the dead replica."""
        rid = flight.requeued_from
        if rid is None:
            return
        with self._lock:
            t0 = self._pending_recovery.pop(rid, None)
        if t0 is None:
            return
        ms = (time.monotonic() - t0) * 1e3
        self.metrics.record_recovery(ms)
        events.emit("failover_first_response", replica=rid,
                    recovery_ms=round(ms, 3), request=flight.id)

    # -- replica lifecycle ---------------------------------------------------
    def _mark_down(self, view: _View, err: BaseException | None) -> None:
        gen = getattr(view.replica, "generation", 0)
        with self._lock:
            if view.state == "down" and view.down_generation == gen:
                return
            view.state = "down"
            view.down_since = time.monotonic()
            view.down_generation = gen
            self._pending_recovery[view.replica.id] = view.down_since
        self.metrics.bump("replica_downs")
        reason = type(err).__name__ if err is not None else "probe"
        log.warning("replica %s marked down (%s)", view.replica.id, reason)
        events.emit("replica_down", replica=view.replica.id, reason=reason)

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.config.health_interval_s):
            self._probe_all()

    def _probe_all(self) -> None:
        for view in list(self._views.values()):
            try:
                snap = view.replica.probe()
            except Exception:  # noqa: BLE001 — an unprobeable replica is down
                snap = {"state": "stopped", "healthy": False,
                        "generation": -1}
            with self._lock:
                state = view.state
            if state == "swapping":
                continue  # router-owned window; the probe has no say
            if state == "down":
                if (snap["healthy"]
                        and snap.get("generation", 0) > view.down_generation):
                    with self._lock:
                        view.state = "serving"
                        view.down_since = None
                    self.metrics.bump("replica_ups")
                    events.emit("replica_up", replica=view.replica.id,
                                generation=snap.get("generation"))
            elif snap["state"] == "draining":
                if state != "draining":
                    with self._lock:
                        view.state = "draining"
                    self.metrics.bump("replica_drains")
                    events.emit("replica_drain", replica=view.replica.id)
            elif not snap["healthy"]:
                self._mark_down(view, None)
            else:  # healthy and not draining
                if state in ("starting", "draining"):
                    with self._lock:
                        view.state = "serving"
                    if state == "draining":
                        events.emit("replica_up", replica=view.replica.id,
                                    generation=snap.get("generation"))
                        self.metrics.bump("replica_ups")
        self._export_gauges()

    def _export_gauges(self) -> None:
        if self._registry is None:
            return
        with self._lock:
            states = [v.state for v in self._views.values()]
        self._registry.set_scalars({
            "fleet/replicas_total": len(states),
            "fleet/replicas_serving": states.count("serving"),
            "fleet/replicas_down": states.count("down"),
            "fleet/backlog_fraction": self.backlog_fraction(),
        }, step=0)

    def replica_states(self) -> dict:
        with self._lock:
            return {rid: v.state for rid, v in self._views.items()}

    # -- replica membership (the autoscaler's seam) ---------------------------
    # The replica set is NOT immutable after construction: serve/autoscale.py
    # adds and removes replicas while traffic flows. Everything that walks
    # the views already snapshots under `_lock` (`_pick`, `_probe_all`,
    # `backlog_fraction`, `_export_gauges`), scheduler timers capture _View
    # objects (alive after removal, so late attempt callbacks settle
    # harmlessly), and `roll_weights` re-looks ids up with `.get` — so
    # membership churn needs no further coordination than these two methods.

    def add_replica(self, replica, *, wait_serving_s: float = 30.0,
                    probe_interval_s: float = 0.05) -> bool:
        """Admit a new replica behind a warm-up gate.

        The view enters as ``starting`` — `_pick` never routes to it — and
        is promoted to ``serving`` only once the replica's own probe
        reports healthy. Returns True on admission; on a warm-up timeout
        the view is withdrawn and False returned (the caller still owns
        the replica and should reap it). Raises ValueError on a duplicate
        id and ShuttingDownError on a closed router."""
        if self._closed or not self._started:
            raise ShuttingDownError("router is not running")
        with self._lock:
            if replica.id in self._views:
                raise ValueError(f"duplicate replica id {replica.id}")
            view = _View(replica=replica)
            self._views[replica.id] = view
        self.metrics.bump("replica_adds")
        deadline = time.monotonic() + wait_serving_s
        while time.monotonic() < deadline and not self._closed:
            with self._lock:
                already = view.state == "serving"
            if already:
                break  # the health loop promoted it between our probes
            try:
                snap = replica.probe()
            except Exception:  # noqa: BLE001 — not warm yet
                snap = {"healthy": False}
            if snap.get("healthy"):
                with self._lock:
                    if view.state == "starting":
                        view.state = "serving"
                break
            time.sleep(probe_interval_s)
        with self._lock:
            admitted = view.state == "serving"
            if not admitted:
                self._views.pop(replica.id, None)
        if admitted:
            self.metrics.bump("replica_ups")
            events.emit("replica_up", replica=replica.id,
                        generation=getattr(replica, "generation", 0))
        return admitted

    def remove_replica(self, rid, *, quiesce_timeout_s: float = 30.0):
        """Drain a replica out of the fleet and return its handle.

        Marks it ``draining`` (no new routing; in-flight requests finish
        via the existing quiesce machinery), quiesces, then drops the view
        and any pending-recovery bookkeeping. The router never owned the
        replica's lifecycle, so the HANDLE is returned for the caller to
        close/reap. Raises KeyError for an unknown id."""
        with self._lock:
            view = self._views.get(rid)
            if view is None:
                raise KeyError(f"no replica {rid!r} in the fleet")
            view.state = "draining"
        self.metrics.bump("replica_drains")
        events.emit("replica_drain", replica=rid)
        try:
            drained = view.replica.quiesce(quiesce_timeout_s)
        except Exception:  # noqa: BLE001 — a dead replica still gets removed
            drained = False
        if not drained:
            log.warning("replica %s did not quiesce within %.1fs; removing "
                        "anyway", rid, quiesce_timeout_s)
        with self._lock:
            self._views.pop(rid, None)
            self._pending_recovery.pop(rid, None)
        self.metrics.bump("replica_removes")
        return view.replica

    # -- weight hot-swap -----------------------------------------------------
    def roll_weights(self, step: int) -> dict:
        """Roll `step`'s weights across the fleet, one replica at a time:
        stop routing to it (`swapping`), quiesce so every in-flight request
        finishes on the OLD weights, swap, rewarm, resume. A failed swap
        leaves that replica serving its old weights (engine.swap_weights is
        all-or-nothing) — a mixed-version fleet beats a smaller one."""
        with self._swap_lock:
            events.emit("weights_roll", step=step, phase="start")
            swapped: list = []
            failed: list = []
            for rid in sorted(self._views):
                view = self._views.get(rid)
                if view is None:
                    continue  # removed mid-roll (autoscale scale-down)
                with self._lock:
                    if view.state != "serving":
                        failed.append({"replica": rid,
                                       "reason": f"state={view.state}"})
                        continue
                    view.state = "swapping"
                t0 = time.perf_counter()
                rewarm_ms = 0.0
                try:
                    if not view.replica.quiesce(
                            self.config.swap_quiesce_timeout_s):
                        raise TimeoutError(
                            f"replica {rid} did not quiesce")
                    view.replica.swap_to(step)
                    rewarm_ms = view.replica.rewarm()
                except Exception as err:  # noqa: BLE001 — per-replica isolation
                    self.metrics.bump("swap_failures")
                    failed.append({"replica": rid,
                                   "reason": f"{type(err).__name__}: {err}"})
                    log.warning("replica %s swap to step %d failed", rid,
                                step, exc_info=True)
                    with self._lock:
                        view.state = "serving"  # old weights still good
                    events.emit("weights_swap", replica=rid, step=step,
                                ok=False, reason=type(err).__name__)
                    continue
                with self._lock:
                    view.state = "serving"
                self.metrics.bump("swaps")
                swapped.append(rid)
                events.emit(
                    "weights_swap", replica=rid, step=step, ok=True,
                    dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                    rewarm_ms=round(rewarm_ms, 3))
            if swapped:
                self.serving_step = step
            events.emit("weights_roll", step=step, phase="end",
                        swapped=len(swapped), failed=len(failed))
            return {"step": step, "swapped": swapped, "failed": failed}


class CheckpointWatcher:
    """Polls a training run's commit markers (`<dir>/commits/<step>
    .committed` — checkpoint/manager.py's crash-consistency protocol) and
    calls `on_new_step(step)` — typically `Router.roll_weights` — whenever
    a NEWER committed step appears. Markers, not step directories: an
    uncommitted directory may be a torn write, and the manager only
    guarantees restore-eligibility for marked steps."""

    def __init__(self, checkpoint_dir, on_new_step, *,
                 poll_interval_s: float = 2.0,
                 initial_step: int | None = None):
        self._dir = Path(checkpoint_dir)
        self._on = on_new_step
        self._interval = poll_interval_s
        self._last = initial_step
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.polls = 0
        self.rolls = 0

    def latest_committed(self) -> int | None:
        commits = self._dir / "commits"
        if not commits.is_dir():
            return None
        steps = []
        for p in commits.glob("*.committed"):
            try:
                steps.append(int(p.stem))
            except ValueError:
                continue  # not a marker (tmp files, strays)
        return max(steps) if steps else None

    def poll_once(self) -> int | None:
        """One scan; returns the step rolled to, or None. Consumed even on
        a failed roll — a broken checkpoint must not be re-rolled every
        poll (the next COMMIT retriggers naturally)."""
        self.polls += 1
        step = self.latest_committed()
        if step is None or (self._last is not None and step <= self._last):
            return None
        self._last = step
        try:
            self._on(step)
            self.rolls += 1
        except Exception:  # noqa: BLE001 — the watcher outlives a bad roll
            log.exception("weight roll to step %d failed", step)
            return None
        return step

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.poll_once()

    def start(self) -> "CheckpointWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="RouterWatcher", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
