"""InferenceServer: the facade wiring admission -> batcher -> engine and
owning the shutdown order (port of the reference `serve/server.py`).

Lifecycle contract:

    start():  prewarm every cell of the (batch, height) grid up to
              max_batch (default — a first run inside live traffic is a
              latency hole), then start the batcher thread. With
              `prewarm_async` the grid warms on a ``ZooPrewarm`` thread
              while traffic is already served (close() joins it).
    submit(): an image of any height the engine serves (its native one,
              or any up to it with a seq grid); the batcher groups a
              window's requests by shape.
              Admission only; raises QueueFullError / ShuttingDownError
              rather than ever blocking a client.
    close():  (1) close admission; (2) drain — the batcher finishes every
              already-admitted request; (3) join the batcher thread;
              (4) emit the final metrics through `writer`.
              A client holding a Future from a successful submit() WILL
              get a result (or an engine error).

`health` (an `obs.HealthState`) reads ``serving`` after start(),
``draining`` during close() and ``stopped`` after it; the journal gets
``serve_start`` and ``serve_stop``. `quiesce()` waits for every admitted
request to settle while the server stays open (a hot swap's drain step,
`serve/router.py`), and `capacity` is the admission bound a router's
backlog fraction divides by.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

from dist_mnist_tpu_torch.serve.admission import AdmissionQueue
from dist_mnist_tpu_torch.serve.batcher import DynamicBatcher
from dist_mnist_tpu_torch.serve.engine import InferenceEngine
from dist_mnist_tpu_torch.serve.metrics import ServeMetrics

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 64  # coalesce ceiling; beyond engine max_bucket the
    # batcher splits the window into bucket-sized executions
    max_wait_ms: float = 2.0  # coalesce window opened by the first request
    queue_depth: int = 256  # admission bound; beyond it -> QueueFullError
    default_deadline_ms: float | None = None  # per-request override wins
    prewarm: bool = True  # run every (batch, height) cell once first
    prewarm_async: bool = False  # warm the grid on a background
    # "ZooPrewarm" thread while traffic is already served: first requests
    # may pay a cell's first run, but startup stays flat as the 2-D zoo
    # grid multiplies the cells. close() joins the thread; a budget
    # refusal surfaces in stats()["prewarm_error"]


class InferenceServer:
    def __init__(self, engine: InferenceEngine,
                 config: ServeConfig | None = None, *, writer=None,
                 health=None):
        self.engine = engine
        self.config = config or ServeConfig()
        self.metrics = ServeMetrics()
        # a quantized engine's load-time error report becomes the
        # serve/quant_error* metrics surface right away
        if engine.quant_report:
            self.metrics.record_quant_report(engine.quant_report)
        self.writer = writer
        # live /healthz state machine (obs/exporter.HealthState or None):
        # serving after start(), draining during close() — so a router can
        # stop sending to this replica before it disappears
        self.health = health
        self._admission = AdmissionQueue(self.config.queue_depth, self.metrics)
        self._batcher = DynamicBatcher(
            engine, self._admission, self.metrics,
            max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
        )
        self._started = False
        self._closed = False
        self._prewarm_thread: threading.Thread | None = None
        self._prewarm_error: Exception | None = None

    # -- lifecycle -----------------------------------------------------------
    def _prewarm_buckets(self) -> list[int]:
        return [b for b in self.engine.buckets()
                if b <= max(self.config.max_batch, self.engine.min_bucket)]

    def _prewarm(self) -> None:
        try:
            buckets = self._prewarm_buckets()
            n = self.engine.prewarm(buckets)
            log.info("prewarmed %d cell(s) over buckets %s", n, buckets)
        except Exception as err:  # surface via stats(); keep serving
            log.exception("background prewarm failed")
            self._prewarm_error = err

    def start(self) -> "InferenceServer":
        if self._started:
            return self
        if self.config.prewarm:
            if self.config.prewarm_async:
                self._prewarm_thread = threading.Thread(
                    target=self._prewarm, name="ZooPrewarm", daemon=True)
                self._prewarm_thread.start()
            else:
                buckets = self._prewarm_buckets()
                n = self.engine.prewarm(buckets)
                log.info("prewarmed %d cell(s) over buckets %s", n, buckets)
        self._batcher.start()
        self._started = True
        if self.health is not None:
            self.health.set("serving")
        from dist_mnist_tpu_torch.obs import events

        events.emit("serve_start", prewarm=self.config.prewarm,
                    max_batch=self.config.max_batch)
        return self

    def close(self, *, timeout: float = 30.0) -> bool:
        """Reject-new, finish-old; idempotent. Returns drain success."""
        if self._closed:
            return True
        from dist_mnist_tpu_torch.obs import events

        if self.health is not None:
            self.health.set("draining")
        self._admission.close()
        ok = self._batcher.drain(timeout=timeout) if self._started else True
        if not ok:
            log.error("batcher did not drain within %.1fs", timeout)
        if self._prewarm_thread is not None:
            # bounded join: a cell's first run in flight finishes, then the
            # thread exits; close() never leaks a ZooPrewarm thread
            self._prewarm_thread.join(timeout=timeout)
            self._prewarm_thread = None
        self._closed = True
        if self.writer is not None:
            self.emit_metrics(self.writer)
        if self.health is not None:
            self.health.set("stopped", "drained" if ok else "drain timeout")
        events.emit("serve_stop", drained=ok,
                    completed=self.metrics.completed)
        return ok

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- serving -------------------------------------------------------------
    def submit(self, image, *, deadline_ms: float | None = None,
               cancel_event=None):
        """One request -> Future[InferenceResult]. Never blocks."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._admission.submit(image, deadline_ms=deadline_ms,
                                      cancel_event=cancel_event)

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) until every ADMITTED request has settled, without
        closing anything: the hot swap's drain step (serve/router.py's
        drain -> swap -> rewarm) needs an empty pipeline while the server
        stays open for the traffic that resumes after the swap. The caller
        stops submitting first (a router stops routing to a `swapping`
        replica); otherwise new admissions keep the pipeline busy and this
        times out. Returns True when idle."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.metrics.inflight == 0 and self.queue_depth == 0:
                return True
            time.sleep(0.002)
        return False

    # -- observability -------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self._admission.depth

    @property
    def capacity(self) -> int:
        """Admission bound: the denominator of a router's backlog
        fraction."""
        return self._admission.maxsize

    def stats(self) -> dict:
        out = self.metrics.snapshot()
        out["queue_depth"] = self.queue_depth
        out["cache"] = self.engine.cache_stats()
        if self.engine.quant:
            out["quant"] = self.engine.quant
        if self._prewarm_error is not None:
            out["prewarm_error"] = repr(self._prewarm_error)
        return out

    def emit_metrics(self, writer, step: int = 0) -> None:
        self.metrics.emit(writer, step, queue_depth=self.queue_depth,
                          cache=self.engine.cache_stats())
