"""The continuous dynamic batcher: one daemon thread coalescing admitted
single-example requests into padded engine batches (port of the
reference `serve/batcher.py`).

Policy (continuous batching, not fixed-window): the FIRST request out of
the queue opens a coalesce window; the batcher then drains whatever else
is already queued and keeps waiting for stragglers until either
`max_batch` requests are in hand or `max_wait_ms` has elapsed since the
window opened. Expired requests are dropped at dequeue and never occupy
a batch slot.

Single consumer by design: the device executes one batch at a time, so
one thread removes every locking question from the hot path. Failure
isolation: an engine exception fails the *batch's* futures, not the
server — the loop keeps serving.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import CancelledError

import numpy as np

from dist_mnist_tpu_torch.serve.admission import (
    AdmissionQueue,
    DeadlineExceededError,
    InferenceResult,
    Request,
)

log = logging.getLogger(__name__)

# how long the idle loop blocks on an empty queue before re-checking the
# stop flag; latency-invisible (a request arriving mid-block wakes the get)
_IDLE_POLL_SECS = 0.05


class DynamicBatcher:
    def __init__(self, engine, admission: AdmissionQueue, metrics, *,
                 max_batch: int = 64, max_wait_ms: float = 2.0):
        # max_batch MAY exceed the engine's max_bucket: an oversized
        # coalesce window is split into max_bucket-sized engine batches
        self.engine = engine
        self.admission = admission
        self.metrics = metrics
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ServeBatcher", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    # -- collection ----------------------------------------------------------
    def _collect(self) -> list[Request]:
        """Block for a first request, then coalesce until max_batch or the
        window deadline. Returns [] on an idle timeout (caller re-loops)."""
        first = self.admission.get(timeout=_IDLE_POLL_SECS)
        if first is None:
            return []
        batch = [first]
        window_ends = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = window_ends - time.monotonic()
            if remaining <= 0:
                break
            req = self.admission.get_nowait()
            if req is None:
                req = self.admission.get(timeout=remaining)
                if req is None:
                    break
            batch.append(req)
        return batch

    # -- execution -----------------------------------------------------------
    def _run_batch(self, batch: list[Request]) -> None:
        now = time.monotonic()
        live: list[Request] = []
        for req in batch:
            if req.cancelled:
                self.metrics.record_cancelled()
                req.future.set_exception(CancelledError(
                    "request cancelled before execution"))
            elif req.expired(now):
                self.metrics.record_rejected("deadline")
                req.future.set_exception(DeadlineExceededError(
                    f"expired in queue after "
                    f"{(now - req.t_submit) * 1e3:.1f} ms"))
            else:
                live.append(req)
        for i in range(0, len(live), self.engine.max_bucket):
            self._execute(live[i:i + self.engine.max_bucket])

    def _execute(self, reqs: list[Request]) -> None:
        """One engine call for `reqs` (<= max_bucket of them)."""
        try:
            logits = self.engine.predict(np.stack([r.image for r in reqs]))
        except Exception as err:  # fail the batch, keep the server
            log.exception("batch of %d failed", len(reqs))
            self.metrics.record_failed(len(reqs))
            for req in reqs:
                req.future.set_exception(err)
            return
        done = time.monotonic()
        self.metrics.record_batch(len(reqs),
                                  self.engine.bucket_for(len(reqs)))
        for req, row in zip(reqs, logits):
            latency_ms = (done - req.t_submit) * 1e3
            self.metrics.record_latency(latency_ms)
            req.future.set_result(InferenceResult(
                logits=row, label=int(row.argmax()), latency_ms=latency_ms))

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch:
                self._run_batch(batch)
            elif self._stop.is_set() and self.admission.depth == 0:
                return

    # -- shutdown ------------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful stop: finish everything already admitted, then exit the
        loop. The admission queue must be closed FIRST (server.py does).
        Returns False if the thread didn't exit within `timeout`."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()
