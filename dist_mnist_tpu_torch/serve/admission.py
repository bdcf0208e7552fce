"""Admission control: the bounded queue between clients and the batcher.

(Copy of the reference package's `serve/admission.py`.)

Overload policy is *reject-new, finish-old*: a full queue refuses the new
request immediately (`QueueFullError`) instead of growing an unbounded
backlog whose tail would time out anyway — the client gets a clear signal
to back off NOW, and every admitted request still has a bounded wait. This
is the serving analogue of the training side's bounded host->device
prefetch (data/pipeline.py): memory use is fixed, pressure is explicit.

Deadlines are per-request and checked at *dequeue* time by the batcher: a
request that waited past its deadline is expired (its future raises
`DeadlineExceededError`) rather than executed — computing an answer the
client has already abandoned wastes a batch slot someone live could use.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class QueueFullError(RuntimeError):
    """Rejected at admission: the bounded queue is full — back off."""


class ShuttingDownError(RuntimeError):
    """Rejected at admission: the server is draining and accepts no new work."""


class DeadlineExceededError(TimeoutError):
    """Admitted, but expired in queue before execution."""


@dataclasses.dataclass
class Request:
    image: np.ndarray
    future: Future
    t_submit: float  # time.monotonic() at admission
    deadline: float | None  # absolute monotonic instant, None = no deadline
    # optional threading.Event a router sets to withdraw the request (hedge
    # loser cancellation); checked at dequeue like the deadline
    cancel_event: threading.Event | None = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def cancelled(self) -> bool:
        return self.cancel_event is not None and self.cancel_event.is_set()


@dataclasses.dataclass
class InferenceResult:
    logits: np.ndarray  # [classes]
    label: int
    latency_ms: float


class AdmissionQueue:
    """Bounded MPSC queue: many client threads submit, one batcher drains."""

    def __init__(self, depth: int, metrics):
        if depth < 1:
            raise ValueError("queue depth must be >= 1")
        self._q: queue.Queue[Request] = queue.Queue(maxsize=depth)
        self._metrics = metrics
        self._closed = threading.Event()

    def submit(self, image: np.ndarray, *,
               deadline_ms: float | None = None,
               cancel_event: threading.Event | None = None) -> Future:
        """Admit one request; returns a Future resolving to an
        InferenceResult. Raises instead of blocking when the server is
        draining or the queue is full — admission never stalls a client."""
        if self._closed.is_set():
            self._metrics.record_rejected("shutdown")
            raise ShuttingDownError("server is draining; request rejected")
        now = time.monotonic()
        req = Request(
            image=np.asarray(image),
            future=Future(),
            t_submit=now,
            deadline=now + deadline_ms / 1e3 if deadline_ms is not None else None,
            cancel_event=cancel_event,
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._metrics.record_rejected("queue_full")
            raise QueueFullError(
                f"admission queue full ({self._q.maxsize}); back off"
            ) from None
        self._metrics.record_admitted()
        return req.future

    def get(self, timeout: float) -> Request | None:
        """One request, or None after `timeout` seconds of empty queue."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def get_nowait(self) -> Request | None:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        """Stop admitting. Already-queued requests stay and will be drained."""
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    @property
    def depth(self) -> int:
        return self._q.qsize()

    @property
    def maxsize(self) -> int:
        return self._q.maxsize
