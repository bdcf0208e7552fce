"""Asynchronous device-prefetch ring between a batch iterator and the loop
(port of the reference `data/prefetch.py`, one CUDA device).

The reference hid input latency behind queue runners and staged feeds
(SURVEY.md §2.1/§3.3); the SPMD rebuild's host batchers lost that overlap:
`ShardedBatcher.__iter__` gathered numpy rows and issued the sharded
`device_put` inline in the hot loop, so every step paid H2D transfer
serially before dispatch. `DevicePrefetcher` restores the overlap: a
background worker pulls host batches from the wrapped iterator, copies each
into pinned host memory and issues its `non_blocking` host-to-device copy
on a side CUDA stream, `depth` batches ahead of the loop, so the copies
overlap the running step.

The consumer (the loop's thread) makes its current stream wait on an event
recorded after each batch's copy before it uses the batch, and calls
`record_stream` on the batch's tensors, so the caching allocator does not
hand their memory to the side stream again while the loop's stream may
still read them. On the CPU the worker only wraps the numpy rows as
tensors.

The wrapped batcher is a `ShardedBatcher` (data/pipeline.py), or anything
with its `host_batches()`, `.device` and `at_step(step)`: the worker pulls
HOST batches and issues the copies itself, so the transfer moves off the
training thread entirely.

Determinism: the ring never reorders or drops batches, so a prefetched feed
yields the bit-identical stream (and loss trajectory) of the sync feed.
`at_step(step)` re-seeks by re-seeking the wrapped iterator — the
preemption-recovery replay contract (train/loop.py restore path) passes
straight through; cumulative stats survive the re-seek (shared object).

Cleanup: every stream's worker drains and joins on StopIteration of the
inner iterator, on an exception in it (re-raised in the consumer), and on
generator close (`iter(...).close()` — what TrainLoop calls in its
`finally`). Workers are named `DevicePrefetcher-*` so tests can assert
none leak (tests/conftest.py fixture).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

#: worker-thread name prefix — the leak-check contract (tests/conftest.py)
THREAD_NAME_PREFIX = "DevicePrefetcher"

_POLL_S = 0.05  # stop-flag poll granularity for blocking queue ops


class _EndOfStream:
    """Sentinel: the wrapped iterator exhausted; worker exited cleanly."""


class _Raised:
    """Sentinel: the wrapped iterator raised; deliver to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchStats:
    """Cumulative prefetch counters, thread-safe, SHARED across `at_step`
    re-seeks (recovery must not zero the run's attribution)."""

    def __init__(self, depth: int):
        self.depth = depth
        self._lock = threading.Lock()
        self.batches = 0            # batches delivered to the consumer
        self.h2d_bytes = 0          # bytes issued to devices by the worker
        self.get_wait_s = 0.0       # consumer time blocked on an empty ring
        self.occupancy_sum = 0      # ring size sampled at each get
        self.occupancy_samples = 0

    def record_transfer(self, nbytes: int) -> None:
        with self._lock:
            self.h2d_bytes += nbytes

    def record_get(self, wait_s: float, occupancy: int) -> None:
        with self._lock:
            self.batches += 1
            self.get_wait_s += wait_s
            self.occupancy_sum += occupancy
            self.occupancy_samples += 1

    def as_dict(self) -> dict:
        with self._lock:
            occ = (self.occupancy_sum / self.occupancy_samples
                   if self.occupancy_samples else 0.0)
            return {
                "depth": self.depth,
                "batches": self.batches,
                "h2d_bytes": self.h2d_bytes,
                "get_wait_s": self.get_wait_s,
                "mean_occupancy": occ,
            }


class _Staged:
    """A batch whose copy to the device was issued on the side stream;
    `ready` is the event recorded after it (None on the CPU)."""

    def __init__(self, batch: dict, ready=None, device=None):
        self.batch = batch
        self.ready = ready
        self.device = device

    def take(self) -> dict:
        """The batch, safe to use on the caller's current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.ready)
            for t in self.batch.values():
                t.record_stream(stream)
        return self.batch


def _stage_on(device: torch.device):
    """The worker's transfer for `device`: numpy rows -> pinned host
    tensors -> a non_blocking copy on a side stream, with its event."""
    if device.type != "cuda":
        return lambda host: _Staged(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in host.items()})
    copy_stream = torch.cuda.Stream(device)

    def stage(host: dict) -> _Staged:
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in host.items()}
        with torch.cuda.stream(copy_stream):
            batch = {k: t.to(device, non_blocking=True)
                     for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return _Staged(batch, ready, device)

    return stage


class _Stream:
    """One live iteration: a worker filling a bounded ring."""

    def __init__(self, source: Iterator, transfer, depth: int,
                 stats: PrefetchStats):
        self._source = source
        self._transfer = transfer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stats = stats
        self._thread = threading.Thread(
            target=self._produce,
            name=f"{THREAD_NAME_PREFIX}-{id(self):x}",
            daemon=True,
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that yields to the stop flag (a plain blocking put
        on a full ring would deadlock close())."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for host in self._source:
                if self._stop.is_set():
                    return
                staged = self._transfer(host)  # issues the H2D copy
                self._stats.record_transfer(sum(
                    t.numel() * t.element_size()
                    for t in staged.batch.values()))
                if not self._put(staged):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised by consumer
            self._put(_Raised(exc))
        else:
            self._put(_EndOfStream)

    def get(self):
        occupancy = self._q.qsize()
        t0 = time.monotonic()
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # worker died without a sentinel (killed interpreter
                    # teardown path) — treat as end of stream, don't spin
                    item = _EndOfStream
                    break
        self._stats.record_get(time.monotonic() - t0, occupancy)
        return item

    def close(self) -> None:
        self._stop.set()
        # unblock a producer waiting on a full ring, then reap the thread
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class DevicePrefetcher:
    """Wrap a host batcher; yield its batches `depth` transfers ahead.

    >>> batches = DevicePrefetcher(ShardedBatcher(ds, 512, "cuda"), depth=2)
    >>> for batch in batches: ...   # batch is already on device

    `at_step(step)` delegates to the wrapped iterator (TrainLoop recovery
    re-seek) and keeps the cumulative `stats()`. `close()` stops every
    stream this instance started; per-iteration cleanup also happens
    automatically when the iterator is closed or exhausted.
    """

    def __init__(self, inner, depth: int = 2, *, stats: PrefetchStats = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if not callable(getattr(inner, "host_batches", None)) or getattr(
                inner, "device", None) is None:
            raise TypeError(
                f"{type(inner).__name__} is not a host batcher: the "
                "prefetcher needs host_batches() and .device "
                "(data/pipeline.ShardedBatcher)")
        self.inner = inner
        self.depth = depth
        self._stats = stats if stats is not None else PrefetchStats(depth)
        self._streams: list[_Stream] = []
        self._lock = threading.Lock()

    def at_step(self, step: int) -> "DevicePrefetcher":
        """Re-seek pass-through: a prefetcher over `inner.at_step(step)`,
        sharing this instance's cumulative stats."""
        return DevicePrefetcher(self.inner.at_step(step), self.depth,
                                stats=self._stats)

    def stats(self) -> dict:
        return self._stats.as_dict()

    def __iter__(self) -> Iterator:
        stream = _Stream(self.inner.host_batches(),
                         _stage_on(torch.device(self.inner.device)),
                         self.depth, self._stats)
        with self._lock:
            self._streams.append(stream)
        try:
            while True:
                item = stream.get()
                if item is _EndOfStream:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                yield item.take()
        finally:
            stream.close()
            with self._lock:
                if stream in self._streams:
                    self._streams.remove(stream)

    def close(self) -> None:
        with self._lock:
            streams, self._streams = self._streams, []
        for s in streams:
            s.close()
