"""The hooked train loop — MonitoredTrainingSession, functional (port of
the reference `train/loop.py`, one device).

Maps the reference session-wrapper stack (SURVEY.md §2.4 rows 13-16, §3.2/3.3)
onto plain control flow:

- `_HookedSession`'s before/after_run merge (:1414-1508) -> hook calls
  around the step.
- `_CoordinatedSession` + Coordinator (:1347-1411; coordinator.py) ->
  `StopSignal` (request_stop / should_stop / stored exception).
- `_RecoverableSession`'s preemption ring (:1238-1344, retrying only
  `_PREEMPTION_ERRORS` = Aborted/Unavailable, :43-45) -> `max_recoveries` +
  restore-from-checkpoint on a matching error class. In SPMD there is no
  session to rebuild; recovery = reload last checkpoint and continue, which
  is exactly what SessionManager.recover_session did for the chief (§3.2).

Two departures from the reference:

- `runahead` bounds the in-flight steps with a CUDA event recorded after
  each dispatch; the loop synchronizes on the oldest event before the
  next dispatch (the reference waits with `jax.block_until_ready` on the
  oldest step's outputs). On the CPU a step has finished when it returns,
  so the bound costs nothing there.
- `_is_preemption` recognizes `PreemptionError` only. The reference also
  retries a runtime error whose message names an unavailable or aborted
  device (`XlaRuntimeError`); a CUDA error leaves the process's CUDA
  context unusable, so restoring in-process cannot help, and it
  propagates.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Iterable, Sequence

import torch

from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.faults.goodput import GoodputClock
from dist_mnist_tpu_torch.hooks.base import Hook
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)


class PreemptionError(RuntimeError):
    """Raise-able stand-in for a preempted device/host (tests inject it, the
    way upstream injected AbortedError into _RecoverableSession — §4)."""


#: Exceptions treated as recoverable, mirroring _PREEMPTION_ERRORS
#: (monitored_session.py:43-45): `PreemptionError` alone. Matched by type
#: only, never by message, so an application error that mentions
#: "preempt" cannot buy a silent restore.
def _is_preemption(exc: BaseException) -> bool:
    return isinstance(exc, PreemptionError)


class StopSignal:
    """Coordinator analogue (coordinator.py:28-400), minus the threads: the
    loop is single-threaded per process, but hooks and outer code still need
    a cooperative stop + exception channel."""

    def __init__(self):
        self._stop = False
        self.reason: str | None = None
        self.exception: BaseException | None = None

    def request_stop(self, reason: str | None = None,
                     exc: BaseException | None = None) -> None:
        if not self._stop:
            self._stop = True
            self.reason = reason
            self.exception = exc

    def should_stop(self) -> bool:
        return self._stop

    def raise_requested_exception(self) -> None:
        if self.exception is not None:
            raise self.exception


def _dispatched_event(state):
    """A CUDA event recorded on the current stream after the step just
    dispatched, or None when the state lives on the CPU (a CPU step has
    finished when it returns)."""
    step = getattr(state, "step", None)
    if not isinstance(step, torch.Tensor) or step.device.type != "cuda":
        return None
    device = step.device
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class TrainLoop:
    """Run `state = step_fn(state, batch)` over `batches` with hooks.

    `checkpoint_manager` (checkpoint/manager.py) enables preemption
    recovery: on a recoverable error the loop restores the latest
    checkpoint and continues, up to `max_recoveries` times.
    """

    def __init__(
        self,
        step_fn,
        state: TrainState,
        batches: Iterable,
        hooks: Sequence[Hook] = (),
        *,
        checkpoint_manager=None,
        max_recoveries: int = 0,
        steps_per_call: int = 1,
        runahead: int = 0,
        preemption=None,
        span_steps: int = 0,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.hooks = list(hooks)
        self.stop = StopSignal()
        self.checkpoint_manager = checkpoint_manager
        self.max_recoveries = max_recoveries
        # preemption handshake (faults/preemption.py): a PreemptionNotice
        # checked at each step boundary — checkpoint, then stop cleanly
        # with `preempted_at` set, so the process can exit 0.
        self.preemption = preemption
        self.preempted_at: int | None = None
        # goodput attribution (faults/goodput.py): every second of run()'s
        # wall clock lands in a productive/restore/replay/stall bucket.
        self.goodput = GoodputClock()
        # per-step wall time in ms, scrape-able live via the registry and
        # summarized by StepTimeHook / bench.py --faults
        self.step_time_hist = StreamingHistogram()
        # >1 when step_fn executes a CHUNK of steps
        # (train/step.make_scanned_train_fn): hooks fire once per chunk at
        # the post-chunk step number; cadences/stops round up to the chunk.
        self.steps_per_call = steps_per_call
        # dispatch-runahead bound: keep at most `runahead` steps in
        # flight and wait on the OLDEST one's event before dispatching the
        # next call — bounds host runahead (and the memory held by
        # in-flight buffers) without a per-step sync. 0 = unbounded.
        self.runahead = runahead
        self._inflight: collections.deque = collections.deque()
        # input-stall attribution, cumulative seconds (hooks read these —
        # hooks/builtin.InputPipelineHook): time blocked pulling the next
        # batch, and time blocked on the runahead bound.
        self.feed_wait_s = 0.0
        self.runahead_wait_s = 0.0
        self.initial_step = state.step_int
        self._host_step = self.initial_step  # host mirror of state.step:
        # tracks the global step without a device sync per step
        self._first_step_emitted = False  # first_step journal latch
        # correlated step tracing: every `span_steps` steps, journal one
        # `span` event per phase (input_wait / dispatch / h2d) with the
        # step's host-side timings. The (host, gen, step) triple the
        # journal stamps makes the spans line up across hosts in
        # scripts/fleet_trace.py. 0 = off; timings come from clocks the
        # loop already reads, so the gate costs nothing when idle.
        self.span_steps = int(span_steps)
        self._next_span = (self.initial_step + self.span_steps
                           if self.span_steps else None)
        self._h2d_base = 0

    def request_stop(self, reason: str | None = None) -> None:
        self.stop.request_stop(reason)

    def _emit_spans(self, dt_feed: float, dt_step: float) -> None:
        """One sampled step's phase spans into the journal. `dur_ms`
        spans become chrome-trace complete events (start reconstructed
        as ts - dur); the h2d span has no duration signal — only the
        byte counter from the prefetch ring — so it journals as a
        counter sample and renders as an instant."""
        step = self._host_step
        events.emit("span", name="input_wait", step=step,
                    dur_ms=round(dt_feed * 1e3, 3))
        events.emit("span", name="dispatch", step=step,
                    dur_ms=round(dt_step * 1e3, 3))
        stats_fn = getattr(self.batches, "stats", None)
        if callable(stats_fn):
            h2d = int(stats_fn().get("h2d_bytes", 0))
            base, self._h2d_base = self._h2d_base, h2d
            events.emit("span", name="h2d", step=step,
                        bytes=max(0, h2d - base))

    def _honor_preemption(self) -> None:
        """Consume a preemption notice at a step boundary: persist state
        durably, record `preempted_at`, and stop cleanly — hooks and the
        prefetch worker drain through run()'s normal finally path. The
        reference had no such handshake: SIGTERM mid-step simply killed
        the worker and the next start replayed from the last checkpoint."""
        step = self._host_step
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.save(self.state)
            self.checkpoint_manager.wait()  # durable BEFORE the process exits
        self.preempted_at = step
        log.warning(
            "preemption notice (%s) honored at step boundary %d; "
            "checkpoint %s — stopping cleanly",
            getattr(self.preemption, "reason", None), step,
            "saved" if self.checkpoint_manager is not None else "skipped",
        )
        events.emit(
            "preemption", step=step,
            reason=getattr(self.preemption, "reason", None),
            checkpoint_saved=self.checkpoint_manager is not None,
        )
        self.request_stop(f"preempted@step={step}")

    def run(self) -> TrainState:
        for h in self.hooks:
            h.begin(self)
        recoveries = 0
        it = iter(self.batches)
        g = self.goodput
        g.start()
        try:
            while not self.stop.should_stop():
                # preemption handshake: consumed only at step boundaries,
                # so the saved checkpoint is always a whole-step state
                # (with several ranks, a notice any rank holds stops all
                # of them at the same boundary: one host all-reduce a step)
                if self.preemption is not None and coordination.any_rank(
                        self.preemption.requested()):
                    self._honor_preemption()
                    break
                t_feed = time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    self.request_stop("data exhausted")
                    break
                dt_feed = time.monotonic() - t_feed
                self.feed_wait_s += dt_feed
                g.add_stall(dt_feed)
                try:
                    # runahead bound: before dispatching this call, wait on
                    # the OLDEST in-flight output — one wait per step, never
                    # a sync on the step just dispatched
                    if self.runahead and len(self._inflight) >= self.runahead:
                        t_wait = time.monotonic()
                        done = self._inflight.popleft()
                        if done is not None:
                            done.synchronize()
                        dt_wait = time.monotonic() - t_wait
                        self.runahead_wait_s += dt_wait
                        g.add_stall(dt_wait)
                    # step number BEFORE the step executes == the step being
                    # run; hooks see the post-step number like global_step
                    # reads did after the AssignAdd (§3.3).
                    t_step = time.monotonic()
                    for h in self.hooks:
                        h.before_step(self._host_step)
                    new_state, outputs = self.step_fn(self.state, batch)
                    self.state = new_state
                    self._host_step += self.steps_per_call
                    if self.runahead:
                        self._inflight.append(_dispatched_event(self.state))
                    # synchronous compile time a step wrapper reports
                    # (`consume_compile_s`, when it has one) — charged to
                    # the goodput compile bucket BEFORE after_step fires
                    compile_s = 0.0
                    consume = getattr(self.step_fn, "consume_compile_s", None)
                    if consume is not None:
                        compile_s = consume()
                        if compile_s:
                            g.add_compile(compile_s)
                    for h in self.hooks:
                        h.after_step(self._host_step, self.state, outputs)
                    # hook-side checkpoint save time (blocking write on the
                    # sync path, fork+dispatch + attributed stall on the
                    # async snapshot path) — split into the save_s bucket
                    # and OUT of productive, exactly like compile_s
                    save_s = 0.0
                    for h in self.hooks:
                        consume_save = getattr(h, "consume_save_s", None)
                        if consume_save is not None:
                            save_s += consume_save()
                    if save_s:
                        g.add_save(save_s)
                    dt_step = max(0.0, time.monotonic() - t_step - compile_s
                                  - save_s)
                    # per-STEP wall time even when step_fn runs a chunk
                    self.step_time_hist.observe(
                        dt_step * 1e3 / self.steps_per_call)
                    if (self._next_span is not None
                            and self._host_step >= self._next_span):
                        self._next_span = self._host_step + self.span_steps
                        self._emit_spans(dt_feed, dt_step)
                    if g.in_replay:
                        # catching back up to the pre-failure step: correct
                        # work, but no NEW progress — charged to replay, and
                        # to the open recovery event's latency
                        g.note_replay(dt_step, self.steps_per_call,
                                      at_step=self._host_step)
                    else:
                        g.add_productive(dt_step)
                    if not self._first_step_emitted:
                        # one journal mark per process run: closes the
                        # supervisor-level failure->frontier window that
                        # faults.goodput.elastic_summary measures across
                        # generations
                        self._first_step_emitted = True
                        events.emit("first_step", step=self._host_step,
                                    process=0)
                except Exception as exc:  # noqa: BLE001 — classified below
                    # in-flight events mark pre-failure work; waiting on
                    # them after a restore could resurface the same error
                    self._inflight.clear()
                    if not (
                        _is_preemption(exc)
                        and self.checkpoint_manager is not None
                        and recoveries < self.max_recoveries
                    ):
                        raise
                    recoveries += 1
                    log.warning(
                        "recoverable failure (%s); restore attempt %d/%d",
                        exc, recoveries, self.max_recoveries,
                    )
                    t_restore = time.monotonic()
                    restored = self.checkpoint_manager.restore(self.state)
                    if restored is None:
                        raise
                    self.state = restored
                    failed_at = self._host_step
                    self._host_step = self.state.step_int
                    # re-seek the input stream to the restored step so the
                    # recovered trajectory equals the uninterrupted one
                    # (batches consumed between checkpoint and failure must
                    # be replayed, not skipped)
                    if hasattr(self.batches, "at_step"):
                        if hasattr(it, "close"):
                            it.close()  # drain a prefetch worker promptly
                        self.batches = self.batches.at_step(self._host_step)
                        it = iter(self.batches)
                    restore_s = time.monotonic() - t_restore
                    g.begin_recovery(
                        failed_at_step=failed_at,
                        restored_step=self._host_step,
                        restore_s=restore_s,
                    )
                    events.emit(
                        "restore", failed_at_step=failed_at,
                        restored_step=self._host_step,
                        restore_ms=round(restore_s * 1e3, 3),
                        recovery=recoveries,
                    )
        finally:
            g.close()
            self._inflight.clear()
            # generators (incl. DevicePrefetcher streams) drain their
            # resources here — on normal exit AND on an escaping exception
            if hasattr(it, "close"):
                it.close()
            for h in self.hooks:
                try:
                    h.end(self.state)
                except Exception:  # noqa: BLE001 — end() must not mask body
                    log.exception("hook %s.end failed", type(h).__name__)
        return self.state
