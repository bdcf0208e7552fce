"""Injector shims: where a `FaultPlan`'s faults land (port of the
reference `faults/inject.py`).

Each shim wraps one seam of the real system and injects ITS fault kinds,
delegating everything else untouched — the wrapped object's contract
(at_step/close on iterators, save/restore on the checkpoint manager,
predict on the serve engine) is kept, so the shims compose with the
production wiring (the prefetcher under the stall shim, CheckpointHook
holding the wrapped manager, the DynamicBatcher holding the wrapped
engine).

Injection points, chosen so each fault exercises the REAL recovery path:

- preempt: raised from `FaultInjectionHook.before_step`, which the loop
  calls inside its recovery try-block with the loop's own host step —
  the one clock that stays correct across restores.
- kill_host: the victim rank SIGKILLs itself at its step, in generation
  0 only; the elastic supervisor (cli/launch.py) takes the attribution.
- corrupt_checkpoint: applied to the on-disk step directory at RESTORE
  time, after `wait()`. The largest file of a port step directory is
  ``state.pt``; its truncation fails torch's reader or meta.json's crc32,
  and `CheckpointManager.restore` quarantines the step and falls back.
- stall_input: a sleep in the batch feed, visible to the loop as feed
  wait (goodput stall bucket) like any real input outage.
- serve_error / serve_replica_kill / serve_replica_stall: raised or slept
  in `predict()` under the DynamicBatcher.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from pathlib import Path

from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.faults.plan import FaultPlan
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.train.loop import PreemptionError

log = logging.getLogger(__name__)


def _rank() -> int:
    ctx = coordination.context()
    return 0 if ctx is None else ctx.rank


class FaultInjectionHook:
    """Raises planned preemptions at the loop's step clock, and lands a
    planned host loss on its victim.

    `before_step(step)` runs inside TrainLoop's try-block, so the raise
    takes the production recovery path: classify via `_is_preemption`,
    restore the latest checkpoint, re-seek the input stream, replay."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def begin(self, loop) -> None:
        pass

    def before_step(self, step: int) -> None:
        # >= not ==: a chunked loop (steps_per_call > 1) can cross the
        # trigger without landing on it; `fired` keeps it at-most-once,
        # so replayed steps below the trigger never re-raise
        for f in self.plan.pending("preempt"):
            if f.step is not None and step >= f.step:
                f.fired = True
                log.warning("fault injected: preemption at step %d", step)
                events.emit("fault_injected", kind="preempt", step=step)
                raise PreemptionError(f"injected preemption at step {step}")
        self._maybe_kill_host(step)

    def _maybe_kill_host(self, step: int) -> None:
        # kill_host: the VICTIM SIGKILLs itself at an exact step. Fires in
        # generation 0 only: later generations re-parse the plan with
        # fresh latches, and a restored worker replaying past the trigger
        # must not die again (the elastic supervisor tracks the loss by
        # membership, not by re-injection). In generation 0 the rank is
        # the host id.
        for f in self.plan.pending("kill_host"):
            if f.step is None or step < f.step:
                continue
            if int(os.environ.get(events.ENV_GENERATION, "0") or 0) != 0:
                f.fired = True
                continue
            if _rank() != (f.process or 0):
                continue
            f.fired = True
            log.warning("fault injected: kill_host p%d (SIGKILL self) at "
                        "step %d", f.process or 0, step)
            events.emit("fault_injected", kind="kill_host", step=step,
                        process=f.process or 0)
            os.kill(os.getpid(), signal.SIGKILL)

    def after_step(self, step: int, state, outputs) -> None:
        pass

    def end(self, state) -> None:
        pass


class FaultyBatches:
    """Batch-stream wrapper injecting input stalls.

    Keeps the stream contract the loop relies on — `at_step` re-seek
    (keeping this wrapper and its plan across recoveries) and generator
    `close()` propagation — so it can sit above ShardedBatcher,
    NativeBatcher or DevicePrefetcher."""

    def __init__(self, inner, plan: FaultPlan, *, start_step: int = 0):
        self._inner = inner
        self._plan = plan
        self._start = start_step

    def at_step(self, step: int) -> "FaultyBatches":
        inner = (self._inner.at_step(step)
                 if hasattr(self._inner, "at_step") else self._inner)
        return FaultyBatches(inner, self._plan, start_step=step)

    def __iter__(self):
        it = iter(self._inner)
        step = self._start
        try:
            while True:
                for f in self._plan.pending("stall_input"):
                    if f.step is not None and step >= f.step:
                        f.fired = True
                        log.warning("fault injected: input stall %.2fs at "
                                    "step %d", f.seconds or 0.0, step)
                        events.emit("fault_injected", kind="stall_input",
                                    step=step, seconds=f.seconds or 0.0)
                        time.sleep(f.seconds or 0.0)
                try:
                    batch = next(it)
                except StopIteration:
                    return
                yield batch
                step += 1
        finally:
            if hasattr(it, "close"):
                it.close()  # drain a prefetch worker promptly

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _corrupt_step_dir(step_dir: Path, mode: str = "truncate") -> Path | None:
    """Damage the step's LARGEST file (``state.pt``, the payload, not
    ``meta.json``) — the partial write or short read a preempted writer or
    a bad disk produces. Returns the damaged path (None if nothing to
    damage)."""
    files = sorted(
        (p for p in step_dir.rglob("*") if p.is_file()),
        key=lambda p: (p.stat().st_size, str(p)),
        reverse=True,
    )
    if not files:
        return None
    target = files[0]
    if mode == "delete":
        target.unlink()
    else:
        with open(target, "r+b") as fh:
            fh.truncate(max(1, target.stat().st_size // 2))
    return target


class FaultyCheckpointManager:
    """Checkpoint-manager wrapper corrupting planned steps on disk.

    Corruption happens at RESTORE time (after `wait()`, so pending writes
    have landed) rather than at save time: deterministic whatever the
    save timing, and it exercises exactly the unreadable-latest path that
    `CheckpointManager.restore`'s fallback ladder defends. Only the chief
    damages the file (the one copy every rank reads)."""

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self._plan = plan

    def restore(self, target_state):
        for f in self._plan.pending("corrupt_checkpoint"):
            if f.step is None:
                continue
            step_dir = Path(self._inner.directory) / str(f.step)
            self._inner.wait()
            # every rank takes the chief's view of the directory
            if not coordination.agree(step_dir.exists()):
                continue  # not on disk yet; stays pending for a later restore
            damaged = (_corrupt_step_dir(step_dir, mode=f.mode)
                       if coordination.is_chief() else None)
            f.fired = True
            log.warning("fault injected: %s checkpoint step %d (%s)",
                        f.mode, f.step, damaged)
            events.emit("fault_injected", kind="corrupt_checkpoint",
                        step=f.step, mode=f.mode)
        return self._inner.restore(target_state)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyEngine:
    """Serve-engine wrapper raising on a planned predict-call ordinal.

    - ``serve_error``: one transient raise — the DynamicBatcher must fail
      only that batch's futures and keep serving.
    - ``serve_replica_kill`` (scoped by ``replica_id``): the engine goes
      PERMANENTLY dead — the fired call and every call after it raise
      ReplicaKilledError.
    - ``serve_replica_stall`` (scoped): one sleep inside predict.

    Ordinals count THIS engine's predict calls, so one shared plan
    targets replicas independently."""

    def __init__(self, inner, plan: FaultPlan, *,
                 replica_id: int | None = None):
        self._inner = inner
        self._plan = plan
        self._replica_id = replica_id
        self._calls = 0
        self._dead = False

    def _mine(self, kind: str):
        return [f for f in self._plan.pending(kind)
                if f.replica is None or f.replica == self._replica_id]

    def predict(self, *args, **kwargs):
        from dist_mnist_tpu_torch.serve.errors import ReplicaKilledError

        if self._dead:
            raise ReplicaKilledError(
                f"replica {self._replica_id}: engine is dead (injected kill)")
        call = self._calls
        self._calls += 1
        for f in self._mine("serve_replica_kill"):
            if f.request is not None and call >= f.request:
                f.fired = True
                self._dead = True
                log.warning("fault injected: replica %s killed on predict "
                            "call %d", self._replica_id, call)
                events.emit("fault_injected", kind="serve_replica_kill",
                            replica=self._replica_id, call=call)
                raise ReplicaKilledError(
                    f"replica {self._replica_id}: injected kill on predict "
                    f"call {call}")
        for f in self._mine("serve_replica_stall"):
            if f.request is not None and call >= f.request:
                f.fired = True
                log.warning("fault injected: replica %s stalls %.2fs on "
                            "predict call %d", self._replica_id,
                            f.seconds or 0.0, call)
                events.emit("fault_injected", kind="serve_replica_stall",
                            replica=self._replica_id, call=call,
                            seconds=f.seconds or 0.0)
                time.sleep(f.seconds or 0.0)
        for f in self._plan.pending("serve_error"):
            if f.request is not None and call >= f.request:
                f.fired = True
                log.warning("fault injected: serve engine error on predict "
                            "call %d", call)
                events.emit("fault_injected", kind="serve_error", call=call)
                raise RuntimeError(
                    f"injected serve engine error on predict call {call}")
        return self._inner.predict(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyStepFn:
    """Standalone step_fn wrapper raising planned preemptions by CALL count.

    Its clock counts calls from `initial_step`, so after an in-loop
    restore the replayed steps advance it PAST the global step: fine for
    a bare step_fn, wrong as the trigger clock inside a recovering
    TrainLoop (which uses `FaultInjectionHook`)."""

    def __init__(self, step_fn, plan: FaultPlan, *, initial_step: int = 0):
        self._fn = step_fn
        self._plan = plan
        self._step = initial_step

    def __call__(self, state, batch):
        step = self._step
        for f in self._plan.pending("preempt"):
            if f.step is not None and step >= f.step:
                f.fired = True
                raise PreemptionError(
                    f"injected preemption at step call {step}")
        out = self._fn(state, batch)
        self._step += 1
        return out
