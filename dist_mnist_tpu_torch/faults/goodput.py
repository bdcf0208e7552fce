"""Goodput accounting: wall-time attribution for the train loop.

The reference had no notion of goodput — a preempted worker simply
re-ran `prepare_session` and the lost minutes were invisible (SURVEY.md
§3.2). Here every second of the loop's wall clock is attributed to one
of four buckets, so resilience work (faults/, checkpoint fallback,
supervised restarts) has a metric to move:

- ``productive_s`` — steps that advanced the FRONTIER of training.
- ``replay_s``     — steps re-executed after a restore to get back to
                     the pre-failure step (the recovered trajectory must
                     equal the uninterrupted one — train/loop.py re-seeks
                     the input stream — so these are real, correct steps,
                     but they produced no NEW progress).
- ``restore_s``    — checkpoint restore + input re-seek on recovery.
- ``stall_s``      — blocked pulling the next batch or on the runahead
                     bound (the InputPipelineHook's feed/runahead clocks,
                     summed).
- ``compile_s``    — synchronous XLA compile or executable-store load of
                     a step program (the warm-start tier, compilecache/;
                     reported by the step wrapper's `consume_compile_s`).
                     A restart generation that warm-starts shows
                     milliseconds here where a cold one shows seconds —
                     the compile cost PR 4's supervisor made recurring.
- ``resize_s``     — elastic mesh re-formation: the window between a
                     membership change (host lost or recovered) and the
                     first step of the re-formed generation. Priced
                     separately from restore/replay because it is the
                     cost the elastic supervisor (cli/launch.py
                     --elastic) is designed to shrink: no backoff, no
                     full-world restart, warm-started executables at the
                     new mesh shape.
- ``save_s``       — host-side checkpoint save time spent inside the
                     step window: the blocking orbax write on the sync
                     path, or only fork+dispatch (plus any attributed
                     write-behind ``save_stall``) on the async snapshot
                     path (checkpoint/snapshot.py). Split out of
                     "productive" so `bench.py --ckpt` can show the
                     async layer actually moving save cost off the
                     critical path.

``goodput_fraction = productive_s / total_wall_s`` — everything not in
the productive bucket (including untracked overhead: hook bodies, eval,
checkpoint saves) is lost goodput. Per-recovery events additionally
record ``latency_s = restore_s + replay_s`` — the wall time from the
failure to the first post-failure step that advanced the frontier —
which `bench.py --faults` reports as ``recovery_latency_ms``.

Stdlib-only on purpose: train/loop.py imports this module at its top,
so it must not pull torch or the rest of the faults package. (A copy of
the reference's `faults/goodput.py`.)
"""

from __future__ import annotations

import time


class GoodputClock:
    """Bucketed wall-clock attribution + per-recovery latency events.

    Owned and fed by `TrainLoop` (one instance per loop); read by
    `GoodputHook` and by bench harnesses via `snapshot()`.
    """

    def __init__(self):
        self.productive_s = 0.0
        self.replay_s = 0.0
        self.restore_s = 0.0
        self.stall_s = 0.0
        self.compile_s = 0.0
        self.resize_s = 0.0
        self.save_s = 0.0
        self.replayed_steps = 0
        #: one dict per recovery: failed_at_step, restored_step, restore_s,
        #: replay_s, replayed_steps, complete, latency_s (once known)
        self.events: list[dict] = []
        self._t0: float | None = None
        self._t_end: float | None = None
        self._open: dict | None = None  # recovery currently being replayed

    # -- loop feed points ---------------------------------------------------

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()

    def add_stall(self, dt: float) -> None:
        self.stall_s += dt

    def add_productive(self, dt: float) -> None:
        self.productive_s += dt

    def add_compile(self, dt: float) -> None:
        self.compile_s += dt

    def add_resize(self, dt: float) -> None:
        """Mesh re-formation time (elastic shrink/grow). Fed by harnesses
        that observe the whole supervised run — an individual generation
        cannot see its own bring-up window."""
        self.resize_s += dt

    def add_save(self, dt: float) -> None:
        """Checkpoint save time spent inside the step window (hook-side
        dispatch and/or blocking write; reported by CheckpointHook's
        `consume_save_s`, subtracted from the step's productive time by
        the loop exactly like compile_s)."""
        self.save_s += dt

    @property
    def in_replay(self) -> bool:
        return self._open is not None

    def begin_recovery(self, *, failed_at_step: int, restored_step: int,
                       restore_s: float) -> None:
        """A restore just completed: open a recovery event. Replay time is
        charged to it until the loop re-reaches `failed_at_step`."""
        self.restore_s += restore_s
        ev = {
            "failed_at_step": failed_at_step,
            "restored_step": restored_step,
            "restore_s": restore_s,
            "replay_s": 0.0,
            "replayed_steps": 0,
            "complete": False,
        }
        self.events.append(ev)
        self._open = ev
        if restored_step >= failed_at_step:
            # checkpoint landed exactly at the failure step: nothing to replay
            self._finish_open()

    def note_replay(self, dt: float, steps: int, *, at_step: int) -> None:
        """A step executed while catching back up to the failure point."""
        self.replay_s += dt
        self.replayed_steps += steps
        if self._open is not None:
            self._open["replay_s"] += dt
            self._open["replayed_steps"] += steps
            if at_step >= self._open["failed_at_step"]:
                self._finish_open()

    def _finish_open(self) -> None:
        ev, self._open = self._open, None
        if ev is not None:
            ev["complete"] = True
            ev["latency_s"] = ev["restore_s"] + ev["replay_s"]

    def close(self) -> None:
        """Freeze the clock (loop's finally). A recovery still open here
        means the loop ended mid-replay: its latency is recorded as the
        partial restore+replay, with ``complete`` left False."""
        if self._open is not None:
            ev, self._open = self._open, None
            ev["latency_s"] = ev["restore_s"] + ev["replay_s"]
        if self._t_end is None and self._t0 is not None:
            self._t_end = time.monotonic()

    # -- read side ----------------------------------------------------------

    def total_wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.monotonic()
        return end - self._t0

    def goodput_fraction(self) -> float:
        total = self.total_wall_s()
        return self.productive_s / total if total > 0 else 0.0

    def recovery_latency_s(self) -> float:
        """Mean failure->frontier latency over recorded recoveries; 0.0
        when the run had none."""
        lats = [ev["latency_s"] for ev in self.events if "latency_s" in ev]
        return sum(lats) / len(lats) if lats else 0.0

    def snapshot(self) -> dict:
        return {
            "productive_s": self.productive_s,
            "replay_s": self.replay_s,
            "restore_s": self.restore_s,
            "stall_s": self.stall_s,
            "compile_s": self.compile_s,
            "resize_s": self.resize_s,
            "save_s": self.save_s,
            "total_wall_s": self.total_wall_s(),
            "goodput_fraction": self.goodput_fraction(),
            "recoveries": len(self.events),
            "replayed_steps": self.replayed_steps,
            "recovery_latency_ms": self.recovery_latency_s() * 1000.0,
        }


class GoodputHook:
    """Publish the loop's GoodputClock as ``goodput/*`` scalars.

    Same shape as the other observability hooks (hooks/builtin.py): reads
    host-side counters only — never a device value — writes one batched
    scalars() call per cadence, and keeps the latest snapshot in ``last``
    for bench harnesses."""

    def __init__(self, writer=None, *, every_steps: int | None = 100):
        from dist_mnist_tpu_torch.hooks.base import EverySteps

        self._writer = writer
        self._timer = EverySteps(every_steps=every_steps or 100)
        self._loop = None
        self.last: dict = {}

    def begin(self, loop) -> None:
        self._loop = loop
        self._timer.prime(loop.initial_step)

    def before_step(self, step: int) -> None:
        pass

    def after_step(self, step: int, state, outputs) -> None:
        if self._timer.should_trigger(step):
            self._timer.mark()
            self._publish(step)

    def end(self, state) -> None:
        self._publish(None)

    def _publish(self, step: int | None) -> None:
        if self._loop is None:
            return
        snap = self._loop.goodput.snapshot()
        self.last = snap
        if self._writer is not None and step is not None:
            self._writer.scalars(
                {f"goodput/{k}": v for k, v in snap.items()}, step
            )


def elastic_summary(records) -> dict:
    """Whole-SUPERVISED-run goodput from a run journal's parsed records.

    A GoodputClock lives inside one generation's train loop; it cannot see
    the supervisor's re-formation windows (child spawn, coordinator
    bring-up, backoff) or sum across generations. This ledger can, because
    the supervisor and every child generation share one journal
    (obs/events.py ENV_JOURNAL):

    - wall        — ``supervisor_start`` .. last ``supervisor_stop`` ts.
    - productive  — FULL-MESH-EQUIVALENT seconds of frontier progress:
                    ``frontier_steps / healthy_rate``, where the healthy
                    rate is measured from this same journal's
                    generation-0 evidence (chief ``first_step`` to the
                    last gen-0 ``checkpoint_save``). Raw busy-seconds
                    would reward a DEGRADED world — a shrunken mesh steps
                    slower, banking more "productive" wall for the same
                    progress — so cross-world-size comparisons (elastic
                    shrink vs full restart) must price progress, not
                    occupancy. When the journal lacks the gen-0 evidence
                    (no first_step/checkpoint cadence), falls back to
                    summing the chief's per-generation ``run_stop``
                    ``goodput.productive_s``.
    - resize      — per membership/restart transition: the failed (or
                    drained) generation's ``generation_end`` ts to the
                    next chief ``first_step`` ts. This is the
                    failure→frontier recovery window, uniform across
                    elastic resizes and full restarts, so
                    ``recovery_latency_s`` is directly comparable.

    Returns goodput_fraction = productive / wall plus the resize ledger.
    Works on any journal: a run with no resizes just reports zero
    recoveries. Stdlib-only like the rest of this module.
    """
    recs = [r for r in records if isinstance(r, dict)]
    t0 = next(
        (r.get("ts") for r in recs if r.get("event") == "supervisor_start"),
        None,
    )
    t1 = next(
        (
            r.get("ts")
            for r in reversed(recs)
            if r.get("event") == "supervisor_stop"
        ),
        None,
    )
    wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0

    busy = 0.0
    final_step = None
    for r in recs:
        if (
            r.get("event") == "run_stop"
            and r.get("process", 0) == 0
            and isinstance(r.get("goodput"), dict)
        ):
            busy += float(r["goodput"].get("productive_s", 0.0))  # lint: ok[host-sync] parses a journal JSON float, no device value
            if r.get("step") is not None:
                final_step = r["step"]

    # healthy full-mesh step rate from generation 0's own evidence: chief
    # first_step -> the last gen-0 checkpoint_save (cadence checkpoints
    # carry step + ts). Both sides of an elastic-vs-restart comparison
    # measure their own rate from an identical healthy generation 0, so
    # the normalization cancels out of the ratio.
    g0_first = next(
        (r for r in recs if r.get("event") == "first_step"
         and r.get("gen", 0) == 0 and r.get("process", 0) == 0),
        None,
    )
    g0_saves = [r for r in recs if r.get("event") == "checkpoint_save"
                and r.get("gen", 0) == 0 and r.get("step") is not None
                and r.get("ts") is not None]
    healthy_rate = 0.0
    if g0_first is not None and g0_first.get("ts") is not None and g0_saves:
        last = max(g0_saves, key=lambda r: r["ts"])
        dt = last["ts"] - g0_first["ts"]
        dstep = last["step"] - g0_first.get("step", 0)
        if dt > 0 and dstep > 0:
            healthy_rate = dstep / dt

    # frontier reached: prefer the final run_stop step, fall back to any
    # frontier evidence (a run killed before its run_stop still made
    # progress worth counting)
    frontier = final_step
    if frontier is None:
        frontier = max(
            (r.get("step", 0) for r in recs
             if r.get("event") in ("checkpoint_save", "first_step")),
            default=None,
        )
    if healthy_rate > 0 and frontier:
        productive = frontier / healthy_rate
    else:
        productive = busy

    # one recovery window per non-initial generation: previous
    # generation_end -> first chief first_step at or after the new start
    gen_starts = sorted(
        (
            r
            for r in recs
            if r.get("event") == "generation_start" and r.get("gen", 0) > 0
        ),
        key=lambda r: r.get("ts", 0.0),
    )
    gen_ends = sorted(
        (r for r in recs if r.get("event") == "generation_end"),
        key=lambda r: r.get("ts", 0.0),
    )
    first_steps = sorted(
        (
            r
            for r in recs
            if r.get("event") == "first_step" and r.get("process", 0) == 0
        ),
        key=lambda r: r.get("ts", 0.0),
    )
    latencies = []
    for s in gen_starts:
        ts = s.get("ts", 0.0)
        prev_end = next(
            (e for e in reversed(gen_ends) if e.get("ts", 0.0) <= ts), None
        )
        nxt = next((f for f in first_steps if f.get("ts", 0.0) >= ts), None)
        if prev_end is not None and nxt is not None:
            latencies.append(nxt["ts"] - prev_end["ts"])

    resizes = [
        {
            "kind": r.get("kind"),
            "old_world": r.get("old_world"),
            "new_world": r.get("new_world"),
            "host": r.get("host"),
        }
        for r in recs
        if r.get("event") == "generation_resize"
    ]
    n_gens = 1 + max(
        (
            r.get("gen", 0)
            for r in recs
            if r.get("event") == "generation_start"
        ),
        default=0,
    )
    return {
        "total_wall_s": wall,
        "productive_s": productive,
        "busy_s": busy,
        "healthy_steps_per_s": healthy_rate,
        "resize_s": sum(latencies),
        "goodput_fraction": productive / wall if wall > 0 else 0.0,
        "recovery_latency_s": (
            sum(latencies) / len(latencies) if latencies else 0.0
        ),
        "recoveries": len(latencies),
        "generations": n_gens,
        "resizes": resizes,
        "final_step": final_step,
    }
