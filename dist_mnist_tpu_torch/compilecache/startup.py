"""Cold-start attribution: where does process wall time go before the
first useful step?

`StartupClock` buckets the time from process start (or whatever `t0` the
caller anchors) into:

- ``import``     — module imports up to the driver's entry (cli/train.py
                   anchors t0 at its own module top, so this covers the
                   package's imports, torch's among them).
- ``init``       — backend/distributed bring-up, dataset load, model +
                   state build, sharding placement.
- ``restore``    — checkpoint restore at startup.
- ``compile``    — the build (nvcc, g++) OR the store load of the kernel
                   libraries the first step needs (train/step.py drains
                   it; the loop charges it, so a warm start shows the
                   load ms where a cold start shows the build ms).
- ``first_step`` — the residual: everything between t0 and the first
                   completed step not attributed above (first dispatch,
                   hook bring-up).

A rank that the launcher started as a stand-by (`cli/standby.py`) has
`t0` at its hand-off when it had finished importing by then; the import
it paid before is ``standby_import_ms``, outside every bucket and the
headline (a field the reference lacks: its ranks start cold).

``time_to_first_step_ms`` is the headline (`bench.py --coldstart`);
``unattributed_ms`` is wall time AFTER the first step not covered by the
buckets — by construction 0 until then, it exists so the snapshot always
sums honestly.

Stdlib-only, like faults/goodput.py (a copy of the reference
`compilecache/startup.py`, its docstrings reworded for the port).
"""

from __future__ import annotations

import contextlib
import time


class StartupClock:
    """Bucketed process-startup wall clock; feed via `phase`/`note`, freeze
    the headline with `first_step_done`, read with `snapshot`."""

    BUCKETS = ("import", "init", "restore", "compile", "first_step")

    def __init__(self, t0: float | None = None):
        self.t0 = time.monotonic() if t0 is None else t0
        self.buckets = {b: 0.0 for b in self.BUCKETS}
        self.time_to_first_step_s: float | None = None
        #: import a stand-by rank paid before its hand-off (`t0`), outside
        #: every bucket (`cli/standby.py`); None for a rank started cold
        self.standby_import_s: float | None = None

    def note(self, bucket: str, seconds: float) -> None:
        self.buckets[bucket] += max(0.0, seconds)

    @contextlib.contextmanager
    def phase(self, bucket: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.note(bucket, time.monotonic() - t0)

    def first_step_done(self) -> None:
        """Freeze time-to-first-step (first call wins); the ``first_step``
        bucket becomes the residual over the attributed phases."""
        if self.time_to_first_step_s is None:
            self.time_to_first_step_s = time.monotonic() - self.t0

    def snapshot(self) -> dict:
        ttfs = self.time_to_first_step_s
        attributed = sum(
            v for b, v in self.buckets.items() if b != "first_step"
        )
        out = {f"{b}_ms": v * 1e3 for b, v in self.buckets.items()}
        if ttfs is not None:
            out["first_step_ms"] = max(0.0, ttfs - attributed) * 1e3
            out["time_to_first_step_ms"] = ttfs * 1e3
        if self.standby_import_s is not None:
            out["standby_import_ms"] = self.standby_import_s * 1e3
        return out


class StartupHook:
    """Publish `startup/*` and `compile_cache/*` once, at the first step.

    Same shape as the other observability hooks (hooks/builtin.py): reads
    host-side counters only, one batched scalars() call. The compile
    bucket is read off the loop's GoodputClock (train/loop.py charges the
    kernel build/store-load time there BEFORE after_step fires), so cold vs
    warm starts attribute truthfully without the hook knowing the step's
    internals. `last` keeps the published snapshot for bench harnesses."""

    def __init__(self, writer=None, clock: StartupClock | None = None, *,
                 store=None):
        self._writer = writer
        self.clock = clock or StartupClock()
        self._store = store
        self._loop = None
        self._published = False
        self.last: dict = {}

    def begin(self, loop) -> None:
        self._loop = loop

    def before_step(self, step: int) -> None:
        pass

    def after_step(self, step: int, state, outputs) -> None:
        if self._published:
            return
        self._published = True
        if self._loop is not None:
            # mirror the goodput clock's compile charge (a build or a
            # store load, whichever the warm-start tier produced)
            already = self.clock.buckets["compile"]
            self.clock.note(
                "compile", self._loop.goodput.compile_s - already
            )
        self.clock.first_step_done()
        snap = dict(self.clock.snapshot())
        if self._store is not None:
            snap.update(
                {f"cache_{k}": v for k, v in self._store.stats().items()}
            )
        self.last = snap
        if self._writer is not None:
            scalars = {
                f"startup/{k}": v for k, v in self.clock.snapshot().items()
            }
            if self._store is not None:
                scalars.update({
                    f"compile_cache/{k}": float(v)
                    for k, v in self._store.stats().items()
                })
            self._writer.scalars(scalars, step)

    def end(self, state) -> None:
        pass
