"""Graceful preemption handshake: signal -> notice -> step-boundary stop.

The reference's chief consumed preemption via the session teardown path
(MonitoredTrainingSession close -> hooks' end, SURVEY.md §3.2); a SIGTERM
mid-step simply killed the process and the next start re-ran
prepare_session. Here the handshake is explicit and CLEAN:

1. SIGTERM/SIGINT sets a `PreemptionNotice` (a latch — async-signal-safe:
   the handler only sets an Event, no I/O, no locks beyond it).
2. `TrainLoop` checks the notice at each STEP BOUNDARY (train/loop.py):
   it saves a checkpoint, waits for it to be durable, records
   `preempted_at`, and requests a stop — hooks and the prefetch worker
   drain through the loop's normal finally path.
3. `cli.train` logs a ``preempted@step=N`` marker and exits 0 — a
   preempted-but-checkpointed run is a SUCCESS to the supervisor and to
   any cluster scheduler watching exit codes.

(A copy of the reference's `faults/preemption.py`.)

A SECOND signal of the same number means the operator is done waiting:
the previous disposition is restored and the signal re-raised (default
SIGTERM terminates; SIGINT raises KeyboardInterrupt).
"""

from __future__ import annotations

import signal
import threading


class PreemptionNotice:
    """One-way latch between an async notifier (signal handler, test hook,
    cluster agent thread) and the train loop's step-boundary check."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: str | None = None

    def notify(self, reason: str = "preemption requested") -> None:
        self.reason = reason  # benign race: any writer's reason is fine
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()


def install_preemption_handlers(
    notice: PreemptionNotice,
    signals: tuple = (signal.SIGTERM, signal.SIGINT),
):
    """Route `signals` to `notice`; returns an uninstall callable.

    Only valid in the main thread of the main interpreter (CPython signal
    rule) — cli.train's main() qualifies; in-process tests drive the
    notice directly instead."""
    previous: dict = {}

    def _handler(signum, frame):
        del frame
        if notice.requested():
            # second signal: restore the old disposition and re-raise so
            # the operator's escalation actually escalates
            old = previous.get(signum)
            signal.signal(signum, old if old is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        notice.notify(f"signal {signal.Signals(signum).name}")

    for s in signals:
        previous[s] = signal.signal(s, _handler)

    def uninstall() -> None:
        for s, old in previous.items():
            try:
                signal.signal(s, old if old is not None else signal.SIG_DFL)
            except (ValueError, OSError):  # not main thread / torn down
                pass

    return uninstall
