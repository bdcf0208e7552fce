"""Hook protocol (SessionRunHook analogue, SURVEY.md §2.4 row 18; a copy
of the reference's `hooks/base.py`).

Lifecycle, in loop order (train/loop.py):
  begin(loop)                    — once, before the first step; the hook may
                                   keep the loop handle to request_stop()
                                   (≙ begin + after_create_session)
  before_step(step)              — step is the int about to execute
  after_step(step, state, out)   — `out` is the step's metrics dict of
                                   device scalars; calling float() on one
                                   syncs the device — hooks should do so
                                   only at their cadence to keep dispatch
                                   async (the analogue of not adding fetches
                                   to every run)
  end(state)                     — once, after the last step or stop request
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from dist_mnist_tpu_torch.train.loop import TrainLoop


class Hook:
    def begin(self, loop: "TrainLoop") -> None:
        pass

    def before_step(self, step: int) -> None:
        pass

    def after_step(self, step: int, state, outputs: dict[str, Any]) -> None:
        pass

    def end(self, state) -> None:
        pass


class EverySteps:
    """Cadence helper ≙ SecondOrStepTimer (basic_session_run_hooks.py:86):
    triggers on a step multiple and/or a wall-clock interval."""

    def __init__(self, every_steps: int | None = None,
                 every_secs: float | None = None):
        if every_steps is None and every_secs is None:
            raise ValueError("need every_steps or every_secs")
        self.every_steps = every_steps
        self.every_secs = every_secs
        self._last_time = time.monotonic()
        self._last_step: int | None = None

    def prime(self, step: int) -> None:
        """Anchor the crossing detector at the run's initial step (hooks
        call this from begin(loop)). Without it the FIRST observation has
        no predecessor, so a chunk that crosses a multiple without landing
        on one (e.g. first after_step(150) with every=100) can't be seen
        as a crossing."""
        self._last_step = step

    def should_trigger(self, step: int) -> bool:
        """True when a step multiple was REACHED OR CROSSED since the last
        observed step — not bare `step % every == 0`, which silently aliases
        when the loop advances in chunks (scan_chunk: steps arrive as
        64, 128, ... and would hit a multiple of 100 only at the LCM)."""
        if self.every_steps is not None:
            prev, self._last_step = self._last_step, step
            if prev is None:
                if step % self.every_steps == 0:
                    return True
            elif step // self.every_steps > prev // self.every_steps:
                return True
        if (
            self.every_secs is not None
            and time.monotonic() - self._last_time >= self.every_secs
        ):
            return True
        return False

    def mark(self) -> None:
        self._last_time = time.monotonic()
