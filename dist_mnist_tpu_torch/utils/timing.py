"""The throughput stop-clock (port of the reference `utils/timing.py`;
its `stopclock` joins with the telemetry slice).

Torch returns from a launch before the device has run it, so a clock
around launches measures the enqueue. `timed_chunks` stops its clock on a
host copy of the last chunk's loss, which cannot arrive before every
step before it has run.
"""

from __future__ import annotations

import time


def timed_chunks(run_fn, state, n_chunks: int):
    """Warm up once, then time `n_chunks` chained ``state -> (state, out)``
    calls; the clock stops on the host copy of the final ``out["loss"]``.

    Returns ``(seconds, final_state, final_loss)``: the loss is the proof
    that the chain ran (it falls under training)."""
    state, out = run_fn(state)  # first-call costs, outside the clock
    float(out["loss"].item())
    t0 = time.monotonic()
    for _ in range(n_chunks):
        state, out = run_fn(state)
    loss = float(out["loss"].item())
    return time.monotonic() - t0, state, loss
