"""Chrome-trace export + op-time triage (port of the reference's
`obs/timeline.py`, adapted to `torch.profiler`).

The reference's `ProfilerHook` requested FULL_TRACE RunMetadata and
`client/timeline.py` converted the step stats into `timeline-<step>.json`
for chrome://tracing. The port's `ProfilerHook` (hooks/builtin.py) runs
`torch.profiler` over a window of steps and writes its chrome trace as
``<logdir>/trace-steps<start>-<stop>.json`` (host ops, and the device's
kernels by name on a CUDA state). The functions here close the gap to
the reference's UX:

- `latest_trace(logdir)` -> the newest of those traces.
- `export_chrome_trace(logdir, out)` -> the literal `timeline-*.json`
  file the reference emitted, loadable in chrome://tracing / perfetto.
- `summarize_trace(path, top)` -> top-N ops by total duration, for triage
  on machines with no viewer at hand.

On a shared logdir, several hosts profile into one directory; exports
are therefore stamped with the host id (`timeline-h<host>-<run>.json`,
host from `DIST_MNIST_TPU_HOST_ID`, run the trace's ``steps<a>-<b>``)
so one host's export can never shadow another's, and
scripts/fleet_trace.py can merge them back into one per-host-track fleet
trace.

Stated departure: there is no ``plugins/profile/<run>/*.trace.json.gz``
tree (that is `jax.profiler`'s layout); the source of an export is the
profiler hook's plain-JSON ``trace-steps*.json``. `summarize_trace` still
reads a gzipped trace as the reference's does.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
from collections import defaultdict
from pathlib import Path

__all__ = ["latest_trace", "export_chrome_trace", "summarize_trace"]

_ENV_HOST_ID = "DIST_MNIST_TPU_HOST_ID"  # == obs/events.ENV_HOST_ID

#: the profiler hook's trace files: ``trace-steps<start>-<stop>.json``
_TRACE_GLOB = "trace-steps*.json"


def latest_trace(logdir: str | Path) -> Path | None:
    """Newest ``trace-steps*.json`` the profiler hook wrote in `logdir`
    (None if absent)."""
    candidates = sorted(
        Path(logdir).glob(_TRACE_GLOB),
        key=lambda p: p.stat().st_mtime,
    )
    return candidates[-1] if candidates else None


def export_chrome_trace(
    logdir: str | Path, out_path: str | Path | None = None,
    host_id: int | str | None = None,
) -> Path | None:
    """Copy the latest profiler trace to `timeline-h<host>-<run>.json`
    (`timeline-<run>.json` when no host identity is known — single-process
    runs), `run` being the trace's ``steps<start>-<stop>``.

    Returns the written path, or None when no trace exists yet. Naming
    mirrors the reference's `timeline-<step>.json` files; the host stamp
    keeps concurrent hosts on a shared logdir from shadowing each
    other's export."""
    src = latest_trace(logdir)
    if src is None:
        return None
    if host_id is None:
        host_id = os.environ.get(_ENV_HOST_ID)
    run = src.stem.removeprefix("trace-")
    if out_path is None:
        stem = (f"timeline-h{host_id}-{run}"
                if host_id is not None else f"timeline-{run}")
        out_path = Path(logdir) / f"{stem}.json"
    out_path = Path(out_path)
    shutil.copyfile(src, out_path)
    return out_path


def summarize_trace(
    trace_path: str | Path, top: int = 15
) -> list[dict[str, float | str | int]]:
    """Aggregate complete events by name: total duration, count.

    Works on a raw profiler trace, a gzipped one or an exported timeline
    JSON. Returns rows sorted by total time, descending:
    `{"name", "total_us", "count", "avg_us", "tracks"}`.

    Tolerant of sparse producers: events missing `pid`/`tid`/`name` or
    carrying a non-numeric `dur` (hand-built traces, fleet_trace merges,
    other profilers) are aggregated under defaults or skipped rather
    than raising.
    """
    raw = Path(trace_path).read_bytes()
    if str(trace_path).endswith(".gz"):
        raw = gzip.decompress(raw)
    events = json.loads(raw).get("traceEvents", [])
    total = defaultdict(float)
    count = defaultdict(int)
    tracks = defaultdict(set)
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)):
            continue
        name = ev.get("name", "?")
        total[name] += dur
        count[name] += 1
        # pid/tid are optional per the trace-format spec: default, never
        # index, so partial producers summarize instead of crash
        tracks[name].add((ev.get("pid", 0), ev.get("tid", 0)))
    rows = sorted(total, key=total.__getitem__, reverse=True)[:top]
    return [
        {
            "name": n,
            "total_us": round(total[n], 1),
            "count": count[n],
            "avg_us": round(total[n] / count[n], 2),
            "tracks": len(tracks[n]),
        }
        for n in rows
    ]
