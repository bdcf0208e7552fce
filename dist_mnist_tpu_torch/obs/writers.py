"""Scalar metric writers.

Replaces the reference's summary path (SURVEY.md §5.5: merged summary op ->
SummarySaverHook -> SummaryWriterCache -> event files). Writers here are
plain host-side objects fed by hooks; TensorBoard output goes through
`tensorboardX` when it is installed (the reference uses
`clu.metric_writers`, which imports JAX). Only the chief process writes
(mirroring chief-only summary hooks, monitored_session.py:517-532).

Port of the reference's `obs/writers.py` (numpy and the standard library).
`RegistryWriter`, the live ``/metrics`` sink, joins with the telemetry
slice (ROADMAP §1 item 14), so `make_default_writer(registry=...)`
refuses.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Protocol

import numpy as np

log = logging.getLogger(__name__)


class MetricWriter(Protocol):
    def scalar(self, tag: str, value: float, step: int) -> None: ...

    def scalars(self, values: dict, step: int) -> None: ...

    def histogram(self, tag: str, values, step: int) -> None: ...

    def flush(self) -> None: ...


def _summary_stats(values) -> dict[str, float]:
    v = np.asarray(values, dtype=np.float64).ravel()
    if v.size == 0:
        return {"count": 0.0}
    return {
        "count": float(v.size),
        "mean": float(v.mean()),
        "std": float(v.std()),
        "min": float(v.min()),
        "max": float(v.max()),
    }


class StdoutWriter:
    def scalar(self, tag, value, step):
        log.info("[metric] step=%d %s=%.6g", step, tag, value)

    def scalars(self, values, step):
        # one line per batch, not per tag — batched writes exist so a
        # multi-metric cadence costs one writer call (hooks/builtin.py)
        log.info("[metric] step=%d %s", step,
                 " ".join(f"{k}={v:.6g}" for k, v in values.items()))

    def histogram(self, tag, values, step):
        s = _summary_stats(values)
        log.info("[hist] step=%d %s: %s", step, tag,
                 " ".join(f"{k}={v:.6g}" for k, v in s.items()))

    def flush(self):
        pass


class CsvWriter:
    """One CSV per run: step,tag,value — trivially parseable by benches.
    A CSV is a scalar sink, so histograms land as summary-stat rows
    (`tag/mean`, `tag/std`, ...)."""

    # rows buffered past this count are flushed to disk: the window lost
    # at abnormal exit is bounded, which is exactly when post-mortem
    # metrics matter (docs/RESILIENCE.md)
    FLUSH_EVERY = 32

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        self._unflushed = 0
        if self._fh.tell() == 0:
            self._writer.writerow(["step", "tag", "value"])

    def _wrote(self, n: int) -> None:
        self._unflushed += n
        if self._unflushed >= self.FLUSH_EVERY:
            self.flush()

    def scalar(self, tag, value, step):
        self._writer.writerow([step, tag, value])
        self._wrote(1)

    def scalars(self, values, step):
        self._writer.writerows([step, k, v] for k, v in values.items())
        self._wrote(len(values))

    def histogram(self, tag, values, step):
        stats = _summary_stats(values)
        for k, v in stats.items():
            self._writer.writerow([step, f"{tag}/{k}", v])
        self._wrote(len(stats))

    def flush(self):
        if not self._fh.closed:
            self._fh.flush()
        self._unflushed = 0

    def close(self):
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


class TensorBoardWriter:
    """tensorboardX-backed TensorBoard event files; degrades to a warning
    if tensorboardX is unavailable (nothing in the framework hard-depends
    on it)."""

    def __init__(self, logdir: str | Path):
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(str(logdir))
        except Exception:
            log.warning("tensorboardX unavailable; TensorBoardWriter is a "
                        "no-op")
            self._w = None

    def scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def scalars(self, values, step):
        if self._w is not None:
            for tag, value in values.items():
                self._w.add_scalar(tag, value, step)

    def histogram(self, tag, values, step):
        # full-distribution summaries — the reference's arbitrary-proto
        # summary path ($TF basic_session_run_hooks.py:793) beyond scalars
        if self._w is not None:
            self._w.add_histogram(tag, np.asarray(values).ravel(), step)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()


class MultiWriter:
    def __init__(self, *writers: MetricWriter):
        self.writers = writers

    def scalar(self, tag, value, step):
        for w in self.writers:
            w.scalar(tag, value, step)

    def scalars(self, values, step):
        for w in self.writers:
            # pre-batch custom writers (scalar/flush only) degrade to a
            # per-tag loop instead of crashing
            batch_write = getattr(w, "scalars", None)
            if callable(batch_write):
                batch_write(values, step)
            else:
                for k, v in values.items():
                    w.scalar(k, v, step)

    def histogram(self, tag, values, step):
        for w in self.writers:
            # scalar-only writers degrade to summary-stat rows instead of
            # crashing the whole fan-out (same contract as scalars above)
            hist_write = getattr(w, "histogram", None)
            if callable(hist_write):
                hist_write(tag, values, step)
            else:
                for k, v in _summary_stats(values).items():
                    w.scalar(f"{tag}/{k}", v, step)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            close = getattr(w, "close", None)
            if callable(close):
                close()
            else:
                w.flush()


def make_default_writer(logdir: str | Path | None, *, chief: bool = True,
                        registry=None):
    """Stdout always (chief only); CSV + TensorBoard when a logdir is given.
    A ``MetricRegistry`` (the reference's live ``/metrics`` sink) is
    refused: it joins with ROADMAP §1 item 14."""
    if registry is not None:
        raise NotImplementedError(
            "make_default_writer(registry=...): the metric registry and its "
            "RegistryWriter join the port with ROADMAP §1 item 14 "
            "(telemetry)")
    live: list[MetricWriter] = []
    if not chief:
        return MultiWriter(*live)
    writers: list[MetricWriter] = live + [StdoutWriter()]
    if logdir is not None:
        writers.append(CsvWriter(Path(logdir) / "metrics.csv"))
        writers.append(TensorBoardWriter(logdir))
    return MultiWriter(*writers)
