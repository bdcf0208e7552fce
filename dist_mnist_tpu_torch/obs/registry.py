"""In-process metric registry: the live, scrapeable view of everything
the hooks publish.

Writers (`obs/writers.py`) are write-only sinks — CSV rows and TB event
files are post-hoc. The registry is the read side: a ``RegistryWriter``
slots into ``make_default_writer`` next to the disk sinks, so every
``goodput/*``, ``startup/*``, ``memory/*``, ``input/*``, ``serve/*``
scalar a hook emits is also held in memory where the exporter
(`obs/exporter.py`) can serve it over ``/metrics`` while the run is
still going.

(A copy of the reference package's `obs/registry.py`.)

Histograms come in two flavors:
  * raw-array writes through the ``MetricWriter.histogram`` protocol are
    folded into a registry-owned ``StreamingHistogram`` per tag;
  * live histograms owned elsewhere (the train loop's step-time ladder,
    the serve metrics reservoir replacements) are *attached* by
    reference, so the exporter reads them with zero copying.
"""

from __future__ import annotations

import threading
import time

from dist_mnist_tpu_torch.obs.hist import StreamingHistogram

__all__ = ["MetricRegistry", "RegistryWriter"]


class MetricRegistry:
    """Thread-safe map of tag -> latest scalar and tag -> histogram."""

    def __init__(self):
        self._lock = threading.Lock()
        self._scalars: dict[str, tuple[float, int, float]] = {}
        self._hists: dict[str, StreamingHistogram] = {}

    # -- scalars --------------------------------------------------------------

    def set_scalar(self, tag: str, value, step: int) -> None:
        with self._lock:
            self._scalars[str(tag)] = (float(value), int(step), time.time())

    def set_scalars(self, values: dict, step: int) -> None:
        now = time.time()
        with self._lock:
            for tag, value in values.items():
                self._scalars[str(tag)] = (float(value), int(step), now)

    def scalars(self) -> dict[str, tuple[float, int, float]]:
        """tag -> (value, step, wall_time) snapshot."""
        with self._lock:
            return dict(self._scalars)

    # -- histograms -----------------------------------------------------------

    def attach_histogram(self, tag: str, hist: StreamingHistogram) -> None:
        """Register a live, externally-owned histogram under ``tag``."""
        with self._lock:
            self._hists[str(tag)] = hist

    def observe(self, tag: str, value: float) -> None:
        self._hist_for(tag).observe(value)

    def record_values(self, tag: str, values) -> None:
        self._hist_for(tag).observe_many(values)

    def _hist_for(self, tag: str) -> StreamingHistogram:
        with self._lock:
            h = self._hists.get(str(tag))
            if h is None:
                h = self._hists[str(tag)] = StreamingHistogram()
        return h

    def histograms(self) -> dict[str, StreamingHistogram]:
        with self._lock:
            return dict(self._hists)

    # -- combined view --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-friendly snapshot: scalars as values, hists as summaries."""
        with self._lock:
            scalars = {t: v for t, (v, _s, _w) in self._scalars.items()}
            hists = dict(self._hists)
        return {"scalars": scalars,
                "histograms": {t: h.snapshot() for t, h in hists.items()}}

    def tags(self) -> list[str]:
        with self._lock:
            return sorted(set(self._scalars) | set(self._hists))


class RegistryWriter:
    """MetricWriter facade over a MetricRegistry — the hook side of the
    live-metrics path. Matches the protocol in obs/writers.py."""

    def __init__(self, registry: MetricRegistry):
        self.registry = registry

    def scalar(self, tag, value, step):
        self.registry.set_scalar(tag, value, step)

    def scalars(self, values, step):
        self.registry.set_scalars(values, step)

    def histogram(self, tag, values, step):
        self.registry.record_values(tag, values)

    def flush(self):
        pass

    def close(self):
        pass
