"""Fleet observability: scrape every worker's exposition endpoints and
serve one merged view from the supervisor.

The telemetry spine (registry, exporter) made each *process*
observable; an elastic fleet (cli/launch.py --elastic) needs the
cross-host questions answered in one place: which host is the
straggler dragging the synchronous step, how the step-time distribution
looks *fleet-wide*, and which hosts are alive/degraded right now. A
single MonitoredTrainingSession chief got this for free in the
reference architecture; a multi-host SPMD world has to rebuild it
explicitly — that is this module.

``FleetScraper`` polls every live child's ``/metrics`` + ``/healthz``
(+ ``/events``) over localhost HTTP, parses the Prometheus text *back*
into values and ``StreamingHistogram``s (the ladder is fixed precisely
so per-process histograms merge by adding counts), and exposes:

- merged fleet-wide histograms + per-host attribution series, appended
  to the supervisor exporter's ``/metrics`` (obs/exporter.py hands the
  scraper the request via ``MetricsExporter.fleet``);
- a ``/fleet`` JSON snapshot (per-host state, straggler verdict);
- ``fleet/*`` gauges in its own ``MetricRegistry``;
- a ``straggler_detected`` journal event naming the host when one
  host's step time stays skewed above the fleet median.

Straggler math: per scrape, each host's step-time signal is the mean of
the *new* ``step_time_ms`` samples since the previous scrape (delta of
the histogram's ``_sum``/``_count``; falls back to the cumulative mean
when a host produced no new samples). The fleet reference is the lower
median of those means — robust for small fleets, where an upper median
would let a single straggler drag the reference toward itself. A host
whose ``mean / median`` ratio stays >= ``straggler_ratio`` for
``straggler_window`` consecutive scrapes is declared a straggler once,
and the detector re-arms after the ratio clears.

Stdlib-only on purpose: this runs inside the supervisor, which must
stay importable before (and without) torch. (A copy of the reference
package's `obs/fleet.py`.)
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import urllib.error
import urllib.request

from dist_mnist_tpu_torch.obs.exporter import render_histogram_lines
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.obs.registry import MetricRegistry

log = logging.getLogger(__name__)

__all__ = ["parse_prometheus", "FleetScraper"]


# -- Prometheus text -> values ------------------------------------------------

def _parse_labels(raw: str) -> dict:
    """``k1="v1",k2="v2"`` -> dict. Values in our exposition never
    contain escaped quotes, so a simple split is exact."""
    out: dict = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip().strip('"')
    return out


def _split_sample(line: str) -> tuple[str, dict, float] | None:
    """One sample line -> (name, labels, value); None when unparseable."""
    try:
        metric, value_s = line.rsplit(None, 1)
    except ValueError:
        return None
    labels: dict = {}
    if "{" in metric:
        name, rest = metric.split("{", 1)
        labels = _parse_labels(rest.rsplit("}", 1)[0])
    else:
        name = metric
    name = name.strip()
    value_s = value_s.strip()
    try:
        if value_s == "+Inf":
            value = math.inf
        elif value_s == "-Inf":
            value = -math.inf
        else:
            value = float(value_s)
    except ValueError:
        return None
    return name, labels, value


def _rebuild_histogram(cum_buckets: list[tuple[float, float]],
                       total: float, hsum: float,
                       ladder: StreamingHistogram) -> StreamingHistogram:
    """Cumulative ``_bucket`` samples -> a StreamingHistogram on the
    given ladder. Bucket indices recover exactly from edges because the
    exposition prints ``repr(float(edge))`` of ``min_value*growth**i``;
    min/max are approximated by the occupied bucket edges (count/sum
    stay exact, which is all merging needs)."""
    h = StreamingHistogram(min_value=ladder.min_value, growth=ladder.growth,
                           n_buckets=ladder.n_buckets)
    log_growth = math.log(h.growth)
    prev_cum = 0.0
    finite_total = 0.0
    for edge, cum in sorted(cum_buckets):
        if not math.isfinite(edge):
            continue
        count = int(round(cum - prev_cum))
        prev_cum = cum
        if count <= 0:
            continue
        idx = int(round(math.log(edge / h.min_value) / log_growth))
        idx = min(max(idx, 0), h.n_buckets - 1)
        h._counts[idx] += count
        finite_total += count
    overflow = int(round(total - finite_total))
    if overflow > 0:
        h._counts[h.n_buckets - 1] += overflow
    h._count = int(round(total))
    h._sum = float(hsum)
    occupied = [i for i, c in enumerate(h._counts) if c]
    if occupied:
        lo_i, hi_i = occupied[0], occupied[-1]
        h._min = 0.0 if lo_i == 0 else h.bucket_upper_edge(lo_i - 1)
        h._max = h.bucket_upper_edge(hi_i)  # inf when overflow occupied
    return h


def parse_prometheus(text: str, *,
                     ladder: StreamingHistogram | None = None):
    """Parse exporter.render_prometheus output back into
    ``(scalars, histograms, info)``.

    - ``scalars``: plain (label-free) gauge samples by exposition name.
    - ``histograms``: StreamingHistogram per ``# TYPE ... histogram``
      family, rebuilt on the repo-default ladder (or ``ladder``'s) so it
      merges with live histograms.
    - ``info``: labels of the ``process_info`` gauge (host_id,
      generation, role), plus ``state`` from ``process_state``.
    """
    if ladder is None:
        ladder = StreamingHistogram()
    scalars: dict[str, float] = {}
    info: dict[str, str] = {}
    # family -> {"buckets": [(edge, cum)], "sum": float, "count": float}
    fams: dict[str, dict] = {}
    hist_names: set[str] = set()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE" and \
                    parts[3] == "histogram":
                hist_names.add(parts[2])
            continue
        sample = _split_sample(line)
        if sample is None:
            continue
        name, labels, value = sample
        if name == "process_info":
            info.update(labels)
            continue
        if name == "process_state":
            if value == 1 and "state" in labels:
                info["state"] = labels["state"]
            continue
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in hist_names:
                base = name[: -len(suffix)]
                fam = fams.setdefault(
                    base, {"buckets": [], "sum": 0.0, "count": 0.0})
                if suffix == "_bucket":
                    edge_s = labels.get("le", "+Inf")
                    edge = math.inf if edge_s == "+Inf" else float(edge_s)
                    fam["buckets"].append((edge, value))
                elif suffix == "_sum":
                    fam["sum"] = value
                else:
                    fam["count"] = value
                break
        if base is None and not labels:
            scalars[name] = value
    hists = {
        name: _rebuild_histogram(fam["buckets"], fam["count"], fam["sum"],
                                 ladder)
        for name, fam in fams.items()
    }
    return scalars, hists, info


# -- the scraper --------------------------------------------------------------

class _HostView:
    """Everything the scraper knows about one host, plus the straggler
    detector's per-host delta state."""

    def __init__(self, host_id: int):
        self.host_id = host_id
        self.url: str | None = None
        self.reachable = False
        self.healthy = False
        self.state = "unknown"
        self.info: dict = {}
        self.scalars: dict = {}
        self.hists: dict = {}
        self.last_events: list = []
        self.last_scrape_ts: float | None = None
        self.error: str | None = None
        # step-time delta tracking (cumulative sum/count at last scrape)
        self._prev_sum = 0.0
        self._prev_count = 0
        self.step_time_mean_ms: float | None = None
        self.skew_streak = 0

    def update_step_time(self, hist: StreamingHistogram | None) -> None:
        if hist is None or not hist.count:
            return
        d_count = hist.count - self._prev_count
        d_sum = hist.sum - self._prev_sum
        if d_count > 0:
            self.step_time_mean_ms = d_sum / d_count
        else:
            # no new samples since last scrape (or a generation restart
            # reset the counters): fall back to the cumulative mean
            self.step_time_mean_ms = hist.mean
        self._prev_count = hist.count
        self._prev_sum = hist.sum

    def snapshot(self) -> dict:
        return {
            "host": self.host_id,
            "url": self.url,
            "reachable": self.reachable,
            "healthy": self.healthy,
            "state": self.state,
            "info": self.info,
            "step_time_mean_ms": self.step_time_mean_ms,
            "last_scrape_ts": self.last_scrape_ts,
            "error": self.error,
        }


class FleetScraper:
    """Supervisor-side poller merging every worker's exposition.

    Lifecycle: construct once per supervised run, ``set_targets`` at
    every generation start (host id -> base URL), ``start()`` the
    background loop (thread named ``ObsExporter-fleet`` so the conftest
    leak-check covers it), attach to the supervisor's exporter via
    ``MetricsExporter(fleet=scraper)``, ``close()`` in the finally.

    A host vanishing mid-scrape (elastic shrink, preemption) is the
    normal case, not an error path: every request has a short timeout
    and a per-target exception net, so one dead socket can never wedge
    the loop.
    """

    def __init__(self, *, journal=None, interval_s: float = 1.0,
                 timeout_s: float = 0.5,
                 step_time_metric: str = "train_step_time_ms",
                 straggler_ratio: float = 2.0, straggler_window: int = 3,
                 events_tail: int = 5):
        self.registry = MetricRegistry()
        self._journal = journal
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.step_time_metric = step_time_metric
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_window = int(straggler_window)
        self.events_tail = int(events_tail)
        self._lock = threading.Lock()
        self._hosts: dict[int, _HostView] = {}
        self._targets: dict[int, str] = {}
        self._scrapes = 0
        self._scrape_errors = 0
        self._stragglers_detected = 0
        self._current_ratio = math.nan
        self._current_straggler: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- targets ---------------------------------------------------------------

    def set_targets(self, targets: dict) -> None:
        """Replace the scrape target set: ``{host_id: base_url}``.
        Called by the supervisor at every generation start; hosts keep
        their delta state across generations (host ids are stable)."""
        with self._lock:
            self._targets = {int(h): str(u).rstrip("/")
                             for h, u in targets.items()}
            for h, u in self._targets.items():
                view = self._hosts.setdefault(h, _HostView(h))
                view.url = u
            for h in list(self._hosts):
                if h not in self._targets:
                    self._hosts[h].reachable = False
                    self._hosts[h].state = "gone"
                    self._hosts[h].healthy = False

    # -- scraping --------------------------------------------------------------

    def _get(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8")

    def _scrape_host(self, view: _HostView) -> None:
        base = view.url
        try:
            scalars, hists, info = parse_prometheus(self._get(base +
                                                              "/metrics"))
            view.scalars, view.hists = scalars, hists
            view.info = {k: v for k, v in info.items() if k != "state"}
            view.update_step_time(hists.get(self.step_time_metric))
            try:
                snap = json.loads(self._get(base + "/healthz"))
                view.state = snap.get("state", "unknown")
                view.healthy = bool(snap.get("healthy", False))
            except urllib.error.HTTPError as e:  # 503 carries the body too
                try:
                    snap = json.loads(e.read().decode("utf-8"))
                    view.state = snap.get("state", "unknown")
                except Exception:  # noqa: BLE001
                    view.state = "unknown"
                view.healthy = False
            if self.events_tail > 0:
                try:
                    body = self._get(
                        f"{base}/events?n={self.events_tail}")
                    view.last_events = [
                        json.loads(ln) for ln in body.splitlines() if ln]
                except Exception:  # noqa: BLE001 - /events is optional
                    view.last_events = []
            view.reachable = True
            view.error = None
            view.last_scrape_ts = time.time()
        except Exception as e:  # noqa: BLE001 - dead hosts are normal
            view.reachable = False
            view.healthy = False
            view.error = f"{type(e).__name__}: {e}"
            with self._lock:
                self._scrape_errors += 1

    def _detect_straggler(self, views: list) -> None:
        means = {v.host_id: v.step_time_mean_ms for v in views
                 if v.reachable and v.step_time_mean_ms is not None
                 and v.step_time_mean_ms > 0}
        if len(means) < 2:
            self._current_ratio = math.nan
            self._current_straggler = None
            return
        ordered = sorted(means.values())
        median = ordered[(len(ordered) - 1) // 2]  # lower median
        slowest_host, slowest = max(means.items(), key=lambda kv: kv[1])
        ratio = slowest / median if median > 0 else math.nan
        self._current_ratio = ratio
        self._current_straggler = slowest_host
        for v in views:
            if v.host_id == slowest_host and ratio >= self.straggler_ratio:
                v.skew_streak += 1
                if v.skew_streak == self.straggler_window:
                    self._stragglers_detected += 1
                    log.warning(
                        "straggler detected: host %d step-time %.3fms is "
                        "%.2fx the fleet median %.3fms",
                        v.host_id, slowest, ratio, median)
                    if self._journal is not None:
                        try:
                            self._journal.emit(
                                "straggler_detected", host=v.host_id,
                                ratio=round(ratio, 3),
                                step_time_mean_ms=round(slowest, 3),
                                fleet_median_ms=round(median, 3),
                                window=self.straggler_window)
                        except Exception:  # noqa: BLE001
                            log.warning("straggler journal emit failed",
                                        exc_info=True)
            else:
                v.skew_streak = 0

    def scrape_once(self) -> dict:
        """One full pass over the current targets; returns snapshot()."""
        with self._lock:
            views = [self._hosts[h] for h in sorted(self._targets)]
        for view in views:
            self._scrape_host(view)
        with self._lock:
            self._scrapes += 1
            self._detect_straggler(views)
            n_reach = sum(v.reachable for v in views)
            n_healthy = sum(v.healthy for v in views)
            self.registry.set_scalars({
                "fleet/hosts": len(views),
                "fleet/reachable_hosts": n_reach,
                "fleet/healthy_hosts": n_healthy,
                "fleet/scrapes": self._scrapes,
                "fleet/scrape_errors": self._scrape_errors,
                "fleet/straggler_ratio": (
                    self._current_ratio
                    if math.isfinite(self._current_ratio) else 0.0),
                "fleet/straggler_host": (
                    self._current_straggler
                    if self._current_straggler is not None else -1),
                "fleet/stragglers_detected": self._stragglers_detected,
            }, step=self._scrapes)
        return self.snapshot()

    # -- exposition ------------------------------------------------------------

    def merged_histograms(self) -> dict:
        """Fleet-wide histograms: same-name per-host histograms folded
        together (the ladder is identical by construction)."""
        merged: dict[str, StreamingHistogram] = {}
        with self._lock:
            views = list(self._hosts.values())
        for view in views:
            for name, h in view.hists.items():
                if name not in merged:
                    merged[name] = StreamingHistogram(
                        min_value=h.min_value, growth=h.growth,
                        n_buckets=h.n_buckets)
                try:
                    merged[name].merge(h)
                except ValueError:
                    log.warning("fleet merge skipped %s: ladder mismatch",
                                name)
        return merged

    def render_prometheus(self) -> str:
        """Fleet-only exposition block, appended by the supervisor's
        exporter after its own registry: merged ``fleet_<hist>`` series
        plus per-host attribution gauges."""
        lines: list[str] = []
        for name, h in sorted(self.merged_histograms().items()):
            lines.extend(render_histogram_lines(f"fleet_{name}", h))
        with self._lock:
            views = [v for _, v in sorted(self._hosts.items())]
        lines.append("# TYPE fleet_host_up gauge")
        for v in views:
            lines.append(f'fleet_host_up{{host="{v.host_id}"}} '
                         f"{int(v.reachable)}")
        lines.append("# TYPE fleet_host_healthy gauge")
        for v in views:
            lines.append(f'fleet_host_healthy{{host="{v.host_id}"}} '
                         f"{int(v.healthy)}")
        lines.append("# TYPE fleet_host_step_time_mean_ms gauge")
        for v in views:
            if v.step_time_mean_ms is not None:
                lines.append(
                    f'fleet_host_step_time_mean_ms{{host="{v.host_id}"}} '
                    f"{repr(float(v.step_time_mean_ms))}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able fleet state for the ``/fleet`` endpoint."""
        with self._lock:
            views = [v for _, v in sorted(self._hosts.items())]
            return {
                "targets": dict(self._targets),
                "hosts": [v.snapshot() for v in views],
                "scrapes": self._scrapes,
                "scrape_errors": self._scrape_errors,
                "straggler": {
                    "ratio": (self._current_ratio
                              if math.isfinite(self._current_ratio)
                              else None),
                    "host": self._current_straggler,
                    "threshold": self.straggler_ratio,
                    "window": self.straggler_window,
                    "detected": self._stragglers_detected,
                },
            }

    # -- background loop -------------------------------------------------------

    def start(self) -> "FleetScraper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="ObsExporter-fleet", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.warning("fleet scrape pass failed", exc_info=True)
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
