"""HTTP exposition: ``/metrics`` (Prometheus text), ``/healthz``
(process state machine), ``/events`` (journal tail).

One stdlib ``ThreadingHTTPServer`` on a daemon thread per process,
enabled by ``--metrics_port`` on the train and serve CLIs. The server
reads the live ``MetricRegistry`` / ``HealthState`` / journal file on
each GET — no background sampling loop, nothing to fall behind.

Health is a tiny explicit state machine rather than a boolean:

    starting -> training | serving -> draining | preempted -> stopped
                       `-> degraded  -> resizing               | failed

``/healthz`` returns 200 while the process is doing useful work
(starting/training/serving/degraded) and 503 otherwise, so a fleet
router can stop sending traffic to a draining replica before it
disappears (ROADMAP "replica health/drain integration with the
supervisor"). ``resizing`` is the elastic supervisor's mesh
re-formation window (cli/launch.py --elastic): a membership change was decided and the next
generation has not started yet — deliberately NOT healthy, so routers
hold traffic exactly like a drain. ``degraded`` is the anomaly
detector's 200-but-flagged state (obs/anomaly.py): the process is
still making progress — killing or rerouting it would cost more than
the anomaly — but operators and the fleet scraper can see the flag in
the /healthz body and in ``process_state{state="degraded"}``.

Threads are named ``ObsExporter*`` and live exporters are tracked in
``_LIVE_EXPORTERS`` so a test's leak check can prove every test closed
its server.

A copy of the reference package's `obs/exporter.py`. The POST
``/predict`` and ``/swap`` routes answer 404 until a serve replica wires
``predict_fn``/``swap_fn``; the port's replica mode (`cli.serve
--serve_forever`) joins with ROADMAP §1 item 15.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger(__name__)

__all__ = ["HealthState", "MetricsExporter"]

# leak registry for the tests: every started-but-unclosed exporter is a leak.
_LIVE_EXPORTERS: list = []

_HEALTHY = frozenset({"starting", "training", "serving", "degraded"})
_STATES = frozenset(
    {"starting", "training", "serving", "degraded", "draining", "resizing",
     "preempted", "stopped", "failed"})


class HealthState:
    """Thread-safe process state with a transition timestamp."""

    def __init__(self, state: str = "starting", *, generation: int = 0):
        self._lock = threading.Lock()
        self._state = "starting"
        self._detail = None
        self._since = time.time()
        self.generation = int(generation)
        if state != "starting":
            self.set(state)

    def set(self, state: str, detail: str | None = None) -> None:
        if state not in _STATES:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            if state != self._state:
                self._since = time.time()
            self._state = state
            self._detail = detail

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def healthy(self) -> bool:
        with self._lock:
            return self._state in _HEALTHY

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "healthy": self._state in _HEALTHY,
                "detail": self._detail,
                "since_s": round(time.time() - self._since, 3),
                "generation": self.generation,
            }


# -- Prometheus text exposition -----------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(tag: str) -> str:
    """Total mangling: any tag becomes a valid Prometheus metric name."""
    name = _PROM_BAD.sub("_", str(tag))
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _prom_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def render_histogram_lines(name: str, hist) -> list[str]:
    """Prometheus text lines for one StreamingHistogram (cumulative
    buckets, ``_sum``/``_count``). Shared by the per-process exporter
    and the fleet scraper's merged view (obs/fleet.py)."""
    lines = [f"# TYPE {name} histogram"]
    cum = 0
    for edge, count in hist.buckets():
        # the overflow bucket IS le="+Inf"; the explicit total
        # line below covers it (emitting both would duplicate
        # the series)
        if count == 0 or math.isinf(edge):
            continue
        cum += count
        lines.append(f'{name}_bucket{{le="{repr(float(edge))}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {hist.count}')
    lines.append(f"{name}_sum {_prom_value(hist.sum)}")
    lines.append(f"{name}_count {hist.count}")
    return lines


def render_prometheus(registry, health: HealthState | None = None,
                      info: dict | None = None) -> str:
    """Render the registry (and health, as ``up``-style gauges) in
    Prometheus text exposition format.

    ``info`` is an optional identity-label dict (host_id / generation /
    role) rendered as a constant ``process_info{...} 1`` info-gauge so
    merged fleet series stay attributable to their source process.
    """
    lines: list[str] = []
    if registry is not None:
        for tag, (value, step, _wall) in sorted(registry.scalars().items()):
            name = _prom_name(tag)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_prom_value(value)}")
        for tag, hist in sorted(registry.histograms().items()):
            lines.extend(render_histogram_lines(_prom_name(tag), hist))
    if info:
        labels = ",".join(
            f'{_prom_name(k)}="{v}"' for k, v in sorted(info.items()))
        lines.append("# TYPE process_info gauge")
        lines.append(f"process_info{{{labels}}} 1")
    if health is not None:
        snap = health.snapshot()
        lines.append("# TYPE process_healthy gauge")
        lines.append(f"process_healthy {int(snap['healthy'])}")
        for s in sorted(_STATES):
            lines.append(
                f'process_state{{state="{s}"}} {int(snap["state"] == s)}')
    return "\n".join(lines) + "\n"


# -- HTTP server --------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    exporter: "MetricsExporter"  # set on the subclass per server

    def log_message(self, fmt, *args):  # quiet: the CLI's logging owns stderr
        log.debug("exporter: " + fmt, *args)

    def _send(self, code: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            exp = self.exporter
            if url.path == "/metrics":
                body = render_prometheus(exp.registry, exp.health,
                                         info=exp.info)
                if exp.fleet is not None:
                    body += exp.fleet.render_prometheus()
                self._send(200, body, "text/plain; version=0.0.4")
            elif url.path == "/fleet":
                if exp.fleet is None:
                    self._send(404, "no fleet scraper attached\n",
                               "text/plain")
                    return
                self._send(200,
                           json.dumps(exp.fleet.snapshot(), sort_keys=True),
                           "application/json")
            elif url.path == "/healthz":
                if exp.health is None:
                    self._send(200, json.dumps({"state": "unknown"}),
                               "application/json")
                    return
                snap = exp.health.snapshot()
                code = 200 if snap["healthy"] else 503
                self._send(code, json.dumps(snap, sort_keys=True),
                           "application/json")
            elif url.path == "/events":
                from dist_mnist_tpu_torch.obs import events as events_mod

                n = int(parse_qs(url.query).get("n", ["50"])[0])
                if exp.journal_path is None:
                    self._send(404, "no journal configured\n", "text/plain")
                    return
                recs = events_mod.tail_journal(exp.journal_path, n)
                body = "\n".join(
                    json.dumps(r, separators=(",", ":")) for r in recs)
                self._send(200, body + ("\n" if body else ""),
                           "application/x-ndjson")
            else:
                self._send(404, "not found\n", "text/plain")
        except Exception:  # noqa: BLE001 - never kill the serve thread
            log.warning("exporter request failed", exc_info=True)
            try:
                self._send(500, "internal error\n", "text/plain")
            except Exception:  # client already gone
                pass

    # -- serve data plane (POST) ----------------------------------------------
    # Wired only when the owning process is a serve replica
    # (cli/serve.py --serve_forever): /predict executes one inference via
    # exporter.predict_fn, /swap rolls the replica's weights via
    # exporter.swap_fn. Errors map to the typed statuses serve/router.py's
    # HttpReplica reconstructs (429 queue full, 503 shutting down, 504
    # deadline, 500 + error type otherwise), so a remote replica fails
    # EXACTLY like an in-process one under classify_failure.

    def _send_serve_error(self, err: BaseException) -> None:
        from dist_mnist_tpu_torch.serve.admission import (
            DeadlineExceededError,
            QueueFullError,
            ShuttingDownError,
        )

        code = 500
        if isinstance(err, DeadlineExceededError):
            code = 504  # before QueueFull/Shutdown: it's the narrow type
        elif isinstance(err, QueueFullError):
            code = 429
        elif isinstance(err, ShuttingDownError):
            code = 503
        self._send(code, json.dumps(
            {"error": type(err).__name__, "message": str(err)}),
            "application/json")

    def do_POST(self):  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            exp = self.exporter
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(length) if length else b""
            if url.path == "/predict":
                if exp.predict_fn is None:
                    self._send(404, "not a serve replica\n", "text/plain")
                    return
                import io as _io

                import numpy as _np

                q = parse_qs(url.query).get("deadline_ms", [None])[0]
                deadline_ms = float(q) if q not in (None, "", "None") else None
                image = _np.load(_io.BytesIO(body), allow_pickle=False)
                try:
                    res = exp.predict_fn(image, deadline_ms)
                except Exception as err:  # noqa: BLE001 - typed status below
                    self._send_serve_error(err)
                    return
                self._send(200, json.dumps({
                    "logits": _np.asarray(res.logits, dtype=float).tolist(),
                    "label": int(res.label),
                    "latency_ms": float(res.latency_ms),
                }), "application/json")
            elif url.path == "/swap":
                if exp.swap_fn is None:
                    self._send(404, "not a serve replica\n", "text/plain")
                    return
                step = int(parse_qs(url.query).get("step", ["-1"])[0])
                try:
                    out = exp.swap_fn(step)
                except Exception as err:  # noqa: BLE001 - typed status below
                    self._send_serve_error(err)
                    return
                self._send(200, json.dumps(
                    {"step": step, "result": out}, default=str),
                    "application/json")
            else:
                self._send(404, "not found\n", "text/plain")
        except Exception:  # noqa: BLE001 - never kill the serve thread
            log.warning("exporter POST failed", exc_info=True)
            try:
                self._send(500, "internal error\n", "text/plain")
            except Exception:  # client already gone
                pass


class MetricsExporter:
    """Background /metrics + /healthz + /events server for one process.

    With ``predict_fn``/``swap_fn`` wired it is also a serve replica's
    data plane: POST /predict and /swap next to the observability
    endpoints, one port per replica (see _Handler.do_POST)."""

    def __init__(self, registry=None, *, health: HealthState | None = None,
                 journal_path=None, port: int = 0, host: str = "127.0.0.1",
                 info: dict | None = None, fleet=None,
                 predict_fn=None, swap_fn=None):
        self.registry = registry
        self.health = health
        self.journal_path = journal_path
        # identity labels (host_id/generation/role) -> process_info gauge
        self.info = dict(info) if info else None
        # optional obs/fleet.FleetScraper: merged fleet series on /metrics
        # plus the /fleet JSON endpoint
        self.fleet = fleet
        # serve data plane: (image, deadline_ms) -> InferenceResult, and
        # step -> swap result; both None on pure-observability processes
        self.predict_fn = predict_fn
        self.swap_fn = swap_fn
        self.host = host
        self.port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        handler = type("_BoundHandler", (_Handler,), {"exporter": self})
        server = ThreadingHTTPServer((self.host, self.port), handler)
        server.daemon_threads = True
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"ObsExporter-{self.port}", daemon=True)
        _LIVE_EXPORTERS.append(self)
        self._thread.start()
        log.info("metrics exporter listening on http://%s:%d/metrics",
                 self.host, self.port)
        return self

    def close(self) -> None:
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5)
        if self in _LIVE_EXPORTERS:
            _LIVE_EXPORTERS.remove(self)

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
