"""Serve-side metrics: latency percentiles, batch occupancy, admission
counters (port of the reference `serve/metrics.py ServeMetrics`).

Host-side and lock-guarded (the batcher thread and every client thread
record concurrently); nothing here touches a device. Percentiles come
from `obs.hist.StreamingHistogram` ladders. Metric writers and the
`/metrics` registry join with the telemetry slice; `snapshot()` is the
whole read surface for now.
"""

from __future__ import annotations

import threading

from dist_mnist_tpu_torch.obs.hist import StreamingHistogram


class ServeMetrics:
    """Thread-safe accumulator for one server's lifetime.

    Counters:   admitted, completed, rejected_queue_full, rejected_deadline,
                rejected_shutdown, failed, cancelled.
    Histograms: request latency (ms, submit->result), executed batch sizes
                (real rows), bucket occupancy (real rows / padded bucket).
    Gauge:      the largest per-leaf int8 quantization error.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.admitted = 0
        self.completed = 0
        self.rejected_queue_full = 0
        self.rejected_deadline = 0
        self.rejected_shutdown = 0
        self.failed = 0
        self.cancelled = 0
        self.latency_ms = StreamingHistogram()
        self.batch_size = StreamingHistogram()
        self.batch_occupancy = StreamingHistogram()
        self.quant_error_max: float | None = None

    def record_quant_report(self, report: dict) -> None:
        """Fold an `ops.quant.error_report` in: its max abs error."""
        with self._lock:
            self.quant_error_max = max(self.quant_error_max or 0.0,
                                       report["max_abs_err"])

    def record_admitted(self):
        with self._lock:
            self.admitted += 1

    def record_rejected(self, reason: str):
        with self._lock:
            if reason == "queue_full":
                self.rejected_queue_full += 1
            elif reason == "deadline":
                self.rejected_deadline += 1
            elif reason == "shutdown":
                self.rejected_shutdown += 1
            else:
                raise ValueError(f"unknown rejection reason {reason!r}")

    def record_failed(self, n: int = 1):
        with self._lock:
            self.failed += n

    def record_cancelled(self, n: int = 1):
        with self._lock:
            self.cancelled += n

    def record_batch(self, n_real: int, bucket: int):
        """One executed batch: `n_real` genuine requests padded to `bucket`."""
        self.batch_size.observe(n_real)
        self.batch_occupancy.observe(n_real / bucket)

    def record_latency(self, ms: float, n: int = 1):
        self.latency_ms.observe(ms)
        with self._lock:
            self.completed += n

    def latency_percentiles(self) -> dict[str, float]:
        s = self.latency_ms.snapshot()
        if not s["count"]:
            return {"p50_ms": float("nan"), "p95_ms": float("nan"),
                    "p99_ms": float("nan"), "mean_ms": float("nan")}
        return {"p50_ms": s["p50"], "p95_ms": s["p95"], "p99_ms": s["p99"],
                "mean_ms": s["mean"]}

    def snapshot(self) -> dict:
        """Point-in-time summary (plain floats/ints — JSON-safe)."""
        pct = self.latency_percentiles()
        sizes = self.batch_size.snapshot()
        occ = self.batch_occupancy.snapshot()
        with self._lock:
            out = {
                "admitted": self.admitted,
                "completed": self.completed,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_deadline": self.rejected_deadline,
                "rejected_shutdown": self.rejected_shutdown,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "n_batches": int(sizes["count"]),
            }
        out.update(pct)
        out["mean_batch_size"] = sizes["mean"] if sizes["count"] else 0.0
        out["mean_occupancy"] = occ["mean"] if occ["count"] else 0.0
        if self.quant_error_max is not None:
            out["quant_error_max"] = self.quant_error_max
        return out
