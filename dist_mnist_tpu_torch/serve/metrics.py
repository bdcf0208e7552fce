"""Serve-side metrics: latency percentiles, batch occupancy, admission
counters (port of the reference `serve/metrics.py`: `ServeMetrics` for
the classifier server, `DecodeMetrics` for the decode scheduler).

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
                (real rows), bucket occupancy (real rows / padded bucket),
                sequence occupancy (real tokens / padded tokens, seq-grid
                engines).
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
        self.seq_occupancy = StreamingHistogram()
        self.moe_drop_fraction = StreamingHistogram()
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

    def record_batch(self, n_real: int, bucket: int,
                     seq_occupancy: float | None = None,
                     moe_drop_fraction: float | None = None):
        """One executed batch: `n_real` genuine requests padded to `bucket`;
        `seq_occupancy` (real tokens / padded tokens, serve/zoo.py seq
        buckets) when the engine has a seq grid, and `moe_drop_fraction`
        (routed-overflow drops of an MoE forward) when it serves one."""
        self.batch_size.observe(n_real)
        self.batch_occupancy.observe(n_real / bucket)
        if seq_occupancy is not None:
            self.seq_occupancy.observe(seq_occupancy)
        if moe_drop_fraction is not None:
            self.moe_drop_fraction.observe(moe_drop_fraction)

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
        seq = self.seq_occupancy.snapshot()
        if seq["count"]:
            out["mean_seq_occupancy"] = seq["mean"]
        drop = self.moe_drop_fraction.snapshot()
        if drop["count"]:
            out["mean_moe_drop_fraction"] = drop["mean"]
            out["max_moe_drop_fraction"] = drop.get("max", drop["mean"])
        if self.quant_error_max is not None:
            out["quant_error_max"] = self.quant_error_max
        return out


class DecodeMetrics:
    """Thread-safe accumulator for one `serve.decode.DecodeScheduler`.

    Decode serving's two SLOs get their own signals: **TTFT** (submit ->
    first token, the latency_sensitive target) and **per-token
    throughput** (tokens / generation wall time, the best_effort target).
    Slot occupancy per decode step shows how full continuous batching
    keeps the card — the static baseline's tail-off between batches is
    visible here."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.submitted_latency_sensitive = 0
        self.completed = 0
        self.rejected_queue_full = 0
        self.rejected_shutdown = 0
        self.failed = 0
        self.steps = 0
        self.tokens_out = 0
        self.ttft_ms = StreamingHistogram()
        self.tokens_per_s = StreamingHistogram()
        self.active_slots = StreamingHistogram()

    def record_submitted(self, request_class: str):
        with self._lock:
            self.submitted += 1
            if request_class == "latency_sensitive":
                self.submitted_latency_sensitive += 1

    def record_rejected(self, reason: str):
        with self._lock:
            if reason == "queue_full":
                self.rejected_queue_full += 1
            elif reason == "shutdown":
                self.rejected_shutdown += 1
            else:
                raise ValueError(f"unknown rejection reason {reason!r}")

    def record_admitted(self, ttft_ms: float, request_class: str):
        self.ttft_ms.observe(ttft_ms)

    def record_completed(self, latency_ms: float, n_tokens: int,
                         tokens_per_s: float):
        self.tokens_per_s.observe(tokens_per_s)
        with self._lock:
            self.completed += 1
            self.tokens_out += n_tokens

    def record_failed(self, n: int = 1):
        with self._lock:
            self.failed += n

    def record_step(self, n_active: int):
        """One decode step with `n_active` live slots (of max_slots)."""
        self.active_slots.observe(n_active)
        with self._lock:
            self.steps += 1

    def snapshot(self) -> dict:
        """Point-in-time summary (plain floats/ints — JSON-safe)."""
        ttft = self.ttft_ms.snapshot()
        tps = self.tokens_per_s.snapshot()
        act = self.active_slots.snapshot()
        with self._lock:
            out = {
                "submitted": self.submitted,
                "submitted_latency_sensitive":
                    self.submitted_latency_sensitive,
                "completed": self.completed,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_shutdown": self.rejected_shutdown,
                "failed": self.failed,
                "steps": self.steps,
                "tokens_out": self.tokens_out,
            }
        if ttft["count"]:
            out["ttft_p50_ms"] = ttft["p50"]
            out["ttft_p99_ms"] = ttft["p99"]
            out["ttft_mean_ms"] = ttft["mean"]
        if tps["count"]:
            out["tokens_per_s_p50"] = tps["p50"]
            out["tokens_per_s_mean"] = tps["mean"]
        out["mean_active_slots"] = act["mean"] if act["count"] else 0.0
        return out
