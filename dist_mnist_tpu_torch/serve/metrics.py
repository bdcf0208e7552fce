"""Serve-side metrics: latency percentiles, batch occupancy, admission
counters (port of the reference `serve/metrics.py`: `ServeMetrics` for
the classifier server, `DecodeMetrics` for the decode scheduler).

Host-side and lock-guarded (the batcher thread and every client thread
record concurrently); nothing here touches a device. Emission goes through
the `obs.writers.MetricWriter` protocol (`emit`) so serve metrics land in
the same CSV/TensorBoard sinks as training metrics.

Percentiles come from `obs.hist.StreamingHistogram` ladders: O(buckets)
memory forever, mergeable across replicas, and attachable to a
`MetricRegistry` (`attach_to`) so a live `/metrics` scrape sees the same
distribution the final snapshot reports.
"""

from __future__ import annotations

import math
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
                The per-leaf int8 quantization errors, and their max.
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
        # int8 weight-only serving (ops/quant.py): per-leaf max-abs
        # quantization errors of the load-time conversion, recorded once
        # per report; empty forever on a float engine
        self.quant_error = StreamingHistogram()
        self.quant_error_max: float | None = None

    def attach_to(self, registry) -> None:
        """Expose the live ladders on a MetricRegistry (-> /metrics)."""
        registry.attach_histogram("serve/latency_ms", self.latency_ms)
        registry.attach_histogram("serve/batch_size", self.batch_size)
        registry.attach_histogram("serve/batch_occupancy",
                                  self.batch_occupancy)
        registry.attach_histogram("serve/seq_occupancy", self.seq_occupancy)
        registry.attach_histogram("serve/moe_drop_fraction",
                                  self.moe_drop_fraction)
        registry.attach_histogram("serve/quant_error", self.quant_error)

    def record_quant_report(self, report: dict) -> None:
        """Fold an `ops.quant.error_report` in: one histogram observation
        per quantized leaf (max abs error), plus the scalar max. Called at
        server construction and again on each quantized hot swap."""
        leaves = (report or {}).get("leaves", {})
        with self._lock:
            for stats in leaves.values():
                self.quant_error.observe(stats["max_abs_err"])
            m = (report or {}).get("max_abs_err")
            if m is not None:
                self.quant_error_max = max(self.quant_error_max or 0.0, m)

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

    @property
    def inflight(self) -> int:
        """Admitted requests whose futures have not settled yet (queued or
        mid-batch): what `InferenceServer.quiesce` waits on. Admission
        rejections never count as admitted, so the four settle paths
        (completed, expired, failed, cancelled) are exhaustive."""
        with self._lock:
            return self.admitted - (self.completed + self.rejected_deadline
                                    + self.failed + self.cancelled)

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

    def emit(self, writer, step: int, *, queue_depth: int | None = None,
             cache: dict | None = None) -> None:
        """Write the snapshot through an obs MetricWriter. `serve/` prefix
        keeps the tags clear of training scalars in a shared logdir. All
        scalars go out as ONE batched `scalars()` call (the hook
        convention — one writer call per cadence, not ~12)."""
        snap = self.snapshot()
        vals: dict[str, float] = {}
        for tag in ("p50_ms", "p95_ms", "p99_ms", "mean_ms"):
            v = snap[tag]
            if not math.isnan(v):
                vals[f"serve/latency_{tag}"] = v
        for tag in ("admitted", "completed", "rejected_queue_full",
                    "rejected_deadline", "rejected_shutdown", "failed",
                    "cancelled"):
            vals[f"serve/{tag}"] = snap[tag]
        vals["serve/mean_batch_size"] = snap["mean_batch_size"]
        vals["serve/mean_occupancy"] = snap["mean_occupancy"]
        if "mean_seq_occupancy" in snap:
            vals["serve/mean_seq_occupancy"] = snap["mean_seq_occupancy"]
        if "mean_moe_drop_fraction" in snap:
            vals["serve/mean_moe_drop_fraction"] = \
                snap["mean_moe_drop_fraction"]
        if "quant_error_max" in snap:
            vals["serve/quant_error_max"] = snap["quant_error_max"]
        if queue_depth is not None:
            vals["serve/queue_depth"] = queue_depth
        if cache:
            vals["serve/cache_hits"] = cache.get("hits", 0)
            vals["serve/cache_misses"] = cache.get("misses", 0)
            if cache.get("evictions"):
                vals["serve/cache_evictions"] = cache["evictions"]
            if cache.get("resident_bytes"):
                vals["serve/resident_bytes"] = cache["resident_bytes"]
                # which tier the budget is spending on: the weights floor
                # vs the evictable executable set
                vals["serve/resident_bytes_weights"] = \
                    cache.get("resident_bytes_weights", 0)
                vals["serve/resident_bytes_executables"] = \
                    cache.get("resident_bytes_executables", 0)
        batch_write = getattr(writer, "scalars", None)
        if callable(batch_write):
            batch_write(vals, step)
        else:
            for k, v in vals.items():
                writer.scalar(k, v, step)
        if self.batch_size.count:
            writer.histogram("serve/batch_size",
                             self.batch_size.representative_values(), step)
            writer.histogram("serve/batch_occupancy",
                             self.batch_occupancy.representative_values(),
                             step)
        writer.flush()


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

    def attach_to(self, registry) -> None:
        """Expose the live ladders on a MetricRegistry (-> /metrics)."""
        registry.attach_histogram("serve/decode_ttft_ms", self.ttft_ms)
        registry.attach_histogram("serve/decode_tokens_per_s",
                                  self.tokens_per_s)
        registry.attach_histogram("serve/decode_active_slots",
                                  self.active_slots)

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

    def emit(self, writer, step: int, *, queue_depth: int | None = None,
             cache: dict | None = None, kv: dict | None = None) -> None:
        """Write the snapshot through an obs MetricWriter — one batched
        `scalars()` call, same cadence convention as `ServeMetrics.emit`.
        `kv` is a `DecodeEngine.kv_stats()` dict; when given, the paged
        KV residency gauges (`serve/decode_kv_*`) ride along."""
        snap = self.snapshot()
        vals: dict[str, float] = {}
        vals["serve/decode_submitted"] = snap["submitted"]
        vals["serve/decode_completed"] = snap["completed"]
        vals["serve/decode_rejected_queue_full"] = \
            snap["rejected_queue_full"]
        vals["serve/decode_rejected_shutdown"] = snap["rejected_shutdown"]
        vals["serve/decode_failed"] = snap["failed"]
        vals["serve/decode_steps"] = snap["steps"]
        vals["serve/decode_tokens_out"] = snap["tokens_out"]
        vals["serve/decode_mean_active_slots"] = snap["mean_active_slots"]
        if "ttft_p50_ms" in snap:
            vals["serve/decode_ttft_p50_ms"] = snap["ttft_p50_ms"]
            vals["serve/decode_ttft_p99_ms"] = snap["ttft_p99_ms"]
        if "tokens_per_s_mean" in snap:
            vals["serve/decode_tokens_per_s"] = snap["tokens_per_s_mean"]
        if queue_depth is not None:
            vals["serve/decode_queue_depth"] = queue_depth
        if cache:
            vals["serve/cache_hits"] = cache.get("hits", 0)
            vals["serve/cache_misses"] = cache.get("misses", 0)
        if kv:
            vals["serve/decode_kv_pages_pinned"] = kv["kv_pages_pinned"]
            vals["serve/decode_kv_bytes_pinned"] = kv["kv_bytes_pinned"]
            vals["serve/decode_kv_bytes_pool"] = kv["kv_bytes_pool"]
        batch_write = getattr(writer, "scalars", None)
        if callable(batch_write):
            batch_write(vals, step)
        else:
            for k, v in vals.items():
                writer.scalar(k, v, step)
        if self.ttft_ms.count:
            writer.histogram("serve/decode_ttft_ms",
                             self.ttft_ms.representative_values(), step)
            writer.histogram("serve/decode_active_slots",
                             self.active_slots.representative_values(), step)
        writer.flush()
