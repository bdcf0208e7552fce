"""Deterministic closed-loop load generator (port of the reference
`serve/loadgen.py run_loadgen`).

Closed loop with a fixed concurrency window: at most `concurrency`
requests are in flight; each completion releases a slot for the next
submit, so offered load is self-clocking. Images are a fixed seeded uint8
pool, so every run of the same (seed, n_requests) submits byte-identical
inputs in the same order. The router/fleet variants join with the fleet
slice.
"""

from __future__ import annotations

import threading

import numpy as np

from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    QueueFullError,
    ShuttingDownError,
)

# fixed input pool size: big enough to defeat any value-level caching,
# small enough to keep generation instant
_POOL = 256


def make_images(image_shape: tuple[int, ...], seed: int = 0,
                n: int = _POOL) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, *image_shape), dtype=np.uint8)


def run_loadgen(
    server,
    *,
    n_requests: int,
    concurrency: int,
    image_shape: tuple[int, ...],
    seed: int = 0,
    deadline_ms: float | None = None,
    timeout: float = 120.0,
) -> dict:
    """Drive `server` and return a summary dict (latency percentiles,
    rejection counts, batching stats, bucket stats). Deterministic inputs;
    raises on a hung run rather than reporting partial numbers."""
    images = make_images(image_shape, seed=seed)
    window = threading.Semaphore(concurrency)
    futures = []
    rejected_queue_full = 0
    rejected_shutdown = 0

    for i in range(n_requests):
        window.acquire()
        try:
            fut = server.submit(images[i % len(images)],
                                deadline_ms=deadline_ms)
        except QueueFullError:
            rejected_queue_full += 1
            window.release()
            continue
        except ShuttingDownError:
            rejected_shutdown += 1
            window.release()
            continue
        fut.add_done_callback(lambda _f: window.release())
        futures.append(fut)

    ok = 0
    deadline_expired = 0
    errors = 0
    latencies = []
    for fut in futures:
        try:
            res = fut.result(timeout=timeout)
        except DeadlineExceededError:
            deadline_expired += 1
            continue
        except Exception:
            errors += 1
            continue
        ok += 1
        latencies.append(res.latency_ms)

    lat = np.asarray(latencies, dtype=np.float64)
    summary = {
        "n_requests": n_requests,
        "concurrency": concurrency,
        "ok": ok,
        "rejected_queue_full": rejected_queue_full,
        "rejected_shutdown": rejected_shutdown,
        "deadline_expired": deadline_expired,
        "errors": errors,
        "p50_ms": float(np.percentile(lat, 50)) if lat.size else float("nan"),
        "p95_ms": float(np.percentile(lat, 95)) if lat.size else float("nan"),
        "p99_ms": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        "mean_ms": float(lat.mean()) if lat.size else float("nan"),
    }
    stats = server.stats()
    summary["mean_batch_size"] = stats["mean_batch_size"]
    summary["mean_occupancy"] = stats["mean_occupancy"]
    summary["n_batches"] = stats["n_batches"]
    summary["cache"] = stats["cache"]
    return summary
