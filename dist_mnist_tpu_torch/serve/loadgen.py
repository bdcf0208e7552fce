"""Deterministic closed-loop load generators (port of the reference
`serve/loadgen.py`: `run_loadgen` for the classifier server,
`make_varlen_images` and `run_longctx_loadgen` for its variable-height
zoo grid, `make_prompts` and `run_decode_loadgen` for the decode
scheduler).

Closed loop with a fixed concurrency window: at most `concurrency`
requests are in flight; each completion releases a slot for the next
submit, so offered load is self-clocking. Inputs are seeded (a uint8
image pool, or prompts and lengths), so every run of the same (seed,
n_requests) submits byte-identical requests in the same order. The
router/fleet variants join with the fleet slice.
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
    image_shape: tuple[int, ...] | None = None,
    seed: int = 0,
    deadline_ms: float | None = None,
    timeout: float = 120.0,
    images=None,
) -> dict:
    """Drive `server` and return a summary dict (latency percentiles,
    rejection counts, batching stats, bucket stats). Deterministic inputs:
    the seeded pool of `image_shape` images, or `images` when given
    (`run_longctx_loadgen`'s variable-height pool); raises on a hung run
    rather than reporting partial numbers."""
    if images is None:
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


def make_varlen_images(image_shape: tuple[int, ...], patch: int,
                       seed: int = 0, n: int = _POOL) -> list[np.ndarray]:
    """Seeded pool of variable-HEIGHT images for the zoo's long-context
    path (the reference's draws): each entry's height a patch multiple
    drawn uniformly from [patch, native], width and channels fixed, so
    every patch token is wholly real."""
    native_h = image_shape[0]
    rest = tuple(image_shape[1:])
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, native_h // patch + 1, size=n)
    return [rng.integers(0, 256, size=(int(k) * patch, *rest),
                         dtype=np.uint8) for k in ks]


def run_longctx_loadgen(
    server,
    *,
    n_requests: int,
    concurrency: int,
    seed: int = 0,
    deadline_ms: float | None = None,
    timeout: float = 240.0,
) -> dict:
    """`run_loadgen` for a zoo engine's 2-D grid: variable-height seeded
    traffic, plus the per-seq-bucket routing counts and the engine's
    first-run (miss) delta, which shows the grid absorbed every shape
    without a first run on the hot path. Requires `server.engine.seq_grid`."""
    engine = server.engine
    grid = getattr(engine, "seq_grid", None)
    if grid is None:
        raise ValueError("run_longctx_loadgen needs a seq-grid engine "
                         "(serve/zoo.py build_zoo_engine seq_buckets=...)")
    images = make_varlen_images(
        (grid.native_height, grid.width, grid.channels), grid.patch,
        seed=seed)
    misses0 = engine.misses
    buckets0 = dict(engine.seq_bucket_counts)
    summary = run_loadgen(server, n_requests=n_requests,
                          concurrency=concurrency, deadline_ms=deadline_ms,
                          timeout=timeout, images=images)
    # first runs DURING the traffic: 0 after a full prewarm is the zoo's
    # guarantee that no request paid one
    summary["recompiles_during_traffic"] = engine.misses - misses0
    counts = engine.seq_bucket_counts
    summary["seq_bucket_counts"] = {
        str(h): counts.get(h, 0) - buckets0.get(h, 0)
        for h in grid.heights
        if counts.get(h, 0) - buckets0.get(h, 0)
    }
    summary["mean_seq_occupancy"] = server.stats().get(
        "mean_seq_occupancy", 1.0)
    return summary


def make_prompts(n: int, *, max_seq: int, seed: int = 0,
                 min_prompt: int = 2, max_prompt: int | None = None,
                 min_new: int = 1, max_new: int | None = None,
                 vocab_size: int = 256):
    """Seeded decode traffic: `n` (prompt, max_new_tokens) pairs, a fixed
    function of the arguments (the reference's draws, so both packages
    make the same requests). ``prompt + max_new <= max_seq`` always."""
    if max_prompt is None:
        max_prompt = max(min_prompt, max_seq // 2)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        hi = max_new if max_new is not None else max_seq - plen
        hi = min(hi, max_seq - plen)
        new = int(rng.integers(min_new, max(min_new, hi) + 1))
        prompt = rng.integers(0, vocab_size, size=plen, dtype=np.int32)
        out.append((prompt, new))
    return out


def run_decode_loadgen(
    scheduler,
    *,
    n_requests: int,
    concurrency: int,
    seed: int = 0,
    min_prompt: int = 2,
    max_prompt: int | None = None,
    max_new: int | None = None,
    timeout: float = 240.0,
    keep_streams: bool = False,
) -> dict:
    """Drive a `serve/decode.DecodeScheduler` with seeded traffic, closed
    loop like `run_loadgen`. Returns the decode SLO summary: TTFT
    percentiles (submit -> first token), per-request throughput (tokens /
    generation wall time), per-request token timestamps, the scheduler's
    snapshot, and with `keep_streams` each request's token stream. Every
    request is best_effort (latency_sensitive ones are submitted by hand,
    as the SLO tests do)."""
    reqs = make_prompts(n_requests, max_seq=scheduler.engine.max_seq,
                        seed=seed, min_prompt=min_prompt,
                        max_prompt=max_prompt, max_new=max_new,
                        vocab_size=scheduler.engine.model.vocab_size)
    window = threading.Semaphore(concurrency)
    futures = []
    rejected_queue_full = 0
    rejected_shutdown = 0

    for prompt, new in reqs:
        window.acquire()
        try:
            fut = scheduler.submit(prompt, new)
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
    errors = 0
    ttfts = []
    latencies = []
    tokens_per_s = []
    tokens_out = 0
    streams = []
    token_times = []
    for fut in futures:
        try:
            res = fut.result(timeout=timeout)
        except Exception:
            errors += 1
            continue
        ok += 1
        ttfts.append(res.ttft_ms)
        latencies.append(res.latency_ms)
        tokens_out += len(res.tokens)
        tokens_per_s.append(len(res.tokens) / max(res.latency_ms / 1e3,
                                                  1e-9))
        token_times.append(list(res.token_times))
        if keep_streams:
            streams.append(list(res.tokens))

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else float("nan")

    ttft = np.asarray(ttfts, dtype=np.float64)
    tps = np.asarray(tokens_per_s, dtype=np.float64)
    lat = np.asarray(latencies, dtype=np.float64)
    summary = {
        "n_requests": n_requests,
        "concurrency": concurrency,
        "mode": scheduler.mode,
        "ok": ok,
        "errors": errors,
        "rejected_queue_full": rejected_queue_full,
        "rejected_shutdown": rejected_shutdown,
        "tokens_out": tokens_out,
        "ttft_p50_ms": pct(ttft, 50),
        "ttft_p99_ms": pct(ttft, 99),
        "ttft_mean_ms": float(ttft.mean()) if ttft.size else float("nan"),
        "tokens_per_s_p50": pct(tps, 50),
        "tokens_per_s_mean": float(tps.mean()) if tps.size
        else float("nan"),
        "token_times": token_times,
        "p50_ms": pct(lat, 50),
        "p95_ms": pct(lat, 95),
        "p99_ms": pct(lat, 99),
        "mean_ms": float(lat.mean()) if lat.size else float("nan"),
        "scheduler": scheduler.metrics.snapshot(),
    }
    if keep_streams:
        summary["streams"] = streams
    return summary
