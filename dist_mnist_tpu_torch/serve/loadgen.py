"""Deterministic closed-loop load generators (port of the reference
`serve/loadgen.py`: `run_loadgen` for the classifier server,
`make_varlen_images` and `run_longctx_loadgen` for its variable-height
zoo grid, `make_prompts` and `run_decode_loadgen` for the decode
scheduler).

Closed loop with a fixed concurrency window: at most `concurrency`
requests are in flight; each completion releases a slot for the next
submit, so offered load is self-clocking. Inputs are seeded (a uint8
image pool, or prompts and lengths), so every run of the same (seed,
n_requests) submits byte-identical requests in the same order.

`run_fleet_loadgen` is the two-class variant for a `serve/router.py`
Router: a seeded latency_sensitive/best_effort class sequence with
per-class deadlines and per-class accounting, which separates what the
tier policy may produce (best_effort shed) from what it must not
(latency_sensitive errors or drops). `diurnal_trace`, `burst_trace` and
`flash_crowd_trace` are seeded open-loop arrival schedules that
`run_trace_loadgen` replays against a Router (the autoscaler's traffic).
"""

from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as _FuturesTimeout

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


# -- trace-driven (open-loop) arrival processes -------------------------------
#
# The closed-loop generators above measure what a fleet CAN absorb; the
# autoscaler (serve/autoscale.py) needs the opposite: traffic that arrives
# on ITS schedule whether or not the fleet keeps up, so under-provisioning
# shows up as backlog/shed/latency instead of silently slowing the offered
# load. All three generators share one deterministic clock — a common
# rate-envelope integrator: arrival k lands where the cumulative intensity
# crosses ``k + u_k`` (u_k a seeded uniform jitter). The arrival COUNT in
# any window is therefore a pure function of the envelope (seed moves each
# arrival by less than one intensity unit), which is what lets tests pin
# rate envelopes exactly, and two runs with one seed submit byte-identical
# traffic at identical offsets — the precondition for the static-vs-
# autoscaled economics comparison in `bench.py --serve --autoscale`.

def _arrival_times(rate_fn, duration_s: float, seed: int,
                   dt: float = 0.005) -> np.ndarray:
    """Deterministic inhomogeneous arrival process: integrate the rate
    envelope (requests/sec over trace seconds) on a fixed grid and place
    arrival k at the instant the cumulative intensity crosses k + u_k."""
    grid = np.arange(0.0, duration_s + dt, dt)
    rates = np.maximum(np.asarray(rate_fn(grid), dtype=np.float64), 0.0)
    cum = np.concatenate(
        [[0.0], np.cumsum((rates[1:] + rates[:-1]) * 0.5 * dt)])
    n = int(np.floor(cum[-1]))
    rng = np.random.default_rng(seed)
    targets = np.arange(n) + rng.random(n)
    return np.interp(targets, cum, grid)


def diurnal_trace(*, duration_s: float, base_rps: float, peak_rps: float,
                  period_s: float | None = None, seed: int = 0) -> np.ndarray:
    """Sinusoidal daily wave compressed into ``period_s`` (default: one
    full period over the trace): trough ``base_rps`` at t=0, crest
    ``peak_rps`` mid-period."""
    period = float(period_s) if period_s is not None else float(duration_s)

    def rate(t):
        return base_rps + (peak_rps - base_rps) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * t / period))

    return _arrival_times(rate, duration_s, seed)


def burst_trace(*, duration_s: float, base_rps: float, burst_rps: float,
                burst_every_s: float, burst_len_s: float,
                seed: int = 0) -> np.ndarray:
    """Square-wave bursts: ``burst_rps`` for the first ``burst_len_s`` of
    every ``burst_every_s`` period, ``base_rps`` between."""

    def rate(t):
        return np.where(np.mod(t, burst_every_s) < burst_len_s,
                        burst_rps, base_rps)

    return _arrival_times(rate, duration_s, seed)


def flash_crowd_trace(*, duration_s: float, base_rps: float,
                      spike_at_s: float, spike_len_s: float,
                      spike_mult: float = 10.0, decay_s: float = 2.0,
                      seed: int = 0) -> np.ndarray:
    """Baseline -> a ``spike_mult``x flash crowd of ``spike_len_s`` ->
    linear decay back to baseline over ``decay_s``."""
    peak = base_rps * spike_mult

    def rate(t):
        t = np.asarray(t, dtype=np.float64)
        frac = np.clip(1.0 - (t - spike_at_s - spike_len_s) / decay_s,
                       0.0, 1.0)
        r = np.full_like(t, base_rps)
        r = np.where(t >= spike_at_s + spike_len_s,
                     base_rps + (peak - base_rps) * frac, r)
        return np.where((t >= spike_at_s) & (t < spike_at_s + spike_len_s),
                        peak, r)

    return _arrival_times(rate, duration_s, seed)


def run_trace_loadgen(
    router,
    *,
    arrivals: np.ndarray,
    image_shape: tuple[int, ...],
    seed: int = 0,
    ls_fraction: float = 0.8,
    ls_deadline_ms: float | None = None,
    be_deadline_ms: float | None = None,
    time_scale: float = 1.0,
    timeout: float = 180.0,
    keep_latencies: bool = False,
) -> dict:
    """Open-loop `run_fleet_loadgen`: submit on the TRACE's schedule.

    ``arrivals`` is a sorted array of trace-time offsets (seconds) from
    one of the generators above; ``time_scale`` maps trace seconds onto
    wall seconds (0.5 replays a trace at double speed). A generator that
    falls behind wall time submits immediately — burst catch-up is the
    point of open loop. Outcome taxonomy and summary shape match
    `run_fleet_loadgen`, plus the trace envelope under ``"trace"``."""
    import time as _t

    from dist_mnist_tpu_torch.serve.errors import AllReplicasDownError, ShedError
    from dist_mnist_tpu_torch.serve.router import (
        BEST_EFFORT,
        LATENCY_SENSITIVE,
        REQUEST_CLASSES,
    )

    arrivals = np.asarray(arrivals, dtype=np.float64)
    n_requests = int(arrivals.size)
    images = make_images(image_shape, seed=seed)
    rng = np.random.default_rng(seed)
    classes = np.where(rng.random(n_requests) < ls_fraction,
                       LATENCY_SENSITIVE, BEST_EFFORT)
    deadline_for = {LATENCY_SENSITIVE: ls_deadline_ms,
                    BEST_EFFORT: be_deadline_ms}
    futures: list = []  # (class, future)
    shed = {c: 0 for c in REQUEST_CLASSES}
    rejected = {c: 0 for c in REQUEST_CLASSES}

    t0 = _t.monotonic()
    for i in range(n_requests):
        wait = t0 + arrivals[i] * time_scale - _t.monotonic()
        if wait > 0:
            _t.sleep(wait)
        cls = str(classes[i])
        try:
            fut = router.submit(images[i % len(images)], request_class=cls,
                                deadline_ms=deadline_for[cls])
        except ShedError:
            shed[cls] += 1
            continue
        except (QueueFullError, ShuttingDownError, AllReplicasDownError):
            rejected[cls] += 1
            continue
        futures.append((cls, fut))
    submit_wall_s = _t.monotonic() - t0

    gather_deadline = _t.monotonic() + timeout
    ok = {c: 0 for c in REQUEST_CLASSES}
    deadline_expired = {c: 0 for c in REQUEST_CLASSES}
    errors = {c: 0 for c in REQUEST_CLASSES}
    dropped = {c: 0 for c in REQUEST_CLASSES}
    latencies = {c: [] for c in REQUEST_CLASSES}
    for cls, fut in futures:
        remaining = gather_deadline - _t.monotonic()
        try:
            res = fut.result(timeout=max(remaining, 0.001))
        except DeadlineExceededError:
            deadline_expired[cls] += 1
            continue
        except (TimeoutError, _FuturesTimeout):
            dropped[cls] += 1
            continue
        except Exception:
            errors[cls] += 1
            continue
        ok[cls] += 1
        latencies[cls].append(res.latency_ms)

    summary: dict = {
        "n_requests": n_requests,
        "ls_fraction": ls_fraction,
        "offered": {c: int((classes == c).sum()) for c in REQUEST_CLASSES},
        "ok": ok,
        "shed": shed,
        "rejected": rejected,
        "deadline_expired": deadline_expired,
        "errors": errors,
        "dropped": dropped,
        "trace": {
            "n_arrivals": n_requests,
            "duration_s": (round(arrivals[-1] * time_scale, 3)
                           if n_requests else 0.0),
            "time_scale": time_scale,
            "submit_wall_s": round(submit_wall_s, 3),
        },
    }
    for cls in REQUEST_CLASSES:
        summary[f"latency_{cls}"] = _pct(
            np.asarray(latencies[cls], dtype=np.float64))
    summary["total_ok"] = sum(ok.values())
    summary["router"] = router.metrics.snapshot()
    if keep_latencies:
        summary["raw_latencies"] = {c: list(latencies[c])
                                    for c in REQUEST_CLASSES}
    return summary


def _pct(lat: np.ndarray) -> dict:
    if not lat.size:
        return {"p50_ms": float("nan"), "p95_ms": float("nan"),
                "p99_ms": float("nan"), "mean_ms": float("nan")}
    return {
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()),
    }


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


def run_fleet_loadgen(
    router,
    *,
    n_requests: int,
    concurrency: int,
    image_shape: tuple[int, ...],
    seed: int = 0,
    ls_fraction: float = 0.8,
    ls_deadline_ms: float | None = None,
    be_deadline_ms: float | None = None,
    timeout: float = 180.0,
    keep_latencies: bool = False,
) -> dict:
    """Drive a `Router` with seeded two-class traffic; per-class summary.

    The class sequence is a fixed function of (seed, n_requests,
    ls_fraction), so two runs offer byte-identical traffic in the same
    order — which is what lets a fault-injected run be compared against
    a clean one request-for-request. Outcome taxonomy per class:
    `ok` / `shed` (router tier policy — only legitimate for best_effort) /
    `rejected` (queue-full / shutdown / all-down at submit) /
    `deadline_expired` / `errors` (post-admission failures) / `dropped`
    (future never settled inside `timeout` — always a bug).
    """
    from dist_mnist_tpu_torch.serve.errors import AllReplicasDownError, ShedError
    from dist_mnist_tpu_torch.serve.router import (
        BEST_EFFORT,
        LATENCY_SENSITIVE,
        REQUEST_CLASSES,
    )

    images = make_images(image_shape, seed=seed)
    rng = np.random.default_rng(seed)
    classes = np.where(rng.random(n_requests) < ls_fraction,
                       LATENCY_SENSITIVE, BEST_EFFORT)
    deadline_for = {LATENCY_SENSITIVE: ls_deadline_ms,
                    BEST_EFFORT: be_deadline_ms}
    window = threading.Semaphore(concurrency)
    futures: list = []  # (class, future)
    shed = {c: 0 for c in REQUEST_CLASSES}
    rejected = {c: 0 for c in REQUEST_CLASSES}

    for i in range(n_requests):
        cls = str(classes[i])
        window.acquire()
        try:
            fut = router.submit(images[i % len(images)], request_class=cls,
                                deadline_ms=deadline_for[cls])
        except ShedError:
            shed[cls] += 1
            window.release()
            continue
        except (QueueFullError, ShuttingDownError, AllReplicasDownError):
            rejected[cls] += 1
            window.release()
            continue
        fut.add_done_callback(lambda _f: window.release())
        futures.append((cls, fut))

    import time as _t

    gather_deadline = _t.monotonic() + timeout
    ok = {c: 0 for c in REQUEST_CLASSES}
    deadline_expired = {c: 0 for c in REQUEST_CLASSES}
    errors = {c: 0 for c in REQUEST_CLASSES}
    dropped = {c: 0 for c in REQUEST_CLASSES}
    latencies = {c: [] for c in REQUEST_CLASSES}
    for cls, fut in futures:
        remaining = gather_deadline - _t.monotonic()
        try:
            res = fut.result(timeout=max(remaining, 0.001))
        except DeadlineExceededError:
            deadline_expired[cls] += 1
            continue
        except (TimeoutError, _FuturesTimeout):
            # the future itself never settled — an in-flight request was
            # dropped on the floor somewhere, which the router contract
            # forbids; surfaced separately so tests can pin dropped == 0
            dropped[cls] += 1
            continue
        except Exception:
            errors[cls] += 1
            continue
        ok[cls] += 1
        latencies[cls].append(res.latency_ms)

    summary: dict = {
        "n_requests": n_requests,
        "concurrency": concurrency,
        "ls_fraction": ls_fraction,
        "offered": {c: int((classes == c).sum()) for c in REQUEST_CLASSES},
        "ok": ok,
        "shed": shed,
        "rejected": rejected,
        "deadline_expired": deadline_expired,
        "errors": errors,
        "dropped": dropped,
    }
    for cls in REQUEST_CLASSES:
        summary[f"latency_{cls}"] = _pct(
            np.asarray(latencies[cls], dtype=np.float64))
    summary["total_ok"] = sum(ok.values())
    summary["router"] = router.metrics.snapshot()
    if keep_latencies:
        summary["raw_latencies"] = {c: list(latencies[c])
                                    for c in REQUEST_CLASSES}
    return summary
