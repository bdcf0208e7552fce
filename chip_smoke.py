#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dist_mnist_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU and `nvcc`; exits nonzero, printing no result, when
there is no CUDA device or when the port's package is not beside this
script. Phases (any failure exits nonzero before the final `ok` line):

1. print the card's name and power limit as `nvidia-smi` reports them;
2. build every CUDA kernel of the served path from the checkout's sources
   (`dist_mnist_tpu_torch/csrc/`, one `nvcc` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   path's shapes — LeNet-5 fc1 [M,3136]x[3136,512] and fc2 [M,512]x[512,10]
   in bf16, the MLP's [M,784]x[784,100] and [M,100]x[100,10] in f32, for
   M in {1, 7, 64} — within 1e-2 (bf16) and 2e-5 (f32) of the largest
   output;
4. serve `lenet5_mnist --quant=int8` (seeded fresh init) on the card
   through the serving CLI's entry point (`cli/serve.py main`: server +
   closed-loop loadgen, 512 requests), with every launch counter set to 0
   just before and read just after; check that the int8 weights quantized
   on the card equal the CPU's bit for bit; then check one fixed batch of
   served logits (finite, [64, 10]) against the same engine with the
   kernel swapped for its plain version: max abs difference <= 0.04 (the
   bf16 logit bound the JAX package's tests use) and the same top-1 on
   >= 98% of rows; then time one served batch of 64 on the host clock and
   break its device time down by kernel with `torch.profiler`;
5. time each kernel at the shapes the path gives it, beside its plain
   version and one library call computing the same function, each as a
   CUDA graph of back-to-back calls timed with CUDA events (L2 warm), and
   compute its bound: max(bytes / memory rate, FLOPs / peak rate for the
   operands' type) for the card;
6. print the `{"kernels": [...]}` line, then, last, the `ok` line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: memory bytes/s and dense peak FLOP/s by operand type, by card (NVIDIA
#: data sheets): bf16 on the tensor cores, float32 outside them (the
#: kernel's float32 path is full-precision FMA, not TF32)
_CARD_RATES = {"pcie": (2.0e12, {"bfloat16": 756e12, "float32": 51e12}),
               "sxm": (3.35e12, {"bfloat16": 989e12, "float32": 67e12})}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) in f32."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-12)


def graph_ms(torch, fn, calls: int = 100, rounds: int = 5) -> float:
    """Device ms per call: `calls` calls captured in one CUDA graph, the
    graph replayed under CUDA events; median over `rounds` replays."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()  # warm-up outside the capture (allocator, handles)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import dist_mnist_tpu_torch
    except ImportError as err:
        fail(f"the port's package is not beside chip_smoke.py ({err})")
    if Path(dist_mnist_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported {dist_mnist_tpu_torch.__file__}, not the checkout's")

    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels import build
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul,
        quant_matmul_cost,
        quant_matmul_reference,
    )
    from dist_mnist_tpu_torch.cli import serve as serve_cli
    from dist_mnist_tpu_torch.serve import (
        InferenceEngine,
        load_for_serving,
        make_images,
    )

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0].strip()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, peaks = _CARD_RATES["pcie" if "PCIe" in kind else "sxm"]
    # the plain versions' f32 products in full f32, as the kernel sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(["quant_matmul"])
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0}), flush=True)
    for src, log in build.build_logs.items():
        print(f"--- nvcc {src}.cu ---\n{log.strip()}", flush=True)

    # -- 3. kernel vs plain version at the path's shapes ---------------------
    shapes = [("lenet5/fc1", 3136, 512, torch.bfloat16),
              ("lenet5/fc2", 512, 10, torch.bfloat16),
              ("mlp/hid", 784, 100, torch.float32),
              ("mlp/sm", 100, 10, torch.float32)]
    gen = torch.Generator().manual_seed(0)
    operands, worst = {}, {"abs": 0.0, "rel": 0.0}
    for label, d, h, dtype in shapes:
        w = torch.randn(d, h, generator=gen) / d ** 0.5
        qa = quant_mod.quantize(w.to(dev))
        for m in (1, 7, 64):
            x = torch.rand(m, d, generator=gen).to(dev, dtype)
            got = quant_matmul(x, qa.q, qa.scale)
            want = quant_matmul_reference(x, qa.q, qa.scale)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
            print(json.dumps({"phase": "parity", "shape": label, "m": m,
                              "dtype": str(dtype), "max_abs_err": abs_err,
                              "max_rel_err": rel, "tol": tol}), flush=True)
            if not (got.shape == want.shape and rel <= tol):
                fail(f"quant_matmul {label} M={m}: rel err {rel} > {tol}")
            worst["abs"] = max(worst["abs"], abs_err)
            worst["rel"] = max(worst["rel"], rel)
            operands[(label, m)] = (x, qa)

    # -- 4. the served path, through the serving CLI's entry point ----------
    quant_matmul.launches = 0
    summary = serve_cli.main([
        "--config=lenet5_mnist", "--quant=int8", "--device=cuda:0",
        "--max_batch=64", "--requests=512", "--concurrency=64"])
    launches = quant_matmul.launches
    print(json.dumps({"phase": "serve", "quant_matmul_launches": launches,
                      **{k: summary[k] for k in (
                          "ok", "errors", "p50_ms", "p99_ms", "n_batches",
                          "mean_batch_size", "cache")}}), flush=True)
    n_runs = summary["cache"]["hits"] + summary["cache"]["misses"]
    if summary["ok"] != 512 or summary["errors"] != 0:
        fail(f"serve: {summary['ok']}/512 ok, {summary['errors']} errors")
    if launches != 2 * n_runs or launches == 0:
        fail(f"serve: {launches} quant_matmul launches for {n_runs} "
             "LeNet-5 batches (want 2 per batch: fc1, fc2)")
    # the same seeded weights again, for one fixed batch: kernel vs plain.
    # Quantized on the card, their int8 leaves must equal the CPU's bit for
    # bit (the CPU's are pinned to the JAX package's by the CPU tests).
    bundle = load_for_serving("lenet5_mnist", dev, quant="int8")
    on_cpu = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    for layer, leaves in on_cpu.params.items():
        got, want = bundle.params[layer]["w"], leaves["w"]
        same_scale = torch.equal(got.scale.cpu().view(torch.int32),
                                 want.scale.view(torch.int32))
        if not (same_scale and torch.equal(got.q.cpu(), want.q)):
            fail(f"int8 {layer}/w quantized on the card differs from "
                 "the CPU's")
    engine = InferenceEngine(
        bundle.model, bundle.params, bundle.model_state, device=dev,
        image_shape=bundle.image_shape, max_bucket=64)
    images = make_images(bundle.image_shape, seed=123, n=64)
    served = engine.predict(images)
    quant_mod.quant_matmul = quant_matmul_reference
    try:
        plain = engine.predict(images)
    finally:
        quant_mod.quant_matmul = quant_matmul
    diff = float(np.max(np.abs(served - plain)))
    agree = float(np.mean(served.argmax(-1) == plain.argmax(-1)))
    print(json.dumps({"phase": "served_logits", "shape": list(served.shape),
                      "max_abs_diff_vs_plain": diff, "top1_agreement": agree,
                      "max_abs_logit": float(np.max(np.abs(plain)))}),
          flush=True)
    if served.shape != (64, 10) or not np.isfinite(served).all():
        fail(f"served logits: shape {served.shape} or non-finite values")
    if diff > 0.04 or agree < 0.98:
        fail(f"served logits vs plain path: max abs {diff}, top-1 {agree}")

    # where one served batch of 64 spends its time: host clock per predict
    # (ends on the logits' .cpu()), then device time by kernel name from
    # torch.profiler over the same predicts
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(images)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.predict(images)
    device_ms = {}  # by kernel name, cut to 100 characters
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernel = evt.name[:100]
            device_ms[kernel] = (device_ms.get(kernel, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3 / reps)
    busy_ms = sum(device_ms.values()) if device_ms else None
    print(json.dumps({
        "phase": "profile", "batch": 64, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "device_ms_by_kernel": dict(sorted(device_ms.items(),
                                           key=lambda kv: -kv[1]))}),
          flush=True)

    # -- 5. timing at the path's shapes --------------------------------------
    timed = {}
    for (label, m), (x, qa) in operands.items():
        w_deq = quant_mod.dequantize(qa, x.dtype)  # the library's operand
        row = {"kernel_ms": graph_ms(torch, lambda: quant_matmul(
                   x, qa.q, qa.scale)),
               "plain_ms": graph_ms(torch, lambda: quant_matmul_reference(
                   x, qa.q, qa.scale)),
               "library_ms": graph_ms(torch, lambda: torch.matmul(x, w_deq))}
        cost = quant_matmul_cost(tuple(x.shape), tuple(qa.shape), x.dtype)
        t_bytes = cost["hbm_bytes"] / bw * 1e3
        peak = peaks[str(x.dtype).removeprefix("torch.")]
        t_ops = cost["flops"] / peak * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        timed[(label, m)] = row
        print(json.dumps({"phase": "time", "shape": label, "m": m,
                          "dtype": str(x.dtype), **row}), flush=True)

    # -- 6. result -----------------------------------------------------------
    head = timed[("lenet5/fc1", 64)]
    print(json.dumps({"kernels": [{
        "name": "quant_matmul",
        "route": "cuda",
        "source": "dist_mnist_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "dist_mnist_tpu/ops/pallas/quant_matmul.py:50",
        "launches": launches,
        "max_abs_err": worst["abs"],
        "max_rel_err": worst["rel"],
        "shape": "lenet5/fc1 [64,3136]x[3136,512] bf16",
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }], "gpu": gpu}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
