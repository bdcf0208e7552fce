"""Serving entry point: build a servable model, start the inference server,
drive it with the deterministic load generator, print a latency/batching
summary as JSON (port of the reference `cli/serve.py`, default mode).

    python -m dist_mnist_tpu_torch.cli.serve --config=lenet5_mnist \\
        --quant=int8 --max_batch 64 --requests 512 --concurrency 64

Runs on the CUDA device by default and exits with an error when there is
none; `--device=cpu` runs the plain CPU path. Weights are a fresh init
seeded from the config (checkpoint restore joins with the checkpoint
port).
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    ServeConfig,
    load_for_serving,
    run_loadgen,
)
from dist_mnist_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.cli.serve",
        description="Serve a classifier config and drive it with the "
                    "closed-loop load generator.")
    p.add_argument("--config", default="mlp_mnist",
                   help="config name (see configs.py)")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only int8 serving: dense/conv kernels become "
                        "(int8, f32 per-channel scale) at load time and "
                        "every quantized dense layer runs the quant_matmul "
                        "CUDA kernel; unset = full-width float serving")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--max_batch", type=int, default=64,
                   help="coalesce ceiling (requests per batch)")
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="coalesce window after the first request")
    p.add_argument("--queue_depth", type=int, default=256,
                   help="admission queue bound")
    p.add_argument("--deadline_ms", type=float, default=0,
                   help="per-request deadline; 0 = none")
    p.add_argument("--prewarm", action=argparse.BooleanOptionalAction,
                   default=True, help="run every bucket once before serving")
    p.add_argument("--requests", type=int, default=512,
                   help="loadgen request count")
    p.add_argument("--concurrency", type=int, default=64,
                   help="loadgen in-flight window")
    p.add_argument("--seed", type=int, default=0, help="loadgen input seed")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    cfg = get_config(args.config)
    bundle = load_for_serving(cfg, device, quant=args.quant)
    engine = InferenceEngine(
        bundle.model, bundle.params, bundle.model_state, device=device,
        image_shape=bundle.image_shape,
        max_bucket=max(args.max_batch, 1), quant=bundle.quant,
        quant_report=bundle.quant_report)
    server = InferenceServer(engine, ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        default_deadline_ms=args.deadline_ms or None,
        prewarm=args.prewarm,
    ))
    with server:
        summary = run_loadgen(
            server,
            n_requests=args.requests,
            concurrency=args.concurrency,
            image_shape=bundle.image_shape,
            seed=args.seed,
        )
    summary["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    summary["checkpoint_step"] = bundle.step
    summary["restored"] = bundle.restored
    summary["serve_state_bytes_per_device"] = engine.state_bytes_per_device()
    if bundle.quant:
        summary["quant"] = bundle.quant
        summary["quant_error_max"] = bundle.quant_report["max_abs_err"]
        summary["quant_rel_err_max"] = bundle.quant_report["max_rel_err"]
        summary["quant_leaves"] = bundle.quant_report["n_quantized"]
    print(json.dumps(summary, indent=2, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
