#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention and `quant_matmul` kernels of
several checkouts on one card, in turns. Needs one NVIDIA GPU and `nvcc`,
as `chip_smoke.py` does.

    python3 scripts/torch_flash_ab.py [--f32] [--qmm] [--adam] [--decode] [--vit] TREE [TREE ...]

Each TREE is the root of a checkout of this repository: this one, and an
older commit unpacked beside it with `git archive`. The trees run in the
order given, then in reverse: two trees run A, B, B, A. Each run is a
fresh interpreter whose working directory is the tree: it builds and
imports that tree's kernels and its `chip_smoke.py`.
It times, at ViT-Tiny's attention call (B=64, S=65, H=3, D=64; q, k, v the
strided views of one fused projection), the forward, dQ, dK/dV and the two
together in bf16 and in f32, and in both the masked backward with lengths
2..65 (on contiguous copies); with `--f32`, only the f32 figures. With
`--qmm`, it also times `quant_matmul` at the MLP's f32 layers
([M,784]x[784,100] and [M,100]x[100,10], M in {1, 64}) and LeNet-5's
bf16 fc1 and fc2 at M = 64, and beside each f32 row `torch.matmul` on the
dequantized weight (the library call, the same in every tree). With
`--adam`, it also times both fused-Adam kernels through its tree's
`chip_smoke.time_adam`: one update of LeNet-5's 8 leaves as the tree's
optimizers make it (one launch per leaf before the leaf table, one
launch after) and of fc1/w alone, each on operands cold in L2. With
`--decode`, it also times both decode kernels through its tree's
`chip_smoke.time_decode_kernels`: `paged_attention` at one decode step
(9 rows, 8 heads of 16, pages of 32, table widths 2 and 128) and the
masked forward at Sq = 1 against Sk = 4096, and in trees that have them
the rows at every length 4096, the masked forward at Sq > 1 and each
row's launch floor. Each figure is the tree's
`chip_smoke.graph_ms`: a CUDA graph of 100 back-to-back calls replayed
under CUDA events, median of 5 replays, in ms per call. With `--vit`,
each run then also trains `vit_tiny_cifar_flash` 20 steps from its tree's
`chip_smoke.vit_state` (seed-0 state, batch 64) and records the last
loss and a 48-bit hash of the 20 losses' bits (equal hashes: the same
bits), then calls its tree's `chip_smoke.vit_profile` (one training
step: host wall, and device time by kernel from `torch.profiler`) and
records the step's device busy ms, its idle share and the ms of each
flash kernel in it. Prints the card's name and power limit, one JSON line
per run, and last a JSON line with each tree's median per figure over its
runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# run in a fresh interpreter whose working directory is the tree under test
RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from dist_mnist_tpu_torch.ops.kernels import build
from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention_backward, masked_flash_attention_forward)

torch.backends.cuda.matmul.allow_tf32 = False
build.build_all(["flash_attention", "masked_flash_attention"]
                + (["quant_matmul"] if "--qmm" in sys.argv else [])
                + (["fused_adam"] if "--adam" in sys.argv else [])
                + (["paged_attention"] if "--decode" in sys.argv else []))

B, S, H, D = 64, 65, 3, 64
rows = {}
routes = [("f32", torch.float32)]
if "--f32" not in sys.argv:
    routes.insert(0, ("bf16", torch.bfloat16))
for name, dtype in routes:
    gen = torch.Generator().manual_seed(80)
    q, k, v = torch.randn(B, S, 3, H, D, generator=gen).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(B, S, H, D, generator=torch.Generator().manual_seed(
        81)).to("cuda", dtype)
    out, lse = fa.flash_attention_forward(q, k, v)
    delta = fa.attention_delta(out, do)
    rows[name + "_forward"] = chip_smoke.graph_ms(
        torch, lambda: fa.flash_attention_forward(q, k, v))
    rows[name + "_dq"] = chip_smoke.graph_ms(
        torch, lambda: fa.flash_attention_dq(q, k, v, do, lse, delta))
    rows[name + "_dkv"] = chip_smoke.graph_ms(
        torch, lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta))
    rows[name + "_backward"] = chip_smoke.graph_ms(torch, lambda: (
        fa.flash_attention_dq(q, k, v, do, lse, delta),
        fa.flash_attention_dkv(q, k, v, do, lse, delta)))
    lens = torch.arange(2, B + 2, dtype=torch.int32, device="cuda")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    m_out, m_lse = masked_flash_attention_forward(qc, kc, vc, lens)
    m_delta = fa.attention_delta(m_out, do)
    rows[name + "_masked_backward"] = chip_smoke.graph_ms(
        torch, lambda: masked_flash_attention_backward(
            qc, kc, vc, lens, do, m_lse, m_delta))
if "--qmm" in sys.argv:
    from dist_mnist_tpu_torch.ops import quant
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(0)
    for label, d, h, dtype, ms in (
            ("mlp_hid", 784, 100, torch.float32, (1, 64)),
            ("mlp_sm", 100, 10, torch.float32, (1, 64)),
            ("fc1", 3136, 512, torch.bfloat16, (64,)),
            ("fc2", 512, 10, torch.bfloat16, (64,))):
        qa = quant.quantize((torch.randn(d, h, generator=gen)
                             / d ** 0.5).to("cuda"))
        w_deq = quant.dequantize(qa, dtype)
        for m in ms:
            x = torch.rand(m, d, generator=gen).to("cuda", dtype)
            key = f"qmm_{label}_m{m}_{str(dtype).removeprefix('torch.')}"
            rows[key] = chip_smoke.graph_ms(
                torch, lambda: quant_matmul(x, qa.q, qa.scale))
            if dtype == torch.float32:
                rows[key + "_library"] = chip_smoke.graph_ms(
                    torch, lambda: torch.matmul(x, w_deq))
if "--adam" in sys.argv:
    import numpy as np

    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state

    state = create_train_state(get_model("lenet5"), optim.adam(
        1e-3, fused=True), 0, np.zeros((1, 28, 28, 1), np.uint8), "cuda")
    for (name, label), row in chip_smoke.time_adam(
            torch, torch.device("cuda", 0), state, 3.35e12, 67e12).items():
        for key in ("kernel_ms", "kernel_ms_l2_warm"):
            rows[f"adam {name} {label} {key}"] = row[key]
if "--decode" in sys.argv:
    for key, row in chip_smoke.time_decode_kernels(
            torch, torch.device("cuda", 0), 3.35e12, 67e12).items():
        label = "decode " + " ".join(str(part) for part in key)
        rows[label] = row["kernel_ms"]
        if "launch_floor_ms" in row:
            rows[label + " launch_floor"] = row["launch_floor_ms"]
if "--vit" in sys.argv:
    import hashlib
    import re

    from dist_mnist_tpu_torch.data.datasets import load_dataset

    cifar = load_dataset("cifar10", seed=42)
    state, step, _, _ = chip_smoke.vit_state(torch, torch.device("cuda", 0),
                                             cifar, "flash")
    losses = []
    for _ in range(20):
        state, out = step(state)
        losses.append(out["loss"])
    losses = torch.stack(losses).float().cpu().numpy()
    rows["vit_20_steps_final_loss"] = float(losses[-1])
    rows["vit_20_steps_loss_bits"] = int(hashlib.sha256(
        losses.tobytes()).hexdigest()[:12], 16)
    prof = chip_smoke.vit_profile(torch, torch.device("cuda", 0), cifar)
    rows["vit_step_wall_ms"] = prof["wall_ms"]
    rows["vit_step_device_busy_ms"] = prof["device_busy_ms"]
    rows["vit_step_device_idle_share"] = prof["device_idle_share"]
    for kernel, ms in prof["device_ms_by_kernel"].items():
        name = re.search(r"flash_\w+", kernel)
        if name:  # e.g. "void (anonymous namespace)::flash_dq_mma<64, true>(..."
            key = "vit_step_ms " + name.group(0)
            rows[key] = rows.get(key, 0.0) + ms
print(json.dumps(rows))
"""


def run_tree(tree: Path, flags: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, *flags], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc={proc.returncode}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--vit", action="store_true",
                        help="also profile one ViT-Tiny training step")
    parser.add_argument("--f32", action="store_true",
                        help="time the f32 flash kernels only")
    parser.add_argument("--qmm", action="store_true",
                        help="also time quant_matmul (MLP f32, LeNet-5 bf16)")
    parser.add_argument("--adam", action="store_true",
                        help="also time the fused-Adam kernels (LeNet-5)")
    parser.add_argument("--decode", action="store_true",
                        help="also time both decode kernels")
    args = parser.parse_args()
    flags = [f"--{name}" for name in ("vit", "f32", "qmm", "adam", "decode")
             if getattr(args, name)]
    trees = [t.resolve() for t in args.trees]
    for tree in trees:
        if not (tree / "dist_mnist_tpu_torch").is_dir():
            print(f"{tree} holds no dist_mnist_tpu_torch", file=sys.stderr)
            return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs: dict[str, list[dict]] = {str(t): [] for t in trees}
    for tree in trees + trees[::-1]:
        rows = run_tree(tree, flags)
        runs[str(tree)].append(rows)
        print(json.dumps({"tree": str(tree), **rows}), flush=True)
    print(json.dumps({"median_ms": {
        tree: {key: statistics.median(run.get(key, float("nan"))
                                      for run in rs)
               for key in rs[0]} for tree, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
