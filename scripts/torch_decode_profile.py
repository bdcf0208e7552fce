#!/usr/bin/env python3
"""Where one warp of the PyTorch port's paged decode kernel spends its
cycles. Needs one NVIDIA GPU and `nvcc`, as `chip_smoke.py` does.

    python3 scripts/torch_decode_profile.py

`torch.profiler` sees a decode kernel as one span of a few microseconds,
so this script looks inside it. It copies `csrc/paged_attention.cu` and
`csrc/decode_attention.cuh` into a temporary directory, plants `clock64`
stamps in `paged_attn_kernel` at its phase boundaries, builds the copy
with the port's nvcc flags and runs it through the port's wrapper at
`chip_smoke.py`'s decode shapes: one decode step (`DEC_LENGTHS`, table
width 2) and every length 4096 (width 128). Each stamp waits for the
value its phase produced, so a phase is the cycles from the previous
stamp until that value is ready:

- `ids`: from the first instruction until the row's length, its first
  page ids and q have arrived (the first memory round trip);
- `rows`: until the first two slices' K/V rows and scales have arrived;
- `loop`: the slices' arithmetic (and the waits on later rows);
- `finish`: merging the lanes' softmax states and storing the output.

Prints the card's name and power limit, then per shape one JSON line with
each phase's mean and largest cycles over the warps, the SM clock, and
the instrumented and the checkout's kernel's ms (`chip_smoke.graph_ms`)
beside the empty kernel's (`paged_attention_launch_floor`). The checkout
is never modified.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "dist_mnist_tpu_torch" / "csrc"
PHASES = ("ids", "rows", "loop", "finish")

# (anchor in paged_attention.cu, text inserted after it)
STAMPS = (
    ("namespace {\n", """
__device__ long long g_phase_cycles[65536 * 4];
__device__ __forceinline__ long long stamp(int ready) {
    int d;
    asm volatile("mov.u32 %0, %1;" : "=r"(d) : "r"(ready));  // waits for `ready`
    long long c;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
    return c + (d & 0);
}
"""),
    ("    constexpr int SLICE = 32 / G;  // tokens a warp takes at a time\n",
     "    const long long t0 = stamp(0);\n"),
    ("    const int L = min(len, span);\n",
     "    const long long t1 = stamp(len + w0.page + __float_as_int(qf[0]));\n"),
    ("    Token next = load(1, w1, L);\n",
     "    const long long t2 = stamp(cur.k.w[0] + next.k.w[0]"
     " + __float_as_int(cur.ks + next.vs));\n"),
)
FINISH = "    decode::finish<G>(m, l, acc, out + rh * D + d0, dn, lane);\n"
FINISH_STAMPED = """    const long long t3 = stamp(__float_as_int(acc[0]) + __float_as_int(l));
    const float2 m_l = decode::finish<G>(m, l, acc, out + rh * D + d0, dn, lane);
    const long long t4 = stamp(__float_as_int(m_l.y) + __float_as_int(acc[0]));
    if (lane == 0 && rh < 65536) {
        long long* g = g_phase_cycles + rh * 4;
        g[0] = t1 - t0;
        g[1] = t2 - t1;
        g[2] = t3 - t2;
        g[3] = t4 - t3;
    }
"""
READ = """
extern "C" int dmt_read_phase_cycles(void* host, int count) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(long long) * count));
}
"""


def instrumented_source() -> str:
    src = (CSRC / "paged_attention.cu").read_text()
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not in paged_attention.cu once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    if src.count(FINISH) != 1:
        raise SystemExit("the finish call is not in paged_attention.cu once")
    return src.replace(FINISH, FINISH_STAMPED) + READ


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels import build
    from dist_mnist_tpu_torch.ops.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "decode_attention.cuh").write_text(
            (CSRC / "decode_attention.cuh").read_text())
        src = Path(tmp) / "paged_attention.cu"
        src.write_text(instrumented_source())
        lib_path = Path(tmp) / "libpaged_profile.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(lib_path), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(lib_path))
    stamped = lib.dmt_paged_attention
    stamped.argtypes, stamped.restype = pa._ARGTYPES, ctypes.c_int
    checkout_entry = pa._entry
    for label, n, lengths in (
            ("decode step", 2, chip_smoke.DEC_LENGTHS),
            ("every length 4096", 128,
             [chip_smoke.DEC_SEQ] * chip_smoke.DEC_ROWS)):
        ops = chip_smoke._paged_operands(torch, quant_mod, dev, n, lengths,
                                         seed=99)
        pa._entry = checkout_entry
        checkout_ms = chip_smoke.graph_ms(
            torch, lambda: pa.paged_attention(*ops))
        floor_ms = chip_smoke.graph_ms(
            torch, lambda: pa.paged_attention_launch_floor(*ops))
        pa._entry = lambda name="dmt_paged_attention": stamped
        stamped_ms = chip_smoke.graph_ms(
            torch, lambda: pa.paged_attention(*ops))
        torch.cuda.synchronize()
        warps = chip_smoke.DEC_ROWS * chip_smoke.DEC_HEADS
        buf = (ctypes.c_longlong * (4 * warps))()
        if lib.dmt_read_phase_cycles(buf, 4 * warps) != 0:
            print("reading the stamps failed", file=sys.stderr)
            return 1
        cycles = np.array(buf, dtype=np.float64).reshape(warps, 4)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(json.dumps({
            "shape": label, "n_pages": n, "lengths": lengths,
            "mean_cycles": dict(zip(PHASES, cycles.mean(0).tolist())),
            "max_cycles": dict(zip(PHASES, cycles.max(0).tolist())),
            "mean_total_cycles": float(cycles.sum(1).mean()),
            "sm_clock": clocks, "kernel_ms": checkout_ms,
            "stamped_kernel_ms": stamped_ms, "launch_floor_ms": floor_ms}),
              flush=True)
    pa._entry = checkout_entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
