#!/usr/bin/env python3
"""`bench --serve --autoscale` on the CPU beside busy processes: how the
autoscaler's latency-sensitive p99 and `chip_seconds_per_1k_ok` hold up
on a loaded host (the load the whole test suite puts on the bench).

    python3 scripts/torch_autoscale_load.py [--hogs=5] [--runs=2]
        [--omp=N]

Starts `--hogs` processes that multiply 1024 x 1024 matrices on every
core for as long as the runs last, then runs the bench `--runs` times,
each in a fresh process (with ``OMP_NUM_THREADS=N`` when `--omp` is
given), prints one JSON line a run (the bench's error or its LS p99s
and value) and stops the hogs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HOG = """
import torch
a = torch.randn(1024, 1024)
while True:
    a @ a
"""


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hogs", type=int, default=5)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--omp", type=int, default=None,
                   help="OMP_NUM_THREADS for the bench's process")
    args = p.parse_args(argv)
    hogs = [subprocess.Popen([sys.executable, "-c", HOG],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
            for _ in range(args.hogs)]
    env = dict(os.environ)
    if args.omp is not None:
        env["OMP_NUM_THREADS"] = str(args.omp)
    try:
        for run in range(args.runs):
            out = subprocess.run(
                [sys.executable, "-m", "dist_mnist_tpu_torch.bench",
                 "--serve", "--autoscale", "--device=cpu"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            rec = json.loads(out.stdout.strip().splitlines()[0])
            extra = rec.get("extra", {})
            print(json.dumps({
                "run": run, "hogs": args.hogs, "omp": args.omp,
                "error": rec.get("error"),
                "ls_p99_ms": extra.get("ls_p99_ms"),
                "chip_seconds_per_1k_ok": rec["value"],
                "static_chip_seconds_per_1k_ok": extra.get(
                    "static_chip_seconds_per_1k_ok")}), flush=True)
    finally:
        for h in hogs:
            h.kill()
            h.wait()


if __name__ == "__main__":
    main()
