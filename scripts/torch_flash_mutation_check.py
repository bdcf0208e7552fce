#!/usr/bin/env python3
"""Show that `chip_smoke.py`'s `vit_kernel_vs_plain` phase fails when the
PyTorch port's flash backward kernel is wrong. Needs one NVIDIA GPU and
`nvcc`, as `chip_smoke.py` does.

    python3 scripts/torch_flash_mutation_check.py

Runs the phase on the checkout as it stands, then on copies of the
checkout in a temporary directory, each with one fault planted in
`dist_mnist_tpu_torch/csrc/flash_attention.cu`:

- `dk_zero`: the dK/dV kernel writes dK as zero;
- `delta_dropped`: the dK/dV kernel forms dS as ``p * dP``, without
  ``- delta``.

Each run prints the phase's JSON line. Exits 0 only when the checkout
passes the phase and every mutant fails it. The checkout itself is never
modified.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("dist_mnist_tpu_torch/csrc/flash_attention.cu")
MUTANTS = {
    "dk_zero": ("store(dk + at + d, acc_k[r][i] * scale);",
                "store(dk + at + d, 0.f);"),
    "delta_dropped": ("ds[r] = p[r] * (dp[r] - delta_s[lane]);",
                      "ds[r] = p[r] * dp[r];"),
}
# run in a fresh interpreter whose working directory is the tree under test
PHASE = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from dist_mnist_tpu_torch.data.datasets import load_dataset
from dist_mnist_tpu_torch.ops.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all(["flash_attention"])
chip_smoke.vit_kernel_vs_plain(torch, torch.device("cuda", 0),
                               load_dataset("cifar10", seed=42))
"""


def run_phase(tree: Path) -> bool:
    """True when the phase passes on `tree`."""
    proc = subprocess.run([sys.executable, "-c", PHASE], cwd=tree,
                          timeout=600)
    return proc.returncode == 0


def main() -> int:
    if not (ROOT / KERNEL).is_file() or not (ROOT / "chip_smoke.py").is_file():
        print(f"no {KERNEL} or chip_smoke.py under {ROOT}", file=sys.stderr)
        return 2
    verdicts = {"checkout": run_phase(ROOT)}
    src = (ROOT / KERNEL).read_text()
    with tempfile.TemporaryDirectory() as tmp:
        for name, (old, new) in MUTANTS.items():
            if src.count(old) != 1:
                print(f"{name}: the line to mutate is not in {KERNEL} once",
                      file=sys.stderr)
                return 2
            tree = Path(tmp) / name
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "build", "chiprun_out", "__pycache__"))
            (tree / KERNEL).write_text(src.replace(old, new))
            print(f"== mutant {name}", flush=True)
            verdicts[name] = run_phase(tree)
    ok = verdicts["checkout"] and not any(
        verdicts[name] for name in MUTANTS)
    print({"verdicts": {k: "pass" if v else "fail"
                        for k, v in verdicts.items()}, "ok": ok}, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
