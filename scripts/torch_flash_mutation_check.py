#!/usr/bin/env python3
"""Show that `chip_smoke.py`'s checks of the PyTorch port's redesigned
kernels fail when those kernels are wrong. Needs one NVIDIA GPU and
`nvcc`, as `chip_smoke.py` does.

    python3 scripts/torch_flash_mutation_check.py [MUTANT ...]

Runs the phases `vit_kernel_vs_plain`, `flash_split_share`, `qmm_parity`,
`flash_parity`, `decode_kernel_parity`, `masked_vit_path_parity`,
`masked_zoo_path_parity` and `masked_share` on the checkout as it stands, then on copies of the
checkout in a temporary directory, each with one fault planted in a
kernel under `dist_mnist_tpu_torch/csrc/`, and runs
there the phase that must catch it. In the bf16 tensor-core flash backward that the ViT path
runs (`flash_attention.cu`):

- `dk_zero` (`vit_kernel_vs_plain`): `flash_dkv_mma` writes dK as zero;
- `delta_dropped` (`vit_kernel_vs_plain`): `flash_dkv_mma` forms dS as
  ``p * dP``, without ``- delta``;
- `lo_dropped` (`flash_split_share`): the three products with an f32
  operand (dS K, dS^T Q, P^T dO) skip the operand's lo half, as if P and
  dS were rounded to bf16 once; within the 1e-2 limits, so only the
  share of outputs equal to the plain version's bf16 values sees it.

In the f32 kernels:

- `qmm_split_dropped` (`qmm_parity`): the last block of the f32
  `quant_matmul` (`quant_matmul.cu`) sums every split's partial but the
  second's;
- `f32_last_tile_skipped` (`flash_parity`): the f32 flash forward
  (`flash_fwd_f32`) skips its last key tile, which at S <= 128 is every
  key;
- `f32_delta_dropped` (`flash_parity`): the f32 dQ kernel
  (`flash_dq_f32`) forms dS as ``p * dP``, without ``- delta``.

In the decode kernels:

- `paged_rescale_dropped` (`decode_kernel_parity`): `paged_attn_kernel`
  (`paged_attention.cu`) does not rescale its running p @ V by alpha when
  a later slice raises the running max, which a table of two or more
  pages reaches;
- `masked_decode_len_off_by_one` (`decode_kernel_parity`): the Sq = 1
  kernel of `masked_flash_attention.cu` admits key ``len``, one past the
  row's length.

In the masked forward at Sq > 1 (the flash forward kernels with lengths):

- `fwd_len_off_by_one` (`decode_kernel_parity`, whose `masked_parity`
  holds the Sq > 1 route): the forward kernels' mask (`key_live` in
  `flash_attention.cu`, which the bf16 one-pass and tiled kernels and the
  f32 kernel share) scores key ``len``, one past the row's length;
- `fwd_len_off_by_one_vit_path` (`masked_vit_path_parity`): the same
  fault, which the Sq > 1 cases at `vit_masked_forward`'s own shape and
  lengths (S = 33, lengths 25 and 33) must catch alone;
- `fwd_len_off_by_one_zoo_path` (`masked_zoo_path_parity`): the same
  fault, which the cases at the zoo grid's masked cells must catch alone;
  they run smallest first, so the first failing line is S = 9's (keys
  padded to 32, every row full: key 9 is the first padded one);
- `masked_normalized_rule` (`masked_share`): the masked one-pass bf16
  kernel (Sk <= 128) runs its normalized instantiation, p / l rounded to
  bf16 before p @ V, instead of the reference's streamed rule. It stays
  within the 1e-2 limits of `masked_parity`; only the share of outputs
  equal to the plain version's bf16 values (`MASKED_MATCH_MIN`) sees it.

Named mutants run alone (with the checkout's run of their phases only).
Each mutant's copy starts from the checkout's built kernels, so only its
mutated source is compiled again. Each run prints its phases' JSON lines. Exits 0 only when the checkout
passes every phase and every mutant fails its own. The checkout itself
is never modified.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FLASH = Path("dist_mnist_tpu_torch/csrc/flash_attention.cu")
QMM = Path("dist_mnist_tpu_torch/csrc/quant_matmul.cu")
PAGED = Path("dist_mnist_tpu_torch/csrc/paged_attention.cu")
MASKED = Path("dist_mnist_tpu_torch/csrc/masked_flash_attention.cu")
BUILT = Path("build/torch_kernels")
MUTANTS = {  # name: (source, line, its mutation, the phase that must catch it)
    "dk_zero": (FLASH,
                "store_bf16_rows<DP>(acc_k, dkh, wkey0, Sk, H, D, scale);",
                "store_bf16_rows<DP>(acc_k, dkh, wkey0, Sk, H, D, 0.f);",
                "vit_kernel_vs_plain"),
    "delta_dropped": (FLASH, "ds = p * (dp[nt][i] - delta_s[col]);",
                      "ds = p * dp[nt][i];", "vit_kernel_vs_plain"),
    "lo_dropped": (FLASH, """                tc::mma_bf16(o[2 * dt], lo, mb[0], mb[1]);
                tc::mma_bf16(o[2 * dt + 1], lo, mb[2], mb[3]);
""", "", "flash_split_share"),
    "qmm_split_dropped": (
        QMM, "if (p0 + r < splits) {  // in split order",
        "if (p0 + r < splits && p0 + r != 1) {  // in split order",
        "qmm_parity"),
    "f32_last_tile_skipped": (
        FLASH, "for (int kt = 0; kt < tiles; ++kt) {  // the main pass",
        "for (int kt = 0; kt < tiles - 1; ++kt) {  // the main pass",
        "flash_parity"),
    "f32_delta_dropped": (FLASH, "ds = p * (dp[i][j] - delta_s[r]);",
                          "ds = p * dp[i][j];", "flash_parity"),
    "paged_rescale_dropped": (PAGED, "cur.vs), acc[e] * alpha);",
                              "cur.vs), acc[e]);", "decode_kernel_parity"),
    "masked_decode_len_off_by_one": (
        MASKED, "auto admitted = [&](int key) { return key < len; };",
        "auto admitted = [&](int key) { return key <= len; };",
        "decode_kernel_parity"),
    "fwd_len_off_by_one": (FLASH, "return key < len;", "return key <= len;",
                           "decode_kernel_parity"),
    "fwd_len_off_by_one_vit_path": (
        FLASH, "return key < len;", "return key <= len;",
        "masked_vit_path_parity"),
    "fwd_len_off_by_one_zoo_path": (
        FLASH, "return key < len;", "return key <= len;",
        "masked_zoo_path_parity"),
    "masked_normalized_rule": (
        FLASH, "auto kernel = normalized ? flash_fwd_mma_onepass<DP, VEC, true>",
        "auto kernel = (normalized || lens != nullptr)\n"
        "                ? flash_fwd_mma_onepass<DP, VEC, true>",
        "masked_share"),
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
build.build_all(["flash_attention", "masked_flash_attention",
                 "quant_matmul", "paged_attention"])
dev = torch.device("cuda", 0)
for phase in sys.argv[1:]:
    if phase == "vit_kernel_vs_plain":
        chip_smoke.vit_kernel_vs_plain(torch, dev,
                                       load_dataset("cifar10", seed=42))
    else:
        getattr(chip_smoke, phase)(torch, dev)
"""


def run_phases(tree: Path, *phases: str) -> bool:
    """True when every phase passes on `tree`."""
    proc = subprocess.run([sys.executable, "-c", PHASE, *phases], cwd=tree,
                          timeout=600)
    return proc.returncode == 0


def main(argv: list[str]) -> int:
    unknown = sorted(set(argv) - set(MUTANTS))
    if unknown:
        print(f"unknown mutants {unknown}; have {sorted(MUTANTS)}",
              file=sys.stderr)
        return 2
    mutants = {name: MUTANTS[name] for name in argv} if argv else MUTANTS
    sources = {kernel for kernel, *_ in mutants.values()}
    if not all((ROOT / p).is_file() for p in (*sources, "chip_smoke.py")):
        print(f"a kernel source or chip_smoke.py is missing under {ROOT}",
              file=sys.stderr)
        return 2
    verdicts = {"checkout": run_phases(ROOT, *sorted(
        {phase for *_, phase in mutants.values()}))}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (kernel, old, new, phase) in mutants.items():
            src = (ROOT / kernel).read_text()
            if src.count(old) != 1:
                print(f"{name}: the line to mutate is not in {kernel} once",
                      file=sys.stderr)
                return 2
            tree = Path(tmp) / name
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "build", "chiprun_out", "__pycache__"))
            if (ROOT / BUILT).is_dir():  # by content hash: reused if unchanged
                shutil.copytree(ROOT / BUILT, tree / BUILT)
            (tree / kernel).write_text(src.replace(old, new))
            print(f"== mutant {name} ({phase})", flush=True)
            verdicts[name] = run_phases(tree, phase)
    ok = verdicts["checkout"] and not any(
        verdicts[name] for name in mutants)
    print({"verdicts": {k: "pass" if v else "fail"
                        for k, v in verdicts.items()}, "ok": ok}, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
