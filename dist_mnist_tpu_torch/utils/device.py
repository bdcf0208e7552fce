"""Device selection for the port's entry points.

The port is written for an NVIDIA GPU: every entry point runs on `cuda`
unless its caller asks for `cpu` by name (the CPU tests do). With no CUDA
device and no such request it raises instead of quietly carrying on on
the CPU, so a run that claims the GPU path never measured the CPU one.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """`None`/"cuda"/"cuda:N" -> that CUDA device (raises without CUDA);
    "cpu" -> the CPU."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(supported: cuda, cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on an NVIDIA GPU; pass "
            "device='cpu' (--device=cpu) to run the plain CPU path")
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"{device} requested but only {torch.cuda.device_count()} CUDA "
            "device(s) are visible")
    return device
