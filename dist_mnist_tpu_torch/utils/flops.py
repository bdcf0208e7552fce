"""FLOPs accounting: model FLOPs per step ÷ time ÷ the card's peak = MFU
(port of the reference `utils/flops.py`).

The numerator is analytic: batch × (1 + 2) × the model's published
forward count (`flops_per_example`), backward taken as twice the forward.
The peaks are NVIDIA's data-sheet figures for dense bf16 on the tensor
cores, keyed by `torch.cuda.get_device_name`. A card not in the table, or
the CPU, has no peak: MFU is then reported as None, never guessed.
"""

from __future__ import annotations

import torch

# dense bf16 tensor-core peak (FLOP/s) per card
PEAK_BF16_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # SXM
    "NVIDIA H100 PCIe": 756e12,
}


def device_kind(device: torch.device | str | None = None) -> str:
    """The card's name, or "cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def device_peak_flops(device=None) -> float | None:
    return PEAK_BF16_FLOPS.get(device_kind(device))


def analytic_step_flops(model, sample_shape, batch: int,
                        bwd_multiplier: float = 2.0) -> float | None:
    """batch × (1 + bwd_multiplier) × forward FLOPs per example; None when
    the model publishes no count."""
    fwd = getattr(model, "flops_per_example", None)
    if fwd is None:
        return None
    return batch * (1.0 + bwd_multiplier) * fwd(sample_shape)


def mfu(flops_per_step: float | None, step_secs: float,
        device=None) -> float | None:
    """Model-FLOPs utilization in [0, 1]; None when either side is unknown."""
    peak = device_peak_flops(device)
    if not flops_per_step or not peak or step_secs <= 0:
        return None
    return flops_per_step / step_secs / peak
