"""Learning-rate schedules (port of the reference `optim/schedules.py`):
callables of the int32 update count, returning an f32 tensor on its
device. Divisions by a constant divide by a tensor, as the reference's
traced division does (torch's CUDA division by a Python number is a
multiply by its reciprocal)."""

from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=count.device)


def cosine_decay(peak: float, total_steps: int, warmup_steps: int = 0,
                 floor: float = 0.0):
    def schedule(count):
        t = count.to(torch.float32)
        warm = peak * t / torch.full_like(t, max(1.0, warmup_steps))
        prog = torch.clamp(
            (t - warmup_steps)
            / torch.full_like(t, max(1.0, total_steps - warmup_steps)),
            0, 1)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(t < warmup_steps, warm, cos)

    return schedule


def step_decay(base: float, boundaries: tuple[int, ...], factor: float = 0.1):
    def schedule(count):
        t = count.to(torch.float32)
        n_passed = sum((t >= b).to(torch.float32) for b in boundaries)
        return base * factor ** n_passed

    return schedule
