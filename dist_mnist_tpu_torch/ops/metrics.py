"""Metrics computed on the device (port of the reference `ops/metrics.py`);
each returns a device scalar, fetched by the caller when it needs it."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def correct_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.argmax(logits, -1) == labels, dtype=torch.int32)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 5) -> torch.Tensor:
    _, idx = torch.topk(logits, k)
    hit = torch.any(idx == labels[:, None], dim=-1)
    return torch.mean(hit.to(torch.float32))
