"""SGD and heavy-ball momentum (port of the reference `optim/sgd.py`)."""

from __future__ import annotations

from typing import Callable

import torch

from dist_mnist_tpu_torch.optim.base import Optimizer, tree_device
from dist_mnist_tpu_torch.utils.tree import tree_map


def _lr_at(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_device(params))


def sgd(learning_rate: float | Callable = 0.01) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, count)
        return (tree_map(lambda g: -lr * g.to(torch.float32), grads),
                {"count": count})

    return Optimizer(init, update)


def momentum(
    learning_rate: float | Callable = 0.01,
    decay: float = 0.9,
    nesterov: bool = False,
) -> Optimizer:
    def init(params):
        return {
            "velocity": tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "count": _count(params),
        }

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, count)
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        vel = tree_map(lambda v, g: decay * v + g, state["velocity"], g32)
        if nesterov:
            updates = tree_map(lambda v, g: -lr * (decay * v + g), vel, g32)
        else:
            updates = tree_map(lambda v: -lr * v, vel)
        return updates, {"velocity": vel, "count": count}

    return Optimizer(init, update)
