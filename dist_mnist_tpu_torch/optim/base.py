"""Gradient-transformation core (port of the reference `optim/base.py`).

An `Optimizer` is a pair of functions over nested-dict trees of tensors:
``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``, where `updates`
are deltas (`params + updates` applies them). Nothing is updated in
place: every update returns new tensors, as the reference's pure
functions return new arrays. Scalars that depend on the step (the clip
factor, the bias-corrected rate) stay device tensors, so an update never
waits on the device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple

import torch

from dist_mnist_tpu_torch.utils.tree import leaves, tree_map

Params = Any
Grads = Any
State = Any


class Optimizer(NamedTuple):
    # State trees are built only from dicts and tuples of tensors (adam's
    # {"m", "v", "count"}, chain's tuple of states), as the reference's.
    init: Callable[[Params], State]
    update: Callable[[Grads, State, Params], tuple[Grads, State]]


def apply_updates(params: Params, updates: Grads) -> Params:
    """params + updates, in the params' dtype (master weights stay f32)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def chain(*optimizers: Optimizer) -> Optimizer:
    """Compose transformations left to right (grads flow through all)."""

    def init(params):
        return tuple(o.init(params) for o in optimizers)

    def update(grads, state, params):
        new_states = []
        for o, s in zip(optimizers, state):
            grads, ns = o.update(grads, s, params)
            new_states.append(ns)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def scale(factor: float) -> Optimizer:
    return Optimizer(
        init=lambda params: (),
        update=lambda g, s, p: (tree_map(lambda x: x * factor, g), s),
    )


_NORM = threading.local()


@contextlib.contextmanager
def sum_of_squares_over(fn: Callable[[Any], torch.Tensor]):
    """Inside the block, `global_norm(tree)` is ``sqrt(fn(tree))``: under
    FSDP or TP a rank holds slices of some leaves, and the step passes
    the function that adds the slices' sums over ranks
    (`sharded_sum_of_squares`; the norm the reference's GSPMD program
    computes over the global arrays)."""
    prev = getattr(_NORM, "fn", None)
    _NORM.fn = fn
    try:
        yield
    finally:
        _NORM.fn = prev


def sum_of_squares(tree) -> torch.Tensor:
    """The sum over leaves of each leaf's f32 sum of squares, summed in
    the reference's order."""
    return sum(torch.sum(torch.square(x.to(torch.float32)))
               for x in leaves(tree))


def sharded_sum_of_squares(placement) -> Callable[[Any], torch.Tensor]:
    """`sum_of_squares` of a param-shaped tree whose leaves are this
    rank's slices under `placement` (`parallel/sharding.Placement`): each
    leaf squared and summed locally, the leaves sharded over the same
    axes summed together and all-reduced over those axes, the replicated
    leaves counted once. Every rank gets the same bits: the replicated
    leaves are bit-equal across ranks and each reduced part is one
    all-reduce, the parts added in a fixed order. Equal to the unsharded
    `sum_of_squares` to rounding."""
    from dist_mnist_tpu_torch.cluster.mesh import DATA_AXIS, MODEL_AXIS
    from dist_mnist_tpu_torch.parallel.collectives import all_reduce_
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    mesh = placement.mesh
    specs = dict(flatten_with_path(placement.specs.params))
    order = ((DATA_AXIS,), (MODEL_AXIS,), (DATA_AXIS, MODEL_AXIS))

    def axes_of(path):
        return tuple(a for a in (DATA_AXIS, MODEL_AXIS)
                     if specs[path].dim(a) is not None
                     and mesh.shape[a] > 1)

    def fn(tree):
        flat = flatten_with_path(tree)
        zero = torch.zeros((), dtype=torch.float32, device=flat[0][1].device)
        parts: dict = {}
        for path, x in flat:
            parts.setdefault(axes_of(path), []).append(x)
        total = sum_of_squares(parts.get((), [])) + zero
        for axes in order:
            if axes not in parts:
                continue
            part = (sum_of_squares(parts[axes]) + zero).reshape(1)
            for axis in axes:
                part = all_reduce_(part, mesh, axis)
            total = part[0] + total
        return total

    return fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of `sum_of_squares` (or of the function `sum_of_squares_over`
    installed)."""
    fn = getattr(_NORM, "fn", None)
    return torch.sqrt(fn(tree) if fn is not None else sum_of_squares(tree))


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-12)), dividing by a tensor: torch
    turns `float / tensor` into a reciprocal times the float, which is not
    the reference's division."""
    return torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12),
                       max=1.0)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def update(grads, state, params):
        factor = clip_factor(global_norm(grads), max_norm)
        return tree_map(lambda g: g * factor, grads), state

    return Optimizer(init=lambda p: (), update=update)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    """L2 regularization: adds wd*p INTO the gradient, so when chained
    before an adaptive optimizer the decay is scaled by its normalizer.
    For decoupled (AdamW-style) decay use `optim.adamw` instead."""

    def update(grads, state, params):
        return (tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                         grads, params),
                state)

    return Optimizer(init=lambda p: (), update=update)


def tree_device(tree) -> torch.device:
    """The device of a tree's first leaf (an optimizer's counters live
    there)."""
    return leaves(tree)[0].device
