"""Adam with the reference's semantics (port of the reference
`optim/adam.py`): TF's ApplyAdam rule,

    lr_t   = lr * sqrt(1 - b2^t) / (1 - b1^t)
    m_t    = b1*m + (1-b1)*g
    v_t    = b2*v + (1-b2)*g^2
    param -= lr_t * m_t / (sqrt(v_t) + eps)      # eps OUTSIDE the sqrt

with a step counter in place of beta-power variables. The state is
``{"m", "v", "count"}``: f32 slots shaped like the params and an int32
`count` on their device. `lr_t` and the clip factor are device tensors
computed from `count` and the grads, so no update reads a value back to
the host.

`fused=True` (and `fused_adamw`) run every leaf's update in one launch
of a CUDA kernel (`ops/kernels/fused_adam.py`, the ``*_leaves``
functions), the counterpart of the reference's per-leaf Pallas kernels.
The unfused path runs the kernel's plain version leaf by leaf, the same
torch arithmetic on any device, so the order of the roundings is written
down once.
"""

from __future__ import annotations

from typing import Callable

import torch

from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
    fused_adam_clip_wd_update_leaves,
    fused_adam_update_leaves,
    fused_adam_update_leaves_reference,
)
from dist_mnist_tpu_torch.optim.base import (
    Optimizer,
    clip_factor,
    global_norm,
    tree_device,
)
from dist_mnist_tpu_torch.utils.tree import (
    flatten_with_path,
    map_with_path,
    tree_map,
)


def _lr_at(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _bias_corrected(lr, count, b1, b2) -> torch.Tensor:
    t = count.to(torch.float32)
    return lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)


def _init(params):
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_device(params))}


def _all_leaves(update_leaves, g32, state, params=None):
    """Run `update_leaves(gs, ms, vs[, ps]) -> (deltas, ms, vs)` once over
    every leaf (lists in the grads' leaf order) and regroup the results
    into (updates, m, v) trees."""
    flat = flatten_with_path(g32)
    paths = [path for path, _ in flat]
    trees = [state["m"], state["v"]] + ([params] if params is not None
                                        else [])
    args = [[g for _, g in flat]] + [
        [d[path] for path in paths]
        for d in (dict(flatten_with_path(t)) for t in trees)]
    outs = [dict(zip(paths, out)) for out in update_leaves(*args)]
    return tuple(map_with_path(lambda path, _: out[path], g32)
                 for out in outs)


def adam(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    *,
    fused: bool = False,
) -> Optimizer:
    """`fused=True` routes the slot and delta update of every leaf through
    one launch of the one-pass CUDA kernel (`fused_adam_update_leaves`)
    instead of torch ops; same math, one pass over device memory."""

    leaves_update = (fused_adam_update_leaves if fused
                     else fused_adam_update_leaves_reference)

    def update(grads, state, params):
        del params
        count = state["count"] + 1
        lr_t = _bias_corrected(_lr_at(learning_rate, count), count, b1, b2)
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        updates, m, v = _all_leaves(
            lambda gs, ms, vs: leaves_update(gs, ms, vs, lr_t, b1=b1, b2=b2,
                                             eps=eps),
            g32, state)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(_init, update)


def adamw(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> Optimizer:
    """Adam with DECOUPLED weight decay (Loshchilov & Hutter): the decay term
    bypasses the m/v normalization — update = adam_delta - lr*wd*param —
    unlike chaining add_decayed_weights before adam (which is plain L2)."""
    inner = adam(learning_rate, b1, b2, eps)

    def update(grads, state, params):
        lr = _lr_at(learning_rate, state["count"] + 1)
        updates, new_state = inner.update(grads, state, params)
        updates = tree_map(lambda u, p: u - lr * weight_decay * p.to(u.dtype),
                           updates, params)
        return updates, new_state

    return Optimizer(inner.init, update)


def fused_adamw(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: float | None = None,
) -> Optimizer:
    """One-pass fused `clip_by_global_norm >> adamw`: the global-norm clip
    factor is computed ONCE over the tree, then one launch of a CUDA kernel
    does clip scale, m/v slots, Adam delta and the decoupled
    `-lr*wd*param` term for every leaf
    (`fused_adam_clip_wd_update_leaves`). The same math as
    `chain(clip_by_global_norm(clip_norm), adamw(...))`; with
    `weight_decay=0` and `clip_norm=None` it routes to the `fused_adam_update`
    kernel, bit-identical to `adam(fused=True)`."""
    plain = weight_decay == 0.0 and clip_norm is None

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, count)
        lr_t = _bias_corrected(lr, count, b1, b2)
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        if plain:
            updates, m, v = _all_leaves(
                lambda gs, ms, vs: fused_adam_update_leaves(
                    gs, ms, vs, lr_t, b1=b1, b2=b2, eps=eps),
                g32, state)
            return updates, {"m": m, "v": v, "count": count}
        device = count.device
        if clip_norm is None:
            clip_scale = torch.ones((), dtype=torch.float32, device=device)
        else:  # the factor of optim.base.clip_by_global_norm
            clip_scale = clip_factor(global_norm(g32), clip_norm)
        wd_step = lr * weight_decay
        if not isinstance(wd_step, torch.Tensor):
            # a fill on the device, not a copy from the host (which waits)
            wd_step = torch.full((), wd_step, dtype=torch.float32,
                                 device=device)
        scalars = torch.stack([lr_t.to(torch.float32).reshape(()),
                               clip_scale.reshape(()),
                               wd_step.to(torch.float32).reshape(())])
        updates, m, v = _all_leaves(
            lambda gs, ms, vs, ps: fused_adam_clip_wd_update_leaves(
                gs, ms, vs, [p.to(torch.float32) for p in ps], scalars,
                b1=b1, b2=b2, eps=eps),
            g32, state, params)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(_init, update)
