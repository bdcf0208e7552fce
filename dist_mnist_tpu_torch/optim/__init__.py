"""Optimizers on the gradient-transformation pattern (port of the
reference `optim/`): pure ``init``/``update`` pairs over nested-dict
trees of tensors, composable with `chain`. `adam(fused=True)` and
`fused_adamw` run every leaf's update in one launch of a hand-written
CUDA kernel (`ops/kernels/fused_adam.py`).

`build_optimizer` builds a config's optimizer as the reference's
`cli/train.py build_optimizer` does. The reference's
`gradient_accumulation` (`optim/sync.py`) joins with the data-parallel
slice.
"""

from dist_mnist_tpu_torch.optim import schedules
from dist_mnist_tpu_torch.optim.adam import adam, adamw, fused_adamw
from dist_mnist_tpu_torch.optim.base import (
    Optimizer,
    add_decayed_weights,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    scale,
)
from dist_mnist_tpu_torch.optim.sgd import momentum, sgd


def build_optimizer(cfg) -> Optimizer:
    """The optimizer a `configs.Config` names: its base rule (decoupled
    weight decay folded into adamw), preceded by the global-norm clip and
    L2 decay it asks for, on a constant or cosine learning rate."""
    aggregate = max(1, cfg.replicas_to_aggregate or 1)
    if aggregate > 1:
        raise NotImplementedError(
            "replicas_to_aggregate > 1 (gradient accumulation) joins the "
            "port with the data-parallel slice")
    if cfg.lr_schedule == "cosine":
        lr = schedules.cosine_decay(cfg.learning_rate, max(1, cfg.train_steps),
                                    max(0, cfg.warmup_steps))
    else:
        lr = cfg.learning_rate
    if cfg.optimizer == "adam" and cfg.weight_decay:
        base = adamw(lr, weight_decay=cfg.weight_decay)
        wd_handled = True
    else:
        base = {
            "adam": lambda: adam(lr),
            "sgd": lambda: sgd(lr),
            "momentum": lambda: momentum(lr, 0.9),
        }[cfg.optimizer]()
        wd_handled = False
    parts = []
    if cfg.grad_clip_norm:
        parts.append(clip_by_global_norm(cfg.grad_clip_norm))
    if cfg.weight_decay and not wd_handled:
        parts.append(add_decayed_weights(cfg.weight_decay))
    parts.append(base)
    return chain(*parts) if len(parts) > 1 else base


__all__ = [
    "Optimizer",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "scale",
    "add_decayed_weights",
    "global_norm",
    "adam",
    "adamw",
    "fused_adamw",
    "sgd",
    "momentum",
    "schedules",
    "build_optimizer",
]
