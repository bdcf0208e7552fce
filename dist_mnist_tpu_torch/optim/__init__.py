"""Optimizers on the gradient-transformation pattern (port of the
reference `optim/`): pure ``init``/``update`` pairs over nested-dict
trees of tensors, composable with `chain`. `adam(fused=True)` and
`fused_adamw` run every leaf's update in one launch of a hand-written
CUDA kernel (`ops/kernels/fused_adam.py`).

`build_optimizer` builds a config's optimizer as the reference's
`cli/train.py build_optimizer` does, `replicas_to_aggregate > 1` as
`gradient_accumulation` (`sync.py`) around it.
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
from dist_mnist_tpu_torch.optim.sync import gradient_accumulation


def build_optimizer(cfg) -> Optimizer:
    """The optimizer a `configs.Config` names: its base rule (decoupled
    weight decay folded into adamw), preceded by the global-norm clip and
    L2 decay it asks for, on a constant or cosine learning rate; with
    ``replicas_to_aggregate = k > 1``, applied once per k steps on the
    mean gradient (the cosine horizon counted in updates, k steps each)."""
    aggregate = max(1, cfg.replicas_to_aggregate or 1)
    if cfg.lr_schedule == "cosine":
        lr = schedules.cosine_decay(cfg.learning_rate,
                                    max(1, cfg.train_steps // aggregate),
                                    max(0, cfg.warmup_steps // aggregate))
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
    opt = chain(*parts) if len(parts) > 1 else base
    return gradient_accumulation(opt, aggregate) if aggregate > 1 else opt


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
    "gradient_accumulation",
    "schedules",
    "build_optimizer",
]
