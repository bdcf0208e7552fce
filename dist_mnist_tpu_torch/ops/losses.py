"""Loss functions (port of the reference `ops/losses.py`).

The original dist_mnist.py trainer's clipped cross-entropy
(``loss = -Σ y_·log(clip(softmax(logits), 1e-10, 1.0))``, the `mlp_mnist`
config's ``loss="clipped"``) beside the stable log-softmax form every
other config uses. Labels are integer class ids; one-hot happens here. A
label of -1 one-hots to the zero row, so a padding row contributes
exactly 0 to a ``"sum"`` (the evaluation's padded tail relies on it).
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.utils.tree import leaves


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; an id outside [0, n) gives the zero row, as
    `jax.nn.one_hot` does."""
    classes = torch.arange(n, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def clipped_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  *, reduction: str = "mean") -> torch.Tensor:
    """The reference's exact loss: explicit softmax, clip to [1e-10, 1], -Σ."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    logp = torch.log(torch.clamp(probs, 1e-10, 1.0))
    per_example = -torch.sum(one_hot(labels, logits.shape[-1]) * logp, dim=-1)
    return _reduce(per_example, reduction)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          reduction: str = "mean",
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Stable log-softmax cross-entropy (default loss for all configs)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    n = logits.shape[-1]
    onehot = one_hot(labels, n)
    if label_smoothing:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
    per_example = -torch.sum(onehot * logp, dim=-1)
    return _reduce(per_example, reduction)


def l2_regularization(params, scale: float) -> torch.Tensor:
    return scale * sum(torch.sum(torch.square(a.to(torch.float32)))
                       for a in leaves(params))


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":  # the reference reduced with -Σ over the batch too
        return torch.sum(x)
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")
