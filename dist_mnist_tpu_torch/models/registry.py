"""Model registry: name -> constructor (the served models so far)."""

from __future__ import annotations

from dist_mnist_tpu_torch.models.lenet import LeNet5
from dist_mnist_tpu_torch.models.mlp import MLP

MODELS = {
    "mlp": MLP,
    "lenet5": LeNet5,
}


def get_model(name: str, **overrides):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](**overrides)
