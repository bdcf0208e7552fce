"""Model registry: name -> constructor (the ported models so far)."""

from __future__ import annotations

from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
from dist_mnist_tpu_torch.models.lenet import LeNet5
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.models.resnet import ResNet20
from dist_mnist_tpu_torch.models.vit import ViTTiny

MODELS = {
    "mlp": MLP,
    "lenet5": LeNet5,
    "resnet20": ResNet20,
    "causal_tiny": CausalLMTiny,
    "vit_tiny": ViTTiny,
}


def get_model(name: str, **overrides):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](**overrides)
