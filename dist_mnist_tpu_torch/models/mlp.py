"""2-layer MLP — the original dist_mnist.py model (port of the reference
`models/mlp.py`): ``hid_w [784, hidden]``, ``sm_w [hidden, 10]``,
truncated-normal init with stddev 1/sqrt(fan_in), ReLU hidden layer, raw
f32 logits (the `mlp_mnist` config pairs them with the clipped loss). It
has no dropout, so training and serving run the same forward."""

from __future__ import annotations

import dataclasses
import math

import torch

from dist_mnist_tpu_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class MLP:
    hidden_units: int = 100
    num_classes: int = 10
    compute_dtype: torch.dtype = torch.float32

    def init(self, gen, sample_input):
        in_dim = math.prod(int(d) for d in sample_input.shape[1:])
        params = {
            "hid": nn.init_dense(gen, in_dim, self.hidden_units),
            "sm": nn.init_dense(gen, self.hidden_units, self.num_classes),
        }
        return params, {}

    def flops_per_example(self, sample_shape) -> float:
        """Analytic FORWARD FLOPs per example (matmul MACs x2; elementwise
        ignored), the MFU numerator's per-example count."""
        in_dim = math.prod(int(d) for d in sample_shape[1:])
        return 2.0 * (in_dim * self.hidden_units
                      + self.hidden_units * self.num_classes)

    def dropout_masks(self, gen, x, *, global_batch=None, offset=0):
        """None: the model has no dropout."""
        del gen, x, global_batch, offset
        return None

    def apply(self, params, state, x, *, train=False, rng=None,
              dropout_mask=None):
        del train, rng, dropout_mask  # no dropout in this model
        x = nn.flatten(x).to(self.compute_dtype)
        h = nn.relu(nn.dense(params["hid"], x))
        logits = nn.dense(params["sm"], h)
        return logits.to(torch.float32), state
