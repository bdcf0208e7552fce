"""LeNet-5 CNN (port of the reference `models/lenet.py`):
conv5x5x32 → maxpool → conv5x5x64 → maxpool → fc512 → dropout → fc10.

Compute defaults to bfloat16 while params and logits stay f32; autograd
through the casts gives f32 grads on the f32 leaves. Training applies
dropout at `dropout_rate` after fc1's ReLU, with the keep-mask drawn from
the generator `rng` or given as `dropout_mask`. Served int8, fc1
(``[3136, 512]``) and fc2 (``[512, 10]``) run the `quant_matmul` kernel;
the convs dequantize their kernels and go through `F.conv2d`.
"""

from __future__ import annotations

import dataclasses

import torch

from dist_mnist_tpu_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class LeNet5:
    num_classes: int = 10
    dropout_rate: float = 0.5
    compute_dtype: torch.dtype = torch.bfloat16

    def init(self, gen, sample_input):
        h, w, c = (int(d) for d in sample_input.shape[1:])
        fc_in = (h // 4) * (w // 4) * 64  # two SAME convs + two 2x2 pools
        params = {
            "conv1": nn.init_conv(gen, 5, 5, c, 32),
            "conv2": nn.init_conv(gen, 5, 5, 32, 64),
            "fc1": nn.init_dense(gen, fc_in, 512),
            "fc2": nn.init_dense(gen, 512, self.num_classes),
        }
        return params, {}

    def flops_per_example(self, sample_shape) -> float:
        """Analytic FORWARD FLOPs per example (conv/matmul MACs x2), the
        MFU numerator's per-example count."""
        h, w, c = (int(d) for d in sample_shape[1:])
        conv1 = h * w * 32 * (5 * 5 * c) * 2
        conv2 = (h // 2) * (w // 2) * 64 * (5 * 5 * 32) * 2
        fc1 = ((h // 4) * (w // 4) * 64) * 512 * 2
        fc2 = 512 * self.num_classes * 2
        return float(conv1 + conv2 + fc1 + fc2)

    def dropout_masks(self, gen, x, *, global_batch=None, offset=0):
        """fc1's keep-mask ``[B, 512]`` for the batch `x`: ``uniform[0, 1)
        < 1 - rate`` drawn from `gen` for `global_batch` rows (default
        x's), rows ``offset : offset + B`` kept (a rank's slice of a
        global draw; the same numbers `apply` draws from `gen`)."""
        b = x.shape[0]
        rows = b if global_batch is None else global_batch
        keep = torch.rand((rows, 512), generator=gen, device=x.device) \
            < 1.0 - self.dropout_rate
        return keep[offset:offset + b]

    def apply(self, params, state, x, *, train=False, rng=None,
              dropout_mask=None):
        x = x.to(self.compute_dtype)
        x = nn.relu(nn.conv2d(params["conv1"], x))
        x = nn.max_pool(x, 2)
        x = nn.relu(nn.conv2d(params["conv2"], x))
        x = nn.max_pool(x, 2)
        x = nn.flatten(x)
        x = nn.relu(nn.dense(params["fc1"], x))
        if train and (rng is not None or dropout_mask is not None):
            x = nn.dropout(x, self.dropout_rate, train=True, gen=rng,
                           mask=dropout_mask)
        logits = nn.dense(params["fc2"], x)
        return logits.to(torch.float32), state
