"""LeNet-5 CNN (port of the reference `models/lenet.py`):
conv5x5x32 → maxpool → conv5x5x64 → maxpool → fc512 → fc10.

Compute defaults to bfloat16 while params and logits stay f32. Served
int8, fc1 (``[3136, 512]``) and fc2 (``[512, 10]``) run the
`quant_matmul` kernel; the convs dequantize their kernels and go through
`F.conv2d`.
"""

from __future__ import annotations

import dataclasses

import torch

from dist_mnist_tpu_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class LeNet5:
    num_classes: int = 10
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

    def apply(self, params, state, x, *, train=False):
        if train:
            raise NotImplementedError("the port serves only (train=False)")
        x = x.to(self.compute_dtype)
        x = nn.relu(nn.conv2d(params["conv1"], x))
        x = nn.max_pool(x, 2)
        x = nn.relu(nn.conv2d(params["conv2"], x))
        x = nn.max_pool(x, 2)
        x = nn.flatten(x)
        x = nn.relu(nn.dense(params["fc1"], x))
        logits = nn.dense(params["fc2"], x)
        return logits.to(torch.float32), state
