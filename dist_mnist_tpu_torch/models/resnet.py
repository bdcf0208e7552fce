"""ResNet-20 for CIFAR-10 (port of the reference `models/resnet.py`).

Classic CIFAR ResNet (He et al. 2016): 3 stages x 3 basic blocks, widths
16/32/64, stride 2 at the entry of stages 2 and 3 with a 1x1 projection
shortcut, batch norm + ReLU, global average pool, fc10. Compute in
bfloat16 by default; params, batch-norm statistics and logits in f32.
Training batch norm is synchronized over the ranks of the ambient mesh
(`ops/nn.batch_norm`). No dropout.
"""

from __future__ import annotations

import dataclasses

import torch

from dist_mnist_tpu_torch.ops import nn


def _init_block(gen, cin, cout, stride):
    params = {"conv1": nn.init_conv(gen, 3, 3, cin, cout, init=nn.he_normal),
              "conv2": nn.init_conv(gen, 3, 3, cout, cout,
                                    init=nn.he_normal)}
    bn1_p, bn1_s = nn.init_batch_norm(cout)
    bn2_p, bn2_s = nn.init_batch_norm(cout)
    params.update(bn1=bn1_p, bn2=bn2_p)
    state = {"bn1": bn1_s, "bn2": bn2_s}
    if stride != 1 or cin != cout:
        params["proj"] = nn.init_conv(gen, 1, 1, cin, cout, init=nn.he_normal)
    return params, state


def _apply_block(p, s, x, stride, train):
    y = nn.conv2d(p["conv1"], x, stride=stride)
    y, s1 = nn.batch_norm(p["bn1"], s["bn1"], y, train=train)
    y = nn.relu(y)
    y = nn.conv2d(p["conv2"], y)
    y, s2 = nn.batch_norm(p["bn2"], s["bn2"], y, train=train)
    shortcut = nn.conv2d(p["proj"], x, stride=stride) if "proj" in p else x
    return nn.relu(y + shortcut), {"bn1": s1, "bn2": s2}


@dataclasses.dataclass(frozen=True)
class ResNet20:
    num_classes: int = 10
    widths: tuple[int, ...] = (16, 32, 64)
    blocks_per_stage: int = 3
    compute_dtype: torch.dtype = torch.bfloat16

    def _strides(self):
        for si in range(len(self.widths)):
            for bi in range(self.blocks_per_stage):
                yield si, bi, 2 if (si > 0 and bi == 0) else 1

    def init(self, gen, sample_input):
        c = int(sample_input.shape[-1])
        params: dict = {"stem": nn.init_conv(gen, 3, 3, c, self.widths[0],
                                             init=nn.he_normal)}
        bn_p, bn_s = nn.init_batch_norm(self.widths[0])
        params["stem_bn"] = bn_p
        state: dict = {"stem_bn": bn_s}
        cin = self.widths[0]
        for si, bi, stride in self._strides():
            w = self.widths[si]
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = _init_block(
                gen, cin, w, stride)
            cin = w
        params["head"] = nn.init_dense(gen, cin, self.num_classes,
                                       init=nn.xavier_uniform)
        return params, state

    def flops_per_example(self, sample_shape) -> float:
        """Analytic FORWARD FLOPs per example (conv/matmul MACs x2; BN and
        elementwise ignored), the reference's count."""
        h, w, c = (int(d) for d in sample_shape[1:])
        total = h * w * self.widths[0] * (3 * 3 * c) * 2  # stem
        cin = self.widths[0]
        for si, cout in enumerate(self.widths):
            for bi in range(self.blocks_per_stage):
                stride = 2 if (si > 0 and bi == 0) else 1
                if stride == 2:
                    h, w = h // 2, w // 2
                total += h * w * cout * (3 * 3 * cin) * 2   # conv1
                total += h * w * cout * (3 * 3 * cout) * 2  # conv2
                if stride == 2 or cin != cout:
                    total += h * w * cout * cin * 2         # 1x1 projection
                cin = cout
        total += cin * self.num_classes * 2  # head after global avg pool
        return float(total)

    def dropout_masks(self, gen, x, *, global_batch=None, offset=0):
        """None: the model has no dropout."""
        del gen, x, global_batch, offset
        return None

    def apply(self, params, state, x, *, train=False, rng=None,
              dropout_mask=None):
        del rng, dropout_mask  # no dropout in this model
        x = x.to(self.compute_dtype)
        x = nn.conv2d(params["stem"], x)
        x, stem_s = nn.batch_norm(params["stem_bn"], state["stem_bn"], x,
                                  train=train)
        x = nn.relu(x)
        new_state = {"stem_bn": stem_s}
        for si, bi, stride in self._strides():
            name = f"s{si}b{bi}"
            x, new_state[name] = _apply_block(params[name], state[name], x,
                                              stride, train)
        x = nn.global_avg_pool(x)
        logits = nn.dense(params["head"], x)
        return logits.to(torch.float32), new_state
