"""Functional NN layers: init fns returning param dicts + pure apply fns.

Port of the reference `ops/nn.py` for the layers the served models use.
The public layouts are the reference's — NHWC images, HWIO conv kernels,
``[in, out]`` dense kernels — so converted reference params drop in
unchanged. Inside, a conv runs `F.conv2d` on an NCHW view of the NHWC
tensor (a channels-last layout, so no copy), and its output goes back to
NHWC. Params are float32; activations run in the model's compute dtype.

Initializers draw from an explicit CPU `torch.Generator` (the same
numbers on every device); they match the reference's distributions, not
its bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dist_mnist_tpu_torch.ops.quant import QuantizedArray, dequantize, q_dot

Params = dict


# ---------------------------------------------------------------------------
# initializers


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """2-sigma truncated normal scaled by `stddev`."""
    t = torch.empty(tuple(shape), dtype=dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return stddev * t


def fan_in_trunc_normal(gen, shape, dtype=torch.float32):
    fan_in = math.prod(shape[:-1])
    return truncated_normal(gen, shape, 1.0 / (fan_in**0.5), dtype)


def he_normal(gen, shape, dtype=torch.float32):
    fan_in = math.prod(shape[:-1])
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) \
        * (2.0 / fan_in) ** 0.5


def xavier_uniform(gen, shape, dtype=torch.float32):
    fan_in = math.prod(shape[:-1])
    fan_out = int(shape[-1])
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype)
    return (2.0 * u - 1.0) * limit


# ---------------------------------------------------------------------------
# dense


def init_dense(gen, in_dim: int, out_dim: int, *,
               init=fan_in_trunc_normal) -> Params:
    return {"w": init(gen, (in_dim, out_dim)), "b": torch.zeros(out_dim)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, QuantizedArray):
        # weight-only int8: the quant_matmul kernel reads the int8 weight
        return q_dot(x.contiguous(), w) + p["b"].to(x.dtype)
    return x @ w.to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# conv / pool


def init_conv(gen, kh: int, kw: int, cin: int, cout: int, *,
              init=fan_in_trunc_normal) -> Params:
    return {"w": init(gen, (kh, kw, cin, cout)), "b": torch.zeros(cout)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC `x` convolved with the HWIO kernel `p["w"]` (+ bias), NHWC out.
    A quantized kernel is dequantized into x.dtype first (the reference's
    rounding), then convolved."""
    w = p["w"]
    w = (dequantize(w, x.dtype) if isinstance(w, QuantizedArray)
         else w.to(x.dtype))
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)       # NCHW view of NHWC memory
    wc = w.permute(3, 2, 0, 1)       # HWIO -> OIHW
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pads(x.shape[1], kh, stride),
                                        _same_pads(x.shape[2], kw, stride))
        if (top, left) == (bottom, right):
            y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
        else:
            y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc,
                         stride=stride)
    elif padding == "VALID":
        y = F.conv2d(xc, wc, stride=stride)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 2,
             stride: int | None = None) -> torch.Tensor:
    """NHWC max pool, VALID padding."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# activations / reshapes


relu = F.relu


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Row-major flatten of the NHWC layout — (h, w, c) order, the order
    the reference's dense kernels were laid out for."""
    return x.reshape(x.shape[0], -1)
