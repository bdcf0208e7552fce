"""Fused int8 dequant-matmul for the weight-only serve path.

Counterpart of the reference Pallas kernel
(`dist_mnist_tpu/ops/pallas/quant_matmul.py`, `_qmm_kernel` under
`quant_matmul`): ``out[m, h] = cast_to_x_dtype(scale[h] * Σ_k f32(x[m, k])
· f32(q[k, h]))`` — f32 accumulation, the per-channel scale applied once
at the epilogue, no float copy of the weight ever made. The CUDA body is
`csrc/quant_matmul.cu` (its header says how it is tiled and why).

`quant_matmul` checks its inputs, then launches the kernel for CUDA
tensors and runs `quant_matmul_reference` (the same math in plain torch)
for CPU tensors; it never routes a CUDA tensor around the kernel.
`quant_matmul.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dist_mnist_tpu_torch.ops.kernels import build

_BM = 32  # activation rows per block: csrc/quant_matmul.cu BM
_MAX_GRID_Y = 65535
_INT_MAX = 2**31 - 1
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def quant_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain torch: f32 product of the upcast
    operands, scale on the f32 result, one rounding to x.dtype."""
    acc = x.reshape(-1, x.shape[-1]).to(torch.float32) @ w_q.to(torch.float32)
    out = (acc * w_scale.reshape(1, -1).to(torch.float32)).to(x.dtype)
    return out.reshape(*x.shape[:-1], w_q.shape[1])


def _check(x, w_q, w_scale) -> tuple[int, int, int]:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: w_q must be int8 and w_scale "
                        f"float32, got {w_q.dtype} and {w_scale.dtype}")
    if w_q.ndim != 2:
        raise ValueError(
            f"quant_matmul wants a 2-D int8 kernel, got {tuple(w_q.shape)}; "
            "stacked leaves are sliced to 2-D before the matmul")
    d, h = w_q.shape
    if x.ndim < 1 or x.shape[-1] != d:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} does not "
                         f"contract with w_q {tuple(w_q.shape)}")
    if tuple(w_scale.shape) not in ((1, h), (h,)):
        raise ValueError(f"quant_matmul: w_scale must be [1, {h}] or [{h}], "
                         f"got {tuple(w_scale.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and w_scale.is_contiguous()):
        raise ValueError("quant_matmul: x, w_q and w_scale must be "
                         "contiguous")
    if not x.device == w_q.device == w_scale.device:
        raise ValueError(f"quant_matmul: tensors on different devices "
                         f"({x.device}, {w_q.device}, {w_scale.device})")
    m = math.prod(x.shape[:-1])
    if max(m, d, h) > _INT_MAX or -(-m // _BM) > _MAX_GRID_Y:
        raise ValueError(f"quant_matmul: shape [{m}, {d}] x [{d}, {h}] "
                         "exceeds the kernel's grid")
    return m, d, h


@functools.cache
def _entry():
    """`dmt_quant_matmul` of the built library, loaded and typed once."""
    fn = build.load("quant_matmul").dmt_quant_matmul
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """`x @ (w_q * w_scale)` without materializing the float weight.

    x ``[..., D]`` float32/bfloat16, w_q ``[D, H]`` int8, w_scale ``[1, H]``
    or ``[H]`` float32, all contiguous on one device. Returns
    ``[..., H]`` in x.dtype."""
    m, d, h = _check(x, w_q, w_scale)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    out = torch.empty((*x.shape[:-1], h), dtype=x.dtype, device=x.device)
    if m == 0 or h == 0:
        return out
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            m, d, h, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"cudaError {err}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_cost(x_shape, w_shape, x_dtype=torch.float32) -> dict:
    """Analytic roofline inputs for one `quant_matmul` call: MACs x2 FLOPs
    and the device-memory bytes the function must move (activations in and
    out at compute width, int8 weight, f32 scales), each counted once."""
    d, h = (int(s) for s in w_shape)
    m = math.prod(int(s) for s in x_shape[:-1]) or 1
    act = torch.empty((), dtype=x_dtype).element_size()
    return {
        "flops": 2.0 * m * d * h,
        "hbm_bytes": float(m * d * act      # activations in
                           + d * h          # int8 weight
                           + 4 * h          # f32 scales
                           + m * h * act),  # output
    }
