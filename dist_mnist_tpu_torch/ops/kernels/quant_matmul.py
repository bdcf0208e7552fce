"""Fused int8 dequant-matmul for the weight-only serve path.

Counterpart of the reference Pallas kernel
(`dist_mnist_tpu/ops/pallas/quant_matmul.py`, `_qmm_kernel` under
`quant_matmul`): ``out[m, h] = cast_to_x_dtype(scale[h] * Σ_k f32(x[m, k])
· f32(q[k, h]))`` — f32 accumulation, the per-channel scale applied once
at the epilogue, no float copy of the weight ever made. The CUDA bodies
are in `csrc/quant_matmul.cu` (its header says how they are tiled and
why).

`quant_matmul` checks its inputs, then launches a kernel for CUDA tensors
and runs `quant_matmul_reference` (the same math in plain torch) for CPU
tensors; it never routes a CUDA tensor around the kernels. It picks the
kernel by x's type: bf16 takes the tensor-core split-K kernel (whose
products are exact, so it keeps the reference's numbers), float32 the
full-precision split-K kernel on the CUDA cores.
`quant_matmul.launches` counts kernel launches, and
`quant_matmul.f32_launches` those of the float32 route.

Both kernels split K by `split_k_plan(m, k, h, tile)`, a function of the
shape and the route's tile (`route_tile`) alone, so an input gives the
same bits on any card; their partial tiles are summed in split order by
the last block to reach a tile, counted by per-tile arrival counters that
each launch leaves at zero (one zeroed buffer per device and stream,
`_arrivals`, shared by the routes).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dist_mnist_tpu_torch.ops.kernels import build

_MAX_GRID_Y = 65535
_INT_MAX = 2**31 - 1
#: the H100 SXM's 132 SMs, which the split-K grids aim to fill. A constant
#: of the design, never read from the device, so the plan (and the bits)
#: are the same on every card
SMS = 132


class Tile(NamedTuple):
    """A route's block tile: activation rows and output channels per
    block, the K chunk its splits are counted in, its most splits, and the
    blocks its grid aims for."""

    rows: int
    cols: int
    chunk: int
    max_splits: int
    blocks: int


#: the bf16 kernel's tile (csrc/quant_matmul.cu: TC_BM, TC_BN, TC_BK), one
#: block per SM
BF16_TILE = Tile(64, 32, 64, 16, SMS)
#: the f32 kernel's channels per block and K chunk (F_BN, F_BK) and its most
#: rows per block (its rows are M's power of two up to that); its blocks,
#: a chunk or two of loads and FMAs each, aim for two per SM
F32_COLS, F32_CHUNK, F32_MAX_ROWS, F32_MAX_SPLITS = 32, 32, 16, 32


def route_tile(dtype: torch.dtype, m: int) -> Tile:
    """The tile of the kernel that takes x of `dtype` with `m` rows: bf16
    a fixed 64 x 32; f32 `m` rounded up to a power of two (at most 16)
    rows, so one row computes no padding rows."""
    if dtype == torch.bfloat16:
        return BF16_TILE
    rows = min(F32_MAX_ROWS, 1 << max(0, m - 1).bit_length())
    return Tile(rows, F32_COLS, F32_CHUNK, F32_MAX_SPLITS, 2 * SMS)


_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "dmt_quant_matmul_f32": [_VP] * 6 + [_I] * 8 + [_VP],
    "dmt_quant_matmul_bf16": [_VP] * 6 + [_I] * 7 + [_VP],
}


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
    if max(m, d, h) > _INT_MAX or \
            -(-m // route_tile(x.dtype, m).rows) > _MAX_GRID_Y:
        raise ValueError(f"quant_matmul: shape [{m}, {d}] x [{d}, {h}] "
                         "exceeds the kernel's grid")
    return m, d, h


def split_k_plan(m: int, k: int, h: int,
                 tile: Tile) -> tuple[int, int, int]:
    """``(tiles, splits, chunks_per_split)`` of the kernel with `tile` for
    an ``[m, k] x [k, h]`` call: its output tiles, and its split of K in
    chunks of ``tile.chunk``: enough splits that tiles x splits reach
    ``tile.blocks`` (at most ``tile.max_splits``, at most one per chunk),
    then as many as cover K with no empty split. A function of the shape
    and the tile alone."""
    tiles = -(-h // tile.cols) * -(-m // tile.rows)
    chunks = max(1, -(-k // tile.chunk))
    want = min(tile.max_splits, chunks, max(1, -(-tile.blocks // tiles)))
    per = -(-chunks // want)
    return tiles, -(-chunks // per), per


def vec_loads(x: torch.Tensor, w_q: torch.Tensor) -> tuple[bool, bool]:
    """Whether the kernel for x's type may load x and w_q by vectors: x
    by 16 bytes in both routes (a 16-byte base and rows a whole number of
    16 bytes), w_q by 16 bytes in the bf16 route and 4 in the f32 route
    (its base and H a multiple of that). Otherwise that operand takes
    plain loads (the same tiles)."""
    row_x = x.shape[-1] * x.element_size()
    width = 16 if x.dtype == torch.bfloat16 else 4
    return (x.data_ptr() % 16 == 0 and row_x % 16 == 0,
            w_q.data_ptr() % width == 0 and w_q.shape[1] % width == 0)


@functools.cache
def _entry(symbol: str):
    """A function of the built library, loaded and typed once."""
    fn = getattr(build.load("quant_matmul"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


_arrival_buffers: dict[tuple[int, int], torch.Tensor] = {}


def _arrivals(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters, at least `n`, for launches on one
    stream of one device: launches on one stream run in order, and each
    leaves its counters at zero, so the next one finds them so."""
    key = (device.index, stream)
    buf = _arrival_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _arrival_buffers[key] = buf
    return buf


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
    tile = route_tile(x.dtype, m)
    tiles, splits, per = split_k_plan(m, d, h, tile)
    partial = torch.empty(tiles * splits * tile.rows * tile.cols
                          if splits > 1 else 0, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                out.data_ptr(), partial.data_ptr(),
                _arrivals(x.device, stream, tiles).data_ptr(), m, d, h)
        vec = tuple(map(int, vec_loads(x, w_q)))
        if x.dtype == torch.bfloat16:
            err = _entry("dmt_quant_matmul_bf16")(*args, splits, per, *vec,
                                                  stream)
        else:
            err = _entry("dmt_quant_matmul_f32")(*args, tile.rows, splits,
                                                 per, *vec, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"cudaError {err}")
    quant_matmul.launches += 1
    if x.dtype == torch.float32:
        quant_matmul.f32_launches += 1
    return out


quant_matmul.launches = 0
quant_matmul.f32_launches = 0


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
