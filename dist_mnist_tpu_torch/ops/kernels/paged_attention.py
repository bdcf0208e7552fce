"""Paged attention for the int8 KV decode step.

Counterpart of the reference Pallas kernel
(`dist_mnist_tpu/ops/pallas/paged_attention.py`, `_paged_attn_kernel`
under `_paged_attention_impl`): one query token per row against int8
K/V page pools ``[P, T, H, D]`` with per-token-per-head f32 scales
(`ops/quant.quantize_kv`), through a page table ``[R, n]`` — row r's
positions ``[j*T, (j+1)*T)`` live in pool page ``table[r, j]``. Row r
attends positions ``[0, lengths[r])``; pages at or past the length are
skipped. The CUDA body is `csrc/paged_attention.cu` (its header says how
it is laid out and what bounds it); it dequantizes in registers and
never writes a float copy of the pages.

`paged_attention` checks its inputs, then launches the kernel for CUDA
tensors and runs `paged_attention_reference` (gather, dequantize, masked
softmax, weight V — the reference's XLA path) for CPU tensors; it never
routes a CUDA tensor around the kernel. `paged_attention.launches`
counts kernel launches, `paged_attention_probe`'s included. The kernel
runs one warp per (row, head) (`decode_launch_plan`, which the C entry
computes too); `paged_attention_launch_floor` launches an empty kernel
of the same grid, block and arguments, for timing what a launch costs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dist_mnist_tpu_torch.ops.kernels import build
from dist_mnist_tpu_torch.ops.quant import QuantizedArray

#: largest head_dim the kernel takes (8 lanes of 16 dimensions a token)
MAX_HEAD_DIM = 128
#: dimensions of a token's row one lane of a decode kernel holds
DECODE_LANE_DIMS = 16
_MAX_GRID_Y = 65535
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_void_p])


def paged_attention_reference(q, k_pool: QuantizedArray,
                              v_pool: QuantizedArray, page_table, lengths):
    """The kernel's function in plain torch: gather the table's pages,
    dequantize (``f32(q) * f32(scale)``), f32 scores times ``D**-0.5``,
    ``-1e30`` past each row's length, softmax, weights @ V. q
    ``[R, 1, H, D]`` -> ``[R, 1, H, D]`` in q's dtype."""
    r, _, h, d = q.shape
    t = k_pool.q.shape[1]
    n = page_table.shape[1]
    idx = page_table.long()

    def gather(pool):
        return (pool.q[idx].to(torch.float32)
                * pool.scale[idx].to(torch.float32)).reshape(r, n * t, h, d)

    k, v = gather(k_pool), gather(v_pool)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k)
    scores = scores * float(np.float32(1.0) / np.sqrt(np.float32(d)))
    col = torch.arange(n * t, device=q.device)
    mask = col[None, :] < lengths[:, None]  # [R, n*T]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, lengths) -> None:
    if not (isinstance(k_pool, QuantizedArray)
            and isinstance(v_pool, QuantizedArray)):
        raise ValueError("paged_attention wants int8 QuantizedArray pools "
                         "(kv_quant='int8'); float pools take the gather "
                         "path, which needs no kernel")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [rows, 1, heads, head_dim] (one decode "
                         f"token per row), got {tuple(q.shape)}")
    r, _, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if pool.q.dtype != torch.int8 or pool.scale.dtype != torch.float32:
            raise TypeError(f"paged_attention: {name} must be int8 with "
                            "float32 scales")
        if pool.q.ndim != 4 or tuple(pool.q.shape[2:]) != (h, d):
            raise ValueError(f"paged_attention: {name} {tuple(pool.q.shape)}"
                             f" is not [pages, T, {h}, {d}]")
        if tuple(pool.scale.shape) != (*pool.q.shape[:3], 1):
            raise ValueError(f"paged_attention: {name} scales "
                             f"{tuple(pool.scale.shape)} are not "
                             f"{(*pool.q.shape[:3], 1)}")
    if tuple(k_pool.q.shape) != tuple(v_pool.q.shape):
        raise ValueError("paged_attention: k_pool and v_pool differ in shape")
    if page_table.ndim != 2 or page_table.shape[0] != r:
        raise ValueError(f"page_table must be [rows={r}, n_pages], got "
                         f"{tuple(page_table.shape)}")
    if lengths.ndim != 1 or lengths.shape[0] != r:
        raise ValueError(f"lengths must be [rows={r}], got "
                         f"{tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and lengths must be "
                        "int32")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {d} > {MAX_HEAD_DIM}, "
                         "the most the kernel takes")
    if r > _MAX_GRID_Y:
        raise ValueError(f"paged_attention: {r} rows exceed the kernel's "
                         "grid")
    tensors = (q, k_pool.q, k_pool.scale, v_pool.q, v_pool.scale,
               page_table, lengths)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention: tensors on different devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: tensors must be contiguous")


def decode_launch_plan(rows: int, heads: int, head_dim: int
                       ) -> tuple[int, int, int, int]:
    """``(lanes, grid_x, grid_y, threads)`` of a decode-kernel launch (this
    one and the Sq = 1 route of the masked forward): one warp per (row,
    head), a block of its own, on the grid ``(heads, rows)``; ``lanes``
    lanes share a token, each holding `DECODE_LANE_DIMS` of its dimensions
    (the power of two that covers head_dim), so a warp takes
    ``32 // lanes`` tokens at a time. The C entries compute the same
    (`dmt_paged_attention_plan`, `dmt_masked_flash_decode_plan`)."""
    lanes = 1
    while lanes * DECODE_LANE_DIMS < head_dim:
        lanes *= 2
    return (lanes, heads, rows, 32)


@functools.cache
def _entry(name: str = "dmt_paged_attention"):
    """A launch entry of the built library (`dmt_paged_attention` or its
    empty twin), loaded and typed once."""
    fn = getattr(build.load("paged_attention"), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, page_table, lengths, empty: bool = False):
    r, _, h, d = q.shape
    p, t = k_pool.q.shape[:2]
    n = page_table.shape[1]
    out = torch.empty_like(q)
    visits = torch.empty((r, h), dtype=torch.float32, device=q.device)
    if r == 0 or h == 0:
        return out, visits
    fn = _entry("dmt_paged_attention_empty" if empty else
                "dmt_paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.q.data_ptr(), k_pool.scale.data_ptr(),
                 v_pool.q.data_ptr(), v_pool.scale.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 visits.data_ptr(), r, h, d, t, p, n,
                 int(q.dtype == torch.bfloat16), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    if not empty:
        paged_attention.launches += 1
    return out, visits


def paged_attention(q, k_pool: QuantizedArray, v_pool: QuantizedArray,
                    page_table, lengths):
    """Single-token paged attention: q ``[R, 1, H, D]`` (float32 or
    bfloat16) against the int8 pools through ``page_table`` [R, n] int32;
    row r attends positions ``[0, lengths[r])``, 1 <= lengths[r] <= n*T.
    Returns ``[R, 1, H, D]`` in q's dtype. All tensors contiguous, on one
    device; requires D <= `MAX_HEAD_DIM`."""
    _check(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, page_table, lengths)[0]


paged_attention.launches = 0


def paged_attention_probe(q, k_pool: QuantizedArray, v_pool: QuantizedArray,
                          page_table, lengths):
    """`paged_attention` plus ``visits [R, H]`` f32: the pages the kernel
    entered per (row, head), ``ceil(lengths[r] / T)`` clipped to the
    table width (`paged_attention_pages`). On the CPU the visits are that
    count, computed, since no kernel runs."""
    _check(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cpu":
        out = paged_attention_reference(q, k_pool, v_pool, page_table,
                                        lengths)
        pages = torch.clamp(paged_attention_pages(lengths, k_pool.q.shape[1]),
                            max=page_table.shape[1])
        return out, pages.to(torch.float32)[:, None].expand(
            -1, q.shape[2]).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, page_table, lengths)


def paged_attention_launch_floor(q, k_pool: QuantizedArray,
                                 v_pool: QuantizedArray, page_table, lengths
                                 ) -> None:
    """Launch an empty kernel with the grid, block and arguments
    `paged_attention` would launch on these CUDA inputs: what a launch
    costs before the kernel does any work. Counts no launch; its outputs
    are never written."""
    _check(q, k_pool, v_pool, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_launch_floor: needs CUDA "
                         f"tensors, got {q.device}")
    _launch(q, k_pool, v_pool, page_table, lengths, empty=True)


def paged_attention_pages(lengths, page_tokens: int):
    """Active pages per row: ``ceil(length / T)``, the kernel's skip
    predicate (pages ``j`` with ``j*T < length``)."""
    return -(-lengths // page_tokens)


def paged_attention_cost(lengths, n_pages: int, page_tokens: int, heads: int,
                         head_dim: int) -> dict:
    """Analytic roofline inputs for one `paged_attention` call, the
    reference's `paged_attention_cost` and the bytes this kernel moves.

    ``flops``: the two products (scores and p @ V) over each row's active
    pages. ``hbm_bytes``: the reference's count, every one of the
    ``n_pages`` page tiles per (row, head) — the TPU pipeline fetches
    skipped pages too — plus q in and out back (f32) and the table and
    lengths. ``active_bytes``: what this kernel must read, the ACTIVE
    pages' int8 K and V tiles and their f32 scales, plus q in and out
    back (f32) and the table and lengths; `chip_smoke.py`'s bound uses
    this one."""
    lengths = np.asarray(lengths)
    r = len(lengths)
    active = np.minimum(paged_attention_pages(lengths, page_tokens), n_pages)
    tokens = active * page_tokens
    flops = float((2 * 2 * heads * head_dim * tokens).sum())
    page_tile = page_tokens * head_dim + page_tokens * 4  # int8 + f32 scale
    index_bytes = r * n_pages * 4 + r * 4  # table + lengths
    return {
        "flops": flops,
        "hbm_bytes": float(r * heads * n_pages * 2 * page_tile
                           + 2 * r * heads * head_dim * 4 + index_bytes),
        "active_bytes": float(int(active.sum()) * heads * 2 * page_tile
                              + 2 * r * heads * head_dim * 4
                              + index_bytes),
    }
