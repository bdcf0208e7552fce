"""Variable-length (key-prefix masked) flash attention, forward only.

Counterpart of the reference Pallas kernel
(`dist_mnist_tpu/ops/pallas/flash_attention.py`, `_masked_attn_fwd_kernel`
under `_masked_flash_fwd_impl`): q ``[B, Sq, H, D]`` against k/v
``[B, Sk, H, D]`` where row b attends only keys ``[0, lengths[b])`` —
the key-prefix masks of the decode cache (``lengths = pos + 1``) and of
zoo serving. Key blocks of `BLOCK_K` at or past a row's length do no
work. The CUDA body is `csrc/masked_flash_attention.cu` (its header says
how it is laid out and what bounds it).

`masked_flash_attention` checks its inputs, then launches the kernel for
CUDA tensors and runs `masked_flash_attention_reference` (the ``-1e30``
masked softmax einsum) for CPU tensors; it never routes a CUDA tensor
around the kernel. There is no backward yet (it comes with ViT training
as a `torch.autograd.Function`), so the wrapper refuses inputs that
require grad rather than return a silently wrong gradient.
`masked_flash_attention.launches` counts kernel launches, the probe's
included.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dist_mnist_tpu_torch.ops.kernels import build

#: keys per kernel block (one per lane of a warp): the skip granularity,
#: so a probe's visits are ``ceil(length / BLOCK_K)``
BLOCK_K = 32
#: largest head_dim the kernel takes
MAX_HEAD_DIM = 128
_MAX_GRID_YZ = 65535
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_void_p])


def masked_flash_attention_reference(q, k, v, lengths):
    """The kernel's function in plain torch: f32 scores times
    ``D**-0.5``, ``-1e30`` on keys at or past each row's length, softmax
    in f32, the weights cast to v's dtype, weights @ V, out in q's
    dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * d ** -0.5
    col = torch.arange(k.shape[1], device=q.device)
    mask = col[None, :] < lengths[:, None]  # [B, Sk]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def _check(q, k, v, lengths) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} as [B, Sk, H, D]")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"masked_flash_attention: q, k, v must be all "
                        f"float32 or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.ndim != 1 or lengths.shape[0] != b:
        raise ValueError(f"lengths must be [batch] = [{b}], got "
                         f"{tuple(lengths.shape)}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"masked_flash_attention: lengths must be int32, "
                        f"got {lengths.dtype}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("masked_flash_attention has no backward yet: "
                           "call it under torch.no_grad() or on tensors "
                           "that do not require grad")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"masked_flash_attention: head_dim {d} > "
                         f"{MAX_HEAD_DIM}, the most the kernel takes")
    if max(b, h) > _MAX_GRID_YZ:
        raise ValueError("masked_flash_attention: batch or heads exceed "
                         "the kernel's grid")
    tensors = (q, k, v, lengths)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("masked_flash_attention: tensors on different "
                         f"devices {sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_flash_attention: tensors must be "
                         "contiguous")


@functools.cache
def _entry():
    """`dmt_masked_flash_attention` of the built library, loaded and typed
    once."""
    fn = build.load("masked_flash_attention").dmt_masked_flash_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths):
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    visits = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, visits
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), visits.data_ptr(), b, sq, k.shape[1], h, d,
                 int(q.dtype == torch.bfloat16), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"masked_flash_attention kernel launch failed: "
                           f"cudaError {err}")
    masked_flash_attention.launches += 1
    return out, visits


def masked_flash_attention(q, k, v, lengths):
    """Variable-length attention: q ``[B, Sq, H, D]`` against k/v
    ``[B, Sk, H, D]`` (all float32 or all bfloat16), row b attending keys
    ``[0, lengths[b])`` (int32, 1 <= lengths[b] <= Sk). Returns
    ``[B, Sq, H, D]`` in q's dtype. All tensors contiguous, on one
    device; requires D <= `MAX_HEAD_DIM`."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return masked_flash_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k, v, lengths)[0]


masked_flash_attention.launches = 0


def masked_flash_attention_probe(q, k, v, lengths):
    """`masked_flash_attention` plus ``visits [B, H, Sq]`` f32: the key
    blocks the kernel entered per query row,
    ``masked_key_blocks(lengths, BLOCK_K)``. On the CPU the visits are
    that count, computed, since no kernel runs."""
    _check(q, k, v, lengths)
    b, sq, h, _ = q.shape
    if q.device.type == "cpu":
        out = masked_flash_attention_reference(q, k, v, lengths)
        blocks = masked_key_blocks(torch.clamp(lengths, max=k.shape[1]),
                                   BLOCK_K)
        return out, blocks.to(torch.float32)[:, None, None].expand(
            b, h, sq).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k, v, lengths)


def masked_key_blocks(lengths, block_k: int = BLOCK_K):
    """Active key blocks per batch row: ``ceil(length / block_k)``, the
    kernel's skip predicate (blocks ``kb`` with ``kb*block_k < length``)."""
    return -(-lengths // block_k)


def masked_flash_flops(lengths, sq: int, heads: int, head_dim: int,
                       block_k: int = BLOCK_K) -> float:
    """Analytic forward FLOPs at block granularity: per row, the two
    products (scores and p @ V) over ``active_blocks * block_k`` keys —
    what the kernel executes, scaling with each row's real length."""
    active = np.asarray(masked_key_blocks(np.asarray(lengths), block_k)) \
        * block_k
    return float((2 * 2 * sq * head_dim * heads * active).sum())


def masked_flash_cost(lengths, sq: int, heads: int, head_dim: int) -> dict:
    """The least work one call on f32 operands needs on these inputs: the
    two products over each row's ``lengths[b]`` keys, and the bytes of q
    in, out back, the first ``lengths[b]`` K and V rows of each (b, head),
    and the lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    b = len(lengths)
    keys = int(lengths.sum())
    return {
        "flops": float(2 * 2 * sq * head_dim * heads * keys),
        "hbm_bytes": float(2 * b * sq * heads * head_dim * 4
                           + 2 * keys * heads * head_dim * 4
                           + 4 * b),
    }
