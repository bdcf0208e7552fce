"""Variable-length (key-prefix masked) flash attention, forward and
backward.

Counterpart of the reference Pallas kernel
(`dist_mnist_tpu/ops/pallas/flash_attention.py`, `_masked_attn_fwd_kernel`
under `_masked_flash_fwd_impl`): q ``[B, Sq, H, D]`` against k/v
``[B, Sk, H, D]`` where row b attends only keys ``[0, lengths[b])`` —
the key-prefix masks of the decode cache (``lengths = pos + 1``) and of
zoo serving. Key blocks of `BLOCK_K` at or past a row's length do no
work. The forward has two routes (`masked_forward_body`): Sq = 1, the
decode step, runs `csrc/masked_flash_attention.cu` (a warp per (b, h),
as `paged_attention` does; its header says how it is laid out and what
bounds it); Sq > 1 runs the flash forward kernels of
`csrc/flash_attention.cu` with the lengths vector and the streamed rule
(`flash_attention.launch_forward`: bf16 on the tensor cores, one pass up
to 128 keys and key tiles above, f32 register-tiled on the CUDA cores),
a block of query rows staging K and V once.

The backward (the reference's `_masked_flash_bwd_impl`) runs the dQ and
dK/dV kernels of `csrc/flash_attention.cu` with the lengths vector (bf16:
the tensor-core `flash_dq_mma` and `flash_dkv_mma`; f32: the FMA
kernels): key steps and blocks at or past a row's length do no work, and
dK and dV there are exact zeros. ``delta = rowsum(f32(dO) * f32(O))`` has no lse term here.

`masked_flash_attention` checks its inputs. When a gradient is wanted it
runs `_MaskedFlashAttention` (forward with the f32 lse saved, backward as
above); otherwise only the forward, which writes no lse at Sq = 1 (the
decode step).
Each leaf launches its kernel for CUDA tensors and runs its plain version
for CPU tensors (`masked_flash_attention_reference`, the reference's
streamed softmax over 128-key blocks under the ``-1e30`` mask, and
`flash_attention_backward_reference`); it never routes
a CUDA tensor around a kernel. `masked_flash_attention.launches` counts
forward launches, the probe's included, on both of the forward's routes
(the flash forward's own counter, `flash_attention_forward.launches`,
counts none of them); `masked_flash_attention_launch_floor` launches an
empty kernel of the route's grid, block and shared memory, for timing
what a launch costs;
`masked_flash_attention_backward.launches` counts the backward's kernel
launches (two per backward: dQ, then dK/dV).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dist_mnist_tpu_torch.ops.kernels import build
from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa

#: keys per visit of either route (a lane's key of a warp at Sq = 1, the
#: flash forward's step of `fa.TILE` keys above): the skip granularity,
#: so a probe's visits are ``ceil(length / BLOCK_K)``
BLOCK_K = 32
#: the reference's key block (`masked_flash_attention`'s ``block_k``, 128
#: for every Sk): the plain version streams over it. The one-pass kernel
#: (Sk <= 128) holds every key in one tile, the reference's one block; the
#: tiled bf16 kernel (Sk > 128) rescales every `fa.KEY_TILE` (64) keys, a
#: stated departure from it
REFERENCE_BLOCK_K = 128
#: largest head_dim the kernel takes
MAX_HEAD_DIM = 128
_MAX_GRID_YZ = 65535
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_void_p])


def masked_flash_attention_forward_reference(q, k, v, lengths):
    """The forward kernel's function in plain torch, by the reference's
    rule (`_masked_attn_fwd_kernel`: the streamed online softmax over
    key blocks of `REFERENCE_BLOCK_K`): f32 scores (f64 for f64 inputs)
    times ``D**-0.5``, ``-1e30`` on keys at or past each row's length, a
    running max, the unnormalized ``p = exp(s - m)`` cast to v's dtype
    before ``p @ V``, one division by the running sum at the end, out in
    q's dtype; and ``lse [B, H, Sq]``, the masked scores' log-sum-exp."""
    return fa.flash_attention_forward_reference(
        q, k, v, block_k=REFERENCE_BLOCK_K, lengths=lengths)


def masked_flash_attention_reference(q, k, v, lengths):
    """`masked_flash_attention_forward_reference`'s output alone."""
    return masked_flash_attention_forward_reference(q, k, v, lengths)[0]


def _check(q, k, v, lengths) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} as [B, Sk, H, D]")
    dtypes = (torch.float32, torch.bfloat16) + (
        (torch.float64,) if q.device.type == "cpu" else ())
    if q.dtype not in dtypes or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"masked_flash_attention: q, k, v must be all "
                        f"float32 or all bfloat16 (float64 on the CPU), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.ndim != 1 or lengths.shape[0] != b:
        raise ValueError(f"lengths must be [batch] = [{b}], got "
                         f"{tuple(lengths.shape)}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"masked_flash_attention: lengths must be int32, "
                        f"got {lengths.dtype}")
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


def masked_forward_body(sq: int, sk: int, dtype: torch.dtype) -> str:
    """The CUDA kernel the forward runs for ``sq`` query rows against
    ``sk`` keys in `dtype`: the decode kernel at Sq = 1 (launched as
    `paged_attention.decode_launch_plan` says), above it the flash
    forward's (`flash_attention.forward_body`: `flash_fwd_mma_onepass` for
    bf16 up to 128 keys, `flash_fwd_mma_tiled` above, `flash_fwd_f32` for
    f32), launched as `flash_attention.forward_plan` says."""
    return ("masked_flash_decode_kernel" if sq == 1
            else fa.forward_body(sk, dtype))


@functools.cache
def _entry(name: str = "dmt_masked_flash_attention"):
    """A launch entry of the built library (`dmt_masked_flash_attention`
    or its empty twin), loaded and typed once."""
    fn = getattr(build.load("masked_flash_attention"), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths, with_lse: bool = False, empty: bool = False):
    """(out, visits, lse or None) from one forward launch (with `empty`,
    of the empty kernel: nothing is written or counted). Sq > 1 takes the
    flash forward entry, which always writes the lse."""
    b, sq, h, d = q.shape
    if sq > 1:
        out, lse, visits = fa.launch_forward(q, k, v, normalized=False,
                                             lengths=lengths, empty=empty)
        if out.numel() and not empty:
            masked_flash_attention.launches += 1
        return out, visits, lse
    out = torch.empty_like(q)
    visits = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, visits, lse
    fn = _entry("dmt_masked_flash_attention_empty" if empty else
                "dmt_masked_flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), visits.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, k.shape[1],
                 h, d, int(q.dtype == torch.bfloat16), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"masked_flash_attention kernel launch failed: "
                           f"cudaError {err}")
    if not empty:
        masked_flash_attention.launches += 1
    return out, visits, lse


def masked_flash_attention_launch_floor(q, k, v, lengths) -> None:
    """Launch an empty kernel with the grid, block, shared memory and
    arguments the forward would launch on these CUDA inputs: what a
    launch costs before the kernel does any work. Counts no launch."""
    _check(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention_launch_floor: needs CUDA "
                         f"tensors, got {q.device}")
    _launch(q, k, v, lengths, empty=True)


def _device_check(q) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_flash_attention: unsupported device "
                         f"{q.device}")


def masked_flash_attention_forward(q, k, v, lengths):
    """Leaf forward for the backward's sake: ``(out, lse [B, H, Sq]
    f32)``."""
    if q.device.type == "cpu":
        return masked_flash_attention_forward_reference(q, k, v, lengths)
    out, _, lse = _launch(q, k, v, lengths, with_lse=True)
    return out, lse


def masked_flash_attention_backward(q, k, v, lengths, do, lse, delta):
    """Leaf backward: ``(dq, dk, dv)`` from the forward's lse and
    ``delta [B, H, Sq]`` (the dQ and dK/dV kernels with the lengths)."""
    if q.device.type == "cpu":
        return fa.flash_attention_backward_reference(q, k, v, do, lse, delta,
                                                     lengths)
    if q.numel() == 0 or k.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    do = do.contiguous()
    dq = fa.launch_dq(q, k, v, do, lse, delta, lengths)
    masked_flash_attention_backward.launches += 1
    dk, dv = fa.launch_dkv(q, k, v, do, lse, delta, lengths)
    masked_flash_attention_backward.launches += 1
    return dq, dk, dv


masked_flash_attention_backward.launches = 0


class _MaskedFlashAttention(torch.autograd.Function):
    """out = masked attention(q, k, v, lengths); backward by recompute
    from (q, k, lse) with the same skipping."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        out, lse = masked_flash_attention_forward(q, k, v, lengths)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        delta = fa.attention_delta(out, dout)
        return (*masked_flash_attention_backward(q, k, v, lengths, dout, lse,
                                                 delta), None)


def masked_flash_attention(q, k, v, lengths):
    """Variable-length attention: q ``[B, Sq, H, D]`` against k/v
    ``[B, Sk, H, D]`` (all float32 or all bfloat16), row b attending keys
    ``[0, lengths[b])`` (int32, 1 <= lengths[b] <= Sk). Returns
    ``[B, Sq, H, D]`` in q's dtype, differentiable in q, k and v. All
    tensors contiguous, on one device; requires D <= `MAX_HEAD_DIM`."""
    _check(q, k, v, lengths)
    _device_check(q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MaskedFlashAttention.apply(q, k, v, lengths)
    if q.device.type == "cpu":
        return masked_flash_attention_reference(q, k, v, lengths)
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
    _device_check(q)
    return _launch(q, k, v, lengths)[:2]


def masked_flash_attention_backward_probe(q, k, v, lengths, do):
    """One masked forward and backward on `do` with the blocks each
    backward kernel entered: ``(dq, dk, dv, dq_visits [B, H, Sq],
    dkv_visits [B, H])``. dq_visits counts the steps of `fa.TILE` keys the
    dQ kernel entered per query row, ``ceil(length / TILE)``; dkv_visits
    the key blocks of `fa.KEY_BLOCK` the dK/dV kernel entered per (row,
    head), ``ceil(length / KEY_BLOCK)``. On the CPU they are those counts,
    computed, since no kernel runs."""
    _check(q, k, v, lengths)
    _device_check(q)
    b, sq, h, _ = q.shape
    out, lse = masked_flash_attention_forward(q, k, v, lengths)
    delta = fa.attention_delta(out, do)
    lens = torch.clamp(lengths, max=k.shape[1])
    if q.device.type == "cpu":
        dq, dk, dv = masked_flash_attention_backward(q, k, v, lengths, do,
                                                     lse, delta)
        dq_vis = masked_key_blocks(lens, fa.TILE).to(torch.float32)
        dkv_vis = masked_key_blocks(lens, fa.KEY_BLOCK).to(torch.float32)
        return (dq, dk, dv,
                dq_vis[:, None, None].expand(b, h, sq).contiguous(),
                dkv_vis[:, None].expand(b, h).contiguous())
    do = do.contiguous()
    dq_vis = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    blocks = -(-k.shape[1] // fa.KEY_BLOCK)
    dkv_vis = torch.empty((b, h, blocks), dtype=torch.float32,
                          device=q.device)
    dq = fa.launch_dq(q, k, v, do, lse, delta, lengths, dq_vis)
    masked_flash_attention_backward.launches += 1
    dk, dv = fa.launch_dkv(q, k, v, do, lse, delta, lengths, dkv_vis)
    masked_flash_attention_backward.launches += 1
    return dq, dk, dv, dq_vis, dkv_vis.sum(-1)


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


def masked_flash_cost(lengths, sq: int, heads: int, head_dim: int,
                      itemsize: int = 4) -> dict:
    """The least work one call needs on these inputs, operands of
    ``itemsize`` bytes (4: f32, 2: bf16): the two products over each row's
    ``lengths[b]`` keys, and the bytes of q in, out back, the first
    ``lengths[b]`` K and V rows of each (b, head), and the lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    b = len(lengths)
    keys = int(lengths.sum())
    return {
        "flops": float(2 * 2 * sq * head_dim * heads * keys),
        "hbm_bytes": float(2 * b * sq * heads * head_dim * itemsize
                           + 2 * keys * heads * head_dim * itemsize
                           + 4 * b),
    }
