"""Flash attention, forward and backward: ``[B, S, H, D]`` self-attention
whose score matrix never reaches device memory.

Counterpart of the reference Pallas kernels
(`dist_mnist_tpu/ops/pallas/flash_attention.py`): `_flash_fwd_impl` (the
full-K `_attn_fwd_kernel` and the streamed `_attn_fwd_kernel_kt`) and
`_flash_bwd_impl` (the dQ kernel over query tiles and the dK/dV kernel
over key tiles). The CUDA bodies are `csrc/flash_attention.cu`; its header
says how they are laid out and what bounds them. Each leaf picks its body
by dtype. bf16 takes the tensor-core (`mma.sync`) kernels: the forward's
bf16 x bf16 products are exact in their f32 accumulators, and the
backward's three products with an f32 operand (the recomputed P or dS)
split that operand into bf16 hi and lo halves, 2^-16 relative per term,
so both keep the reference's numbers. f32 takes full-precision kernels on
the CUDA cores, register-tiled as an SGEMM is: the forward over blocks
of query rows that `f32_forward_plan` picks, the dQ and dK/dV kernels
over blocks of query and key rows that `f32_backward_plan` picks. The
same kernels take Sq and Sk apart and an optional lengths vector, and
serve the masked forward at Sq > 1 (`launch_forward`) and the masked
backward (`ops/kernels/masked_flash.py`).

Public functions keep the reference's signatures and its block_k
quantization (block_q is accepted and unused: the kernels tile queries
their own way):

- `flash_attention(q, k, v)` returns ``out [B, S, H, D]`` in q's dtype;
- `flash_attention_lse(q, k, v)` returns ``(out, lse [B, H, S])``, lse in
  f32, differentiable in both (the lse cotangent folds into the backward
  as ``delta - dlse``).

Each is one `torch.autograd.Function` whose forward and backward call the
leaf functions below. A leaf launches its kernel for CUDA tensors and runs
its plain version (the ``*_reference`` functions: plain torch recompute
math) for CPU tensors, so the CPU tests drive the same autograd wiring as
the card: the saved tensors, ``delta = rowsum(f32(dO) * f32(O))`` from the
stored output, the dlse fold. A CUDA tensor never takes the plain version;
a failed build or launch raises. float64 runs the plain version only (the
kernels take f32 and bf16): `torch.autograd.gradcheck` uses it.

Rounding follows the reference's kernel selection: with ``block_k=None``
or a block_k that leaves one 128-key tile (every ViT-Tiny call: S = 65),
the full-K rule rounds the NORMALIZED probabilities to v's dtype before
the product; a block_k that leaves more tiles takes the streamed rule,
which rounds the unnormalized ones and divides at the end.

Launch counters: `flash_attention_forward.launches`,
`flash_attention_dq.launches`, `flash_attention_dkv.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dist_mnist_tpu_torch.ops.kernels import build

#: keys per step of the dQ kernels (two 16-key groups of the bf16 route;
#: the f32 route counts its keys in such steps): the dQ kernel's skip
#: granularity
TILE = 32
#: keys per warp (bf16) of the dK/dV kernel: its skip granularity (the f32
#: route skips groups of 4 keys, so every block of 16 past the length)
KEY_BLOCK = 16
#: largest head_dim the kernels take
MAX_HEAD_DIM = 128
_MAX_GRID_YZ = 65535
#: the f32 kernels' plans (csrc/flash_attention.cu `flash_fwd_f32`,
#: `flash_dq_f32`, `flash_dkv_f32`): the most rows of the other axis they
#: hold in one tile, their tile above that, and their limits on rows and
#: threads per block and on the 4 x 4 output tiles a thread owns
ONE_PASS_KEYS, F32_KEY_TILE = 128, 64
#: the bf16 forward's plan: warps of 16 query rows a block, at most, and
#: its key tile above `ONE_PASS_KEYS`
MMA_MAX_WARPS, KEY_TILE = 8, 64
F32_MAX_ROWS, F32_MAX_THREADS, F32_OUT_TILES = 64, 256, 2
#: the blocks the f32 kernels aim for: two per SM of the H100 SXM. A
#: constant of the design, never read from the device
F32_TARGET_BLOCKS = 264
#: the dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
_NEG = -1e30
_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_FWD_ARGTYPES = [_VP] * 7 + [_I] * 5 + [_LL] * 6 + [_I] * 3 + [_F, _VP]
_ARGTYPES = {
    "dmt_flash_attention_fwd": _FWD_ARGTYPES,
    "dmt_flash_attention_fwd_empty": _FWD_ARGTYPES,
    "dmt_flash_forward_plan": [_I] * 6 + [_VP],
    "dmt_flash_attention_dq": [_VP] * 9 + [_I] * 5 + [_LL] * 6
    + [_I, _F, _VP],
    "dmt_flash_attention_dkv": [_VP] * 10 + [_I] * 5 + [_LL] * 6
    + [_I, _F, _VP],
    "dmt_flash_aligned16": [_VP, _LL, _LL, _LL, _I],
    "dmt_flash_f32_backward_plan": [_I] * 5 + [_VP],
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def quantize_block_k(block_k: int | None, s: int) -> int | None:
    """The reference's `_quantize_block_k`: None (the full-K rule) unless
    the 128-aligned block_k leaves more than one tile of keys."""
    if block_k is None:
        return None
    bk = min(_round_up(block_k, 128), _round_up(s, 128))
    return bk if _round_up(s, bk) // bk > 1 else None


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# plain versions


def _scores(q, k, lengths=None):
    """``[B, H, Sq, Sk]`` logits in f32 (f64 for f64 inputs), times
    ``D**-0.5``, ``-1e30`` at keys at or past each row's length."""
    acc = _acc_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) \
        * q.shape[-1] ** -0.5
    if lengths is not None:
        col = torch.arange(k.shape[1], device=q.device)
        keep = col[None, :] < lengths.to(q.device)[:, None]
        s = torch.where(keep[:, None, None, :], s,
                        torch.full((), _NEG, dtype=acc, device=q.device))
    return s


def flash_attention_forward_reference(q, k, v, block_k: int | None = None,
                                      lengths=None):
    """The forward kernel's function in plain torch: ``(out [B, Sq, H, D]
    in q's dtype, lse [B, H, Sq] f32)``. ``block_k=None``: the full-K rule
    (normalized p rounded to v's dtype); otherwise the streamed rule over
    key tiles of block_k (unnormalized p rounded, ``acc / l`` at the
    end). With `lengths`, keys at or past each row's length score
    ``-1e30``: a tile wholly past the length then adds exactly nothing,
    as a tile the reference's masked kernel skips."""
    acc = _acc_dtype(q)
    s = _scores(q, k, lengths)
    vf = v.to(acc)
    if block_k is None:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        w = (p / l).to(v.dtype).to(acc)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vf)
        lse = (m + torch.log(l))[..., 0]
    else:
        b, sq, h, d = q.shape
        m = torch.full((b, h, sq), _NEG, dtype=acc, device=q.device)
        l = torch.zeros((b, h, sq), dtype=acc, device=q.device)
        o = torch.zeros((b, h, sq, d), dtype=acc, device=q.device)
        for k0 in range(0, k.shape[1], block_k):
            st = s[..., k0:k0 + block_k]
            m_cur = torch.maximum(m, st.amax(-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(st - m_cur[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).to(acc),
                vf[:, k0:k0 + block_k])
            m = m_cur
        out = (o / l[..., None]).permute(0, 2, 1, 3)
        lse = m + torch.log(l)
    return out.to(q.dtype), lse.contiguous()


def flash_attention_backward_reference(q, k, v, do, lse, delta,
                                       lengths=None):
    """The dQ and dK/dV kernels' function in plain torch, from the
    forward's lse and ``delta`` ``[B, H, Sq]``: ``(dq, dk, dv)`` in the
    inputs' dtypes. With `lengths`, keys at or past each row's length get
    probability exactly 0, so their dk and dv are exact zeros."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, lengths) - lse.to(acc)[..., None])
    if lengths is not None:
        col = torch.arange(k.shape[1], device=q.device)
        keep = col[None, :] < lengths.to(q.device)[:, None]
        p = torch.where(keep[:, None, None, :], p,
                        torch.zeros((), dtype=acc, device=q.device))
    dof = do.to(acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.to(acc))
    ds = p * (dp - delta.to(acc)[..., None])
    scale = q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# checks and launches


def check_qkv(name: str, q, k, v) -> None:
    """Raise on what the forward kernel (and its plain version) does not
    take: q, k, v ``[B, S, H, D]``, all f32 or all bf16 (float64 on the
    CPU), one device, unit stride along D, D <= `MAX_HEAD_DIM`."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} as [B, Sk, H, D]")
    if k.shape[1] != sq:
        raise ValueError(f"{name}: self-attention wants Sq == Sk, got "
                         f"{sq} and {k.shape[1]}")
    dtypes = (torch.float32, torch.bfloat16) + (
        (torch.float64,) if q.device.type == "cpu" else ())
    if q.dtype not in dtypes or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k, v must be all float32 or all "
                        f"bfloat16 (float64 on the CPU), got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} > {MAX_HEAD_DIM}, the most "
                         "the kernels take")
    if max(b, h) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch or heads exceed the kernels' grid")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: tensors on different devices "
                         f"{sorted({str(t.device) for t in (q, k, v)})}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v need unit stride along D")
    if q.device.type == "cuda" and k.stride() != v.stride():
        raise ValueError(f"{name}: the kernels read k and v with one set of "
                         f"strides (the views of one fused projection "
                         f"share theirs), got {k.stride()} and {v.stride()}")


@functools.cache
def _entry(symbol: str):
    """A function of the built library, loaded and typed once."""
    fn = getattr(build.load("flash_attention"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _strides(t) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels are instantiated for: 16, 32, 64 or 128."""
    return next(p for p in (16, 32, 64, 128) if d <= p)


def _f32_plan(b: int, own: int, other: int, h: int, d: int, smem=None,
              per: int = F32_OUT_TILES) -> tuple[int, int, int]:
    """``(rows, tile, threads)`` of an f32 kernel that owns `own` rows of
    each (b, h) and walks `other` rows of the other axis: that axis in one
    tile up to `ONE_PASS_KEYS` (rounded up to 4), tiles of `F32_KEY_TILE`
    above; the owned rows split into groups of `rows` (a multiple of 4, at
    most `F32_MAX_ROWS`), enough groups that the grid reaches
    `F32_TARGET_BLOCKS` (none under 16 rows), then `rows` cut by 4 while
    the output needs more 4 x 4 tiles than `F32_MAX_THREADS` threads of
    `per` tiles hold or `smem(rows, tile, d)` exceeds `SMEM_LIMIT`;
    threads enough for one 4 x 4 tile of scores each and `per` tiles of
    the output, in whole warps, 64 to `F32_MAX_THREADS`. A function of
    the shape alone."""
    tile = _round_up(max(other, 1), 4) if other <= ONE_PASS_KEYS \
        else F32_KEY_TILE
    groups = max(-(-own // F32_MAX_ROWS),
                 min(-(-own // 16), -(-F32_TARGET_BLOCKS // (b * h))))
    rows = _round_up(-(-own // groups), 4)
    dims = padded_head_dim(d) // 4
    while smem is not None and rows > 4 and (
            rows // 4 * dims > per * F32_MAX_THREADS
            or smem(rows, tile, d) > SMEM_LIMIT):
        rows -= 4
    tiles = max(rows // 4 * (tile // 4), -(-(rows // 4) * dims // per))
    return rows, tile, min(F32_MAX_THREADS, max(64, _round_up(tiles, 32)))


def f32_forward_smem(rows: int, tile: int, d: int) -> int:
    """Shared-memory bytes of one f32 forward block: its query rows and a K
    and a V tile, padded to the head dim's `padded_head_dim` + 4 floats;
    the scores (rows of the tile + 4 floats) and three statistics per
    row."""
    pitch = padded_head_dim(d) + 4
    return 4 * ((rows + 2 * tile) * pitch + rows * (tile + 4) + 3 * rows)


def f32_forward_plan(b: int, sq: int, sk: int, h: int,
                     d: int) -> tuple[int, int, int]:
    """``(rows, key_tile, threads)`` of the f32 forward for q ``[b, sq, h,
    d]`` against k and v ``[b, sk, h, d]`` (`_f32_plan` over query rows
    against the keys, held to `SMEM_LIMIT`, which its block always
    meets)."""
    return _f32_plan(b, sq, sk, h, d, f32_forward_smem)


def forward_plan(b: int, sq: int, sk: int, h: int, d: int,
                 dtype: torch.dtype) -> tuple[int, ...]:
    """The forward's launch for q ``[b, sq, h, d]`` against k and v ``[b,
    sk, h, d]``: ``(grid_x, grid_y, grid_z, threads, smem_bytes, rows,
    key_tile)``, the query rows a block owns and the keys it stages at a
    time. bf16: blocks of ceil(sq / 16) warps up to 8 (128 rows), every
    key (padded to 16) up to `ONE_PASS_KEYS`, tiles of `KEY_TILE` above;
    f32: `f32_forward_plan`. The C entry point computes the same plan
    (`dmt_flash_forward_plan`)."""
    if dtype == torch.bfloat16:
        warps = min(MMA_MAX_WARPS, -(-sq // 16))
        rows = 16 * warps
        tile = _round_up(sk, 16) if sk <= ONE_PASS_KEYS else KEY_TILE
        smem = 2 * (padded_head_dim(d) + 8) * (rows + 2 * tile)
        return -(-sq // rows), h, b, 32 * warps, smem, rows, tile
    rows, tile, threads = f32_forward_plan(b, sq, sk, h, d)
    return (-(-sq // rows), h, b, threads, f32_forward_smem(rows, tile, d),
            rows, tile)


def forward_body(sk: int, dtype: torch.dtype) -> str:
    """The CUDA kernel the forward runs against `sk` keys in `dtype`."""
    if dtype == torch.bfloat16:
        return ("flash_fwd_mma_onepass" if sk <= ONE_PASS_KEYS
                else "flash_fwd_mma_tiled")
    return "flash_fwd_f32"


def f32_backward_smem(kernel: str, rows: int, tile: int, d: int) -> int:
    """Shared-memory bytes of one block of the f32 ``"dq"`` or ``"dkv"``
    kernel: its rows and the other axis's tile, both padded to the head
    dim's `padded_head_dim` + 4 floats; dS (and P^T in dK/dV) with rows
    of 4 more than a multiple of 8 floats (the tile, plus 4 where it is a
    multiple of 8); and two statistics (lse, delta) per query row held."""
    pitch = padded_head_dim(d) + 4
    pp = tile + 4 if tile % 8 == 0 else tile
    dkv = kernel == "dkv"
    return 4 * ((2 * rows + 2 * tile) * pitch + (2 if dkv else 1) * rows
                * pp + 2 * (tile if dkv else rows))


def f32_backward_plan(b: int, sq: int, sk: int, h: int, d: int):
    """The f32 backward's plans, ``((rows, key_tile, threads) of dQ,
    (rows, query_tile, threads) of dK/dV)``: `_f32_plan` over query rows
    against the keys (up to `F32_OUT_TILES` output tiles a thread) and
    over key rows against the queries (one tile of dK and one of dV a
    thread), each block held to `SMEM_LIMIT`. The C entry points compute
    the same plans (`dmt_flash_f32_backward_plan`)."""
    return (_f32_plan(b, sq, sk, h, d,
                      functools.partial(f32_backward_smem, "dq")),
            _f32_plan(b, sk, sq, h, d,
                      functools.partial(f32_backward_smem, "dkv"), per=1))


def views_aligned16(*ts) -> bool:
    """Whether the forward may stage these ``[B, S, H, D]`` views by
    16-byte copies: every base pointer and every row stride (B, S, H, and
    D itself) a whole number of 16 bytes. Otherwise it stages them by
    plain loads (its VEC = false instantiations), never the plain
    version. The bf16 backward's C entry points decide by the same rule for
    each operand (`dmt_flash_aligned16`)."""
    return all(t.data_ptr() % 16 == 0 and all(
        n * t.element_size() % 16 == 0 for n in (*_strides(t), t.shape[-1]))
        for t in ts)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def launch_dq(q, k, v, do, lse, delta, lengths=None, visits=None):
    """Launch the dQ kernel (bf16: `flash_dq_mma`, f32: `flash_dq_f32`):
    ``dq`` like q (contiguous). `k` and `v` with one
    set of strides; `do` contiguous like q; `lse`, `delta` contiguous
    ``[B, H, Sq]`` f32; optional int32 `lengths` ``[B]`` and f32 ``visits
    [B, H, Sq]`` (steps of `TILE` keys each query row entered). Both
    kernels stage by 16-byte copies where `views_aligned16` would, and by
    plain loads elsewhere (decided in the C entry point); the f32 kernel
    runs by `f32_backward_plan`."""
    b, sq, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry("dmt_flash_attention_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if lengths is None else lengths.data_ptr(), dq.data_ptr(),
            None if visits is None else visits.data_ptr(), b, sq,
            k.shape[1], h, d, *_strides(q), *_strides(k),
            int(q.dtype == torch.bfloat16), d ** -0.5, _stream(q))
    _raise_on(err, "flash attention dQ")
    return dq


def launch_dkv(q, k, v, do, lse, delta, lengths=None, visits=None):
    """Launch the dK/dV kernel (bf16: `flash_dkv_mma`, f32:
    `flash_dkv_f32`): ``(dk, dv)`` like k and v (contiguous). Optional
    f32 ``visits [B, H, ceil(Sk / KEY_BLOCK)]``: 1 for each key block the
    kernel entered, 0 for one it skipped."""
    b, sq, h, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = _entry("dmt_flash_attention_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if lengths is None else lengths.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if visits is None else visits.data_ptr(), b,
            sq, k.shape[1], h, d, *_strides(q), *_strides(k),
            int(q.dtype == torch.bfloat16), d ** -0.5, _stream(q))
    _raise_on(err, "flash attention dK/dV")
    return dk, dv


def launch_forward(q, k, v, *, normalized: bool = True, lengths=None,
                   empty: bool = False):
    """One launch of the forward entry point (with `empty`, of its empty
    twin: the same grid, block and shared memory, nothing written) on
    CUDA tensors: ``(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32,
    visits)``. q ``[B, Sq, H, D]`` against k and v ``[B, Sk, H, D]`` (one
    set of strides); `normalized` picks the full-K rounding rule, else the
    streamed one; optional int32 `lengths` ``[B]`` masks each row's keys at
    and past its length (the masked forward: streamed), and then visits
    ``[B, H, Sq]`` f32 holds the steps of `TILE` keys each query row
    entered (None without lengths). The kernel runs by `forward_plan`; it
    stages by 16-byte copies where `views_aligned16` allows. Counts
    nothing: the callers count their launches."""
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    visits = (None if lengths is None else
              torch.empty((b, h, sq), dtype=torch.float32, device=q.device))
    if out.numel() == 0:
        return out, lse, visits
    entry = _entry("dmt_flash_attention_fwd_empty" if empty
                   else "dmt_flash_attention_fwd")
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if visits is None else visits.data_ptr(), b,
            sq, k.shape[1], h, d, *_strides(q), *_strides(k),
            int(q.dtype == torch.bfloat16), int(normalized),
            int(views_aligned16(q, k, v)), d ** -0.5, _stream(q))
    _raise_on(err, "flash attention forward")
    return out, lse, visits


# ---------------------------------------------------------------------------
# leaf functions: the kernel for CUDA tensors, the plain version for CPU ones


def flash_attention_forward(q, k, v, block_k: int | None = None):
    """``(out [B, S, H, D], lse [B, H, S] f32)``; `block_k` already
    quantized (`quantize_block_k`): None selects the full-K rounding."""
    check_qkv("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, block_k)
    out, lse, _ = launch_forward(q, k, v, normalized=block_k is None)
    if out.numel():
        flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


def flash_attention_dq(q, k, v, do, lse, delta):
    """dQ of unmasked self-attention from the forward's lse and delta."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do, lse,
                                                  delta)[0]
    if q.numel() == 0:
        return torch.empty_like(q)
    dq = launch_dq(q, k, v, do.contiguous(), lse, delta)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta):
    """(dK, dV) of unmasked self-attention from the forward's lse and
    delta."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do, lse,
                                                  delta)[1:]
    if q.numel() == 0:
        return torch.empty_like(k), torch.empty_like(v)
    dk, dv = launch_dkv(q, k, v, do.contiguous(), lse, delta)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def attention_delta(out, dout, dlse=None):
    """``delta [B, H, S]`` = rowsum(f32(dO) * f32(O)) from the stored
    output in its own dtype, minus the lse cotangent when there is one (the
    reference computes it in XLA, outside its kernels)."""
    acc = _acc_dtype(out)
    delta = (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    return delta.contiguous()


# ---------------------------------------------------------------------------
# autograd


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); backward by recompute from (q, k, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, block_k):
        out, lse = flash_attention_forward(q, k, v, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(out, dout)
        dq = flash_attention_dq(q, k, v, dout, lse, delta)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta)
        return dq, dk, dv, None


class _FlashAttentionLSE(torch.autograd.Function):
    """(out, lse) = attention(q, k, v); the lse cotangent folds into
    delta."""

    @staticmethod
    def forward(ctx, q, k, v, block_k):
        out, lse = flash_attention_forward(q, k, v, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(out, dout, dlse)
        dq = flash_attention_dq(q, k, v, dout, lse, delta)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, block_q: int = 128,
                    block_k: int | None = None):
    """``[B, S, H, D]`` self-attention (non-causal), differentiable: the
    reference's `flash_attention`. `block_q` is accepted for the
    reference's signature only: the kernels tile queries their own way.
    `block_k` selects the rounding rule (see the module docstring)."""
    del block_q
    return _FlashAttention.apply(q, k, v,
                                 quantize_block_k(block_k, q.shape[1]))


def flash_attention_lse(q, k, v, *, block_q: int = 128,
                        block_k: int | None = None):
    """`flash_attention` that also returns ``lse [B, H, S]`` f32, the
    merge-ready pair of blockwise attention; differentiable in both.
    `block_q` is accepted for the reference's signature only."""
    del block_q
    return _FlashAttentionLSE.apply(q, k, v,
                                    quantize_block_k(block_k, q.shape[1]))


# ---------------------------------------------------------------------------
# cost


def flash_attention_cost(b: int, s: int, h: int, d: int,
                         dtype: torch.dtype) -> dict:
    """The work of one forward and one backward (dQ + dK/dV) call on these
    shapes. FLOPs are those of the products the function needs, keyed by
    the type of their operands, since that type sets the card's peak for
    them. Forward: QK^T and PV, both in the inputs' dtype (P is rounded to
    v's dtype). Backward: QK^T and dO V^T in the inputs' dtype, and dV =
    P^T dO, dQ = dS K and dK = dS^T Q with an f32 operand (the recomputed P,
    dS). ``bwd_split_flops`` counts the products the backward kernels
    themselves run (`backward_design_flops`), keyed the same way. Bytes:
    every input read once and every output written once
    (forward: q, k, v in, out and the f32 lse back; backward: q, k, v, dO,
    lse and delta in, dq, dk, dv back)."""
    el = torch.tensor([], dtype=dtype).element_size()
    mat = b * s * h * d * el
    vec = b * h * s * 4
    macs = b * h * s * s * d
    return {
        "fwd_flops": attention_flops_by_type(macs, dtype, 2, 0),
        "fwd_bytes": float(4 * mat + vec),
        "bwd_flops": attention_flops_by_type(macs, dtype, 2, 3),
        "bwd_split_flops": backward_design_flops(macs, dtype),
        "bwd_bytes": float(4 * mat + 2 * vec + 3 * mat),
    }


def backward_design_flops(macs: float, dtype: torch.dtype) -> dict:
    """FLOPs the backward kernels run for `macs` multiply-adds per
    product, keyed by operand type. Each of the dQ and dK/dV kernels
    recomputes QK^T and dO V^T. bf16 runs those four on bf16 operands and
    each of the three f32-operand products twice, as bf16 hi and lo
    halves: ten products at the bf16 rate. f32 runs the seven in f32."""
    if dtype == torch.bfloat16:
        return {"bfloat16": float(2 * macs * (4 + 2 * 3))}
    return {"float32": float(2 * macs * 7)}


def attention_flops_by_type(macs: float, dtype: torch.dtype, n_in: int,
                            n_f32: int) -> dict:
    """FLOPs keyed by operand type: `n_in` products of `macs`
    multiply-adds each whose operands are in `dtype`, and `n_f32` whose
    operands include an f32 one."""
    name = str(dtype).removeprefix("torch.")
    out = {name: float(2 * macs * n_in)}
    out["float32"] = out.get("float32", 0.0) + float(2 * macs * n_f32)
    return {k: v for k, v in out.items() if v}
