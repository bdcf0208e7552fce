"""One-pass Adam updates, for one parameter leaf or for every leaf of a
step in one launch.

Counterparts of the reference Pallas kernels
(`dist_mnist_tpu/ops/pallas/fused_adam.py`): `fused_adam_update`
(`_adam_kernel`) and `fused_adam_clip_wd_update` (`_adam_clip_wd_kernel`).
Per element, with eps outside the square root (TF's convention)::

    g     = g * clip_scale                     # clip_wd only
    m'    = b1*m + (1-b1)*g
    v'    = b2*v + (1-b2)*g*g
    delta = -lr_t*m' / (sqrt(v') + eps) - lr_wd*p   # lr_wd*p: clip_wd only

Each returns new ``(delta, m', v')`` tensors, as the JAX functions return
new arrays. The per-step scalars are device tensors (`lr_t` f32 of one
element; `scalars` f32 ``[lr_t, clip_scale, lr*wd]``), never host
floats, so a step does not wait on the device. The CUDA body is
`csrc/fused_adam.cu`; its header says what bounds it and how it rounds.

The ``*_leaves`` functions update a list of leaves in one launch (one per
table of `TABLE_LEAVES` leaves, `adam_leaf_plan`): the outputs are views
of one flat f32 buffer each for delta, m' and v', every leaf starting on
a multiple of 4 elements. The one-leaf functions are the TPU functions'
counterparts and run the same kernel as a table of one leaf.

Each wrapper checks its inputs, then launches the kernel for CUDA tensors
and runs the plain version beside it (the same math in torch, leaf by
leaf) for CPU tensors; it never routes a CUDA tensor around the kernel.
`fused_adam_update.launches` and `fused_adam_clip_wd_update.launches`
count kernel launches, of the one-leaf and the leaves functions alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dist_mnist_tpu_torch.ops.kernels import build

#: elements one block of the kernel takes (256 threads x 4 float4)
CHUNK = 4096
#: leaves one launch's table holds, and the table's bytes
#: (`csrc/fused_adam.cu` `Table`: 56 bytes a leaf and the count, padded to
#: 8); with its four pointers and five f32 constants a launch's parameters
#: stay under the 4 KB a launch may take
TABLE_LEAVES = 64
TABLE_BYTES = 56 * TABLE_LEAVES + 8
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C entry points of `csrc/fused_adam.cu` and their arguments: the
#: leaf table (host int64s), its leaves and chunks, the scalars and the
#: three outputs, the five f32 constants, clip_wd, the stream
_ARGTYPES = {
    "dmt_fused_adam_leaves": [_VP, _I, _I] + [_VP] * 4 + [_F] * 5
    + [_I, _VP],
    "dmt_fused_adam_table_bytes": [],
}


def fused_adam_update_reference(grad, m, v, lr_t, *, b1=0.9, b2=0.999,
                                eps=1e-8):
    """The kernel's math in plain torch, one rounding per operation, in
    the order of the reference's expressions."""
    lr_t = lr_t.reshape(())
    m2 = b1 * m + (1 - b1) * grad
    v2 = b2 * v + (1 - b2) * grad * grad
    return -lr_t * m2 / (torch.sqrt(v2) + eps), m2, v2


def fused_adam_clip_wd_update_reference(grad, m, v, param, scalars, *,
                                        b1=0.9, b2=0.999, eps=1e-8):
    """`fused_adam_update_reference` with the clip scale on g before the
    moments and the decoupled `- lr*wd*param` on delta."""
    lr_t, clip_scale, lr_wd = scalars[0], scalars[1], scalars[2]
    delta, m2, v2 = fused_adam_update_reference(grad * clip_scale, m, v, lr_t,
                                                b1=b1, b2=b2, eps=eps)
    return delta - lr_wd * param, m2, v2


def _leafwise(reference, groups, *scalars, **consts):
    """`reference` on each leaf's (g, m, v[, p]) in turn: (deltas, ms, vs)
    lists."""
    outs = [reference(*group, *scalars, **consts) for group in groups]
    return tuple(list(x) for x in zip(*outs)) if outs else ([], [], [])


def fused_adam_update_leaves_reference(grads, ms, vs, lr_t, *, b1=0.9,
                                       b2=0.999, eps=1e-8):
    """`fused_adam_update_leaves`' plain version: the one-leaf plain
    version leaf by leaf, on any device."""
    return _leafwise(fused_adam_update_reference, zip(grads, ms, vs), lr_t,
                     b1=b1, b2=b2, eps=eps)


class AdamLeafPlan(NamedTuple):
    """Where a launch over leaves puts each leaf: `offsets` (elements into
    the flat output buffers, multiples of 4), `total` (the buffers'
    length), and `tables`, one per launch: ``(leaves, first_chunks,
    chunks)``, the leaf indices it takes, the first chunk (block) of each,
    and its block count. Leaves of no elements are in no table."""

    offsets: tuple[int, ...]
    total: int
    tables: tuple[tuple[tuple[int, ...], tuple[int, ...], int], ...]


def adam_leaf_plan(numels) -> AdamLeafPlan:
    """The plan of one update of leaves of `numels` elements: each leaf's
    output offset rounded up to 4 elements, ``ceil(n / CHUNK)`` chunks a
    leaf, and the leaves in order in tables of at most `TABLE_LEAVES`."""
    offsets, total = [], 0
    for n in numels:
        offsets.append(total)
        total += -(-int(n) // 4) * 4
    tables, leaves, firsts, chunks = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(leaves) == TABLE_LEAVES:
            tables.append((tuple(leaves), tuple(firsts), chunks))
            leaves, firsts, chunks = [], [], 0
        leaves.append(i)
        firsts.append(chunks)
        chunks += -(-int(n) // CHUNK)
    if leaves:
        tables.append((tuple(leaves), tuple(firsts), chunks))
    return AdamLeafPlan(tuple(offsets), total, tuple(tables))


_cached_plan = functools.lru_cache(maxsize=64)(adam_leaf_plan)


def _check(name, groups, scalars, n_scalars) -> None:
    """One pass over every leaf's tensors: f32, contiguous, one shape a
    leaf, one device for all; `scalars` of `n_scalars` elements."""
    devices = {scalars.device}
    for group in groups:
        shape = group[0].shape
        for t in group:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: every tensor must be float32, got "
                                f"{t.dtype} (cast grads to f32 before the "
                                "update)")
            if t.shape != shape:
                raise ValueError(f"{name}: leaf shapes differ "
                                 f"{[tuple(x.shape) for x in group]}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
            devices.add(t.device)
    if scalars.dtype != torch.float32:
        raise TypeError(f"{name}: every tensor must be float32, got "
                        f"{scalars.dtype}")
    if scalars.numel() != n_scalars:
        raise ValueError(f"{name}: want {n_scalars} scalar(s), got "
                         f"{tuple(scalars.shape)}")
    if not scalars.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices "
                         f"({sorted(map(str, devices))})")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _consts(b1, b2, eps) -> tuple[float, ...]:
    # 1-b in double, rounded once to f32 by ctypes: JAX's constants
    return (b1, b2, 1.0 - b1, 1.0 - b2, eps)


@functools.cache
def _entry(symbol: str):
    """The library's C function `symbol`, built, loaded and typed once."""
    fn = getattr(build.load("fused_adam"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, counter, groups, scalars, consts, clip_wd):
    """One kernel launch per table of the plan over `groups` ((g, m, v)
    or (g, m, v, p) per leaf): per-leaf views of three flat outputs."""
    if not groups:
        return [], [], []
    numels = tuple(group[0].numel() for group in groups)
    plan = _cached_plan(numels)
    device = groups[0][0].device
    flat = [torch.empty(plan.total, dtype=torch.float32, device=device)
            for _ in range(3)]
    fn = _entry("dmt_fused_adam_leaves")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for leaves, firsts, chunks in plan.tables:
            desc = []
            for i, chunk0 in zip(leaves, firsts):
                g, m, v, *p = groups[i]
                desc += [g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         p[0].data_ptr() if p else 0, numels[i],
                         plan.offsets[i], chunk0]
            err = fn((ctypes.c_longlong * len(desc))(*desc), len(leaves),
                     chunks, scalars.data_ptr(),
                     *(t.data_ptr() for t in flat), *consts, int(clip_wd),
                     stream)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: "
                                   f"cudaError {err}")
            counter.launches += 1
    return tuple([f[off:off + n].view(group[0].shape)
                  for off, n, group in zip(plan.offsets, numels, groups)]
                 for f in flat)


def fused_adam_update_leaves(grads, ms, vs, lr_t, *, b1=0.9, b2=0.999,
                             eps=1e-8):
    """One-pass Adam slot and delta update of every leaf, in one launch
    (per `TABLE_LEAVES` leaves).

    grads, ms, vs: lists of f32 leaves, each leaf's three of one shape,
    contiguous, all on one device; lr_t: f32 tensor of one element there.
    Returns new (deltas, ms, vs), lists in the leaves' order."""
    groups = list(zip(grads, ms, vs, strict=True))
    _check("fused_adam_update", groups, lr_t, 1)
    if lr_t.device.type == "cpu":
        return fused_adam_update_leaves_reference(grads, ms, vs, lr_t, b1=b1,
                                                  b2=b2, eps=eps)
    return _launch("fused_adam_update", fused_adam_update, groups, lr_t,
                   _consts(b1, b2, eps), clip_wd=False)


def fused_adam_clip_wd_update_leaves(grads, ms, vs, params, scalars, *,
                                     b1=0.9, b2=0.999, eps=1e-8):
    """One-pass global-norm clip + Adam + decoupled weight decay of every
    leaf, in one launch (per `TABLE_LEAVES` leaves).

    grads, ms, vs, params: lists of f32 leaves as in
    `fused_adam_update_leaves`; scalars: f32 ``[lr_t, clip_scale, lr*wd]``
    on their device. Returns new (deltas, ms, vs)."""
    groups = list(zip(grads, ms, vs, params, strict=True))
    _check("fused_adam_clip_wd_update", groups, scalars, 3)
    if scalars.device.type == "cpu":
        return _leafwise(fused_adam_clip_wd_update_reference, groups, scalars,
                         b1=b1, b2=b2, eps=eps)
    return _launch("fused_adam_clip_wd_update", fused_adam_clip_wd_update,
                   groups, scalars, _consts(b1, b2, eps), clip_wd=True)


def fused_adam_update(grad, m, v, lr_t, *, b1=0.9, b2=0.999, eps=1e-8):
    """One-pass Adam slot and delta update of one leaf.

    grad, m, v: f32, one shape, contiguous, on one device; lr_t: f32 tensor
    of one element there (the bias-corrected step size). Returns new
    (delta, m, v)."""
    return tuple(x[0] for x in fused_adam_update_leaves(
        [grad], [m], [v], lr_t, b1=b1, b2=b2, eps=eps))


fused_adam_update.launches = 0


def fused_adam_clip_wd_update(grad, m, v, param, scalars, *, b1=0.9,
                              b2=0.999, eps=1e-8):
    """One-pass global-norm clip + Adam + decoupled weight decay of one
    leaf.

    grad, m, v, param: f32, one shape, contiguous, on one device; scalars:
    f32 ``[lr_t, clip_scale, lr*wd]`` there. `clip_scale` is the factor the
    caller computed once over the whole tree. Returns new (delta, m, v)."""
    return tuple(x[0] for x in fused_adam_clip_wd_update_leaves(
        [grad], [m], [v], [param], scalars, b1=b1, b2=b2, eps=eps))


fused_adam_clip_wd_update.launches = 0


def fused_adam_cost(numels, *, clip_wd: bool = False) -> dict:
    """Roofline inputs for one update of leaves of `numels` elements: the
    device-memory bytes the function must move (each f32 input read once,
    each output written once) and its f32 operations (mul, add, sqrt and
    div counted one each)."""
    n = sum(int(k) for k in numels)
    return {"hbm_bytes": float(n * 4 * (7 if clip_wd else 6)),
            "flops": float(n * (14 if clip_wd else 11))}
