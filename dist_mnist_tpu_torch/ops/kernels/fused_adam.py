"""One-pass Adam updates for a single parameter leaf.

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

Each wrapper checks its inputs, then launches the kernel for CUDA tensors
and runs the plain version beside it (the same math in torch) for CPU
tensors; it never routes a CUDA tensor around the kernel.
`fused_adam_update.launches` and `fused_adam_clip_wd_update.launches`
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dist_mnist_tpu_torch.ops.kernels import build

#: the C entry points of `csrc/fused_adam.cu` and their arguments: the
#: input and output pointers, n, the five f32 constants, the stream
_ARGTYPES = {
    "dmt_fused_adam": ((ctypes.c_void_p,) * 7 + (ctypes.c_longlong,)
                       + (ctypes.c_float,) * 5 + (ctypes.c_void_p,)),
    "dmt_fused_adam_clip_wd": ((ctypes.c_void_p,) * 8 + (ctypes.c_longlong,)
                               + (ctypes.c_float,) * 5 + (ctypes.c_void_p,)),
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


def _check(name, leaves, scalars, n_scalars) -> None:
    for t in (*leaves, scalars):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: every tensor must be float32, got "
                            f"{t.dtype} (cast grads to f32 before the "
                            "update)")
    shape = leaves[0].shape
    if any(t.shape != shape for t in leaves):
        raise ValueError(f"{name}: leaf shapes differ "
                         f"{[tuple(t.shape) for t in leaves]}")
    if scalars.numel() != n_scalars:
        raise ValueError(f"{name}: want {n_scalars} scalar(s), got "
                         f"{tuple(scalars.shape)}")
    if not all(t.is_contiguous() for t in (*leaves, scalars)):
        raise ValueError(f"{name}: tensors must be contiguous")
    devices = {t.device for t in (*leaves, scalars)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices "
                         f"({sorted(map(str, devices))})")


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


def _launch(name, symbol, ins, n, consts):
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    fn = _entry(symbol)
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream(ins[0].device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                 n, *consts, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return outs


def fused_adam_update(grad, m, v, lr_t, *, b1=0.9, b2=0.999, eps=1e-8):
    """One-pass Adam slot and delta update of one leaf.

    grad, m, v: f32, one shape, contiguous, on one device; lr_t: f32 tensor
    of one element there (the bias-corrected step size). Returns new
    (delta, m, v)."""
    _check("fused_adam_update", (grad, m, v), lr_t, 1)
    if grad.device.type == "cpu":
        return fused_adam_update_reference(grad, m, v, lr_t, b1=b1, b2=b2,
                                           eps=eps)
    if grad.device.type != "cuda":
        raise ValueError(f"fused_adam_update: unsupported device "
                         f"{grad.device}")
    out = _launch("fused_adam_update", "dmt_fused_adam", (grad, m, v, lr_t),
                  grad.numel(), _consts(b1, b2, eps))
    fused_adam_update.launches += 1
    return out


fused_adam_update.launches = 0


def fused_adam_clip_wd_update(grad, m, v, param, scalars, *, b1=0.9,
                              b2=0.999, eps=1e-8):
    """One-pass global-norm clip + Adam + decoupled weight decay of one
    leaf.

    grad, m, v, param: f32, one shape, contiguous, on one device; scalars:
    f32 ``[lr_t, clip_scale, lr*wd]`` there. `clip_scale` is the factor the
    caller computed once over the whole tree. Returns new (delta, m, v)."""
    _check("fused_adam_clip_wd_update", (grad, m, v, param), scalars, 3)
    if grad.device.type == "cpu":
        return fused_adam_clip_wd_update_reference(
            grad, m, v, param, scalars, b1=b1, b2=b2, eps=eps)
    if grad.device.type != "cuda":
        raise ValueError(f"fused_adam_clip_wd_update: unsupported device "
                         f"{grad.device}")
    out = _launch("fused_adam_clip_wd_update", "dmt_fused_adam_clip_wd",
                  (grad, m, v, param, scalars), grad.numel(),
                  _consts(b1, b2, eps))
    fused_adam_clip_wd_update.launches += 1
    return out


fused_adam_clip_wd_update.launches = 0


def fused_adam_cost(numels, *, clip_wd: bool = False) -> dict:
    """Roofline inputs for one update of leaves of `numels` elements: the
    device-memory bytes the function must move (each f32 input read once,
    each output written once) and its f32 operations (mul, add, sqrt and
    div counted one each)."""
    n = sum(int(k) for k in numels)
    return {"hbm_bytes": float(n * 4 * (7 if clip_wd else 6)),
            "flops": float(n * (14 if clip_wd else 11))}
