"""Weight-only int8 quantization for serving: per-channel symmetric scales.

Port of the reference `ops/quant.py`. Matmul/conv kernels live on the
device as int8 with float32 per-channel scales; activations, biases and
everything else stay float. A quantized dense layer goes through the
hand-written `quant_matmul` kernel (`ops/kernels/quant_matmul.py`), which
streams the int8 weight and applies the scale once to the f32
accumulator. Conv kernels are dequantized into the compute dtype and
convolved (`ops/nn.conv2d`), as in the reference.

Scale layout: the amax reduction runs over axis ``ndim - 2`` of the
reference layout, keepdims — a dense kernel ``[D, H]`` gets scales
``[1, H]``, an HWIO conv kernel ``[kh, kw, Cin, Cout]`` gets
``[kh, kw, 1, Cout]``. A leaf with a zero-amax channel falls back to ONE
per-tensor scale broadcast to the same shape (``mode="tensor"``). The
arithmetic (``max(amax, 1e-12) / 127`` in f32, round-half-even, clip to
±127) is the reference's, so `q` and `scale` are bitwise equal to it.

KV cache (decode serving): the int8 paged KV pools are QuantizedArray
nodes with ``mode="kv_head"`` — int8 ``[depth, pages, page_tokens, heads,
head_dim]`` with f32 scales ``[..., heads, 1]``, one scale per token per
head, made by `quantize_kv` inside every decode step.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.ops.kernels.quant_matmul import quant_matmul
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, map_with_path

#: smallest representable scale — a zero-amax channel quantizes to q == 0
_EPS = 1e-12

#: int8 symmetric range is [-127, 127]
_QMAX = 127.0

#: param leaf names the default rule quantizes (dense/conv kernels, and
#: the MoE expert stacks `w1`, `w2`)
QUANT_LEAF_NAMES = ("w", "w1", "w2")


class QuantizedArray:
    """int8 weights + float32 per-channel scales, as one parameter leaf.

    `mode` is "channel" (per-output-channel scales), "tensor" (one
    shared scale, broadcast — the degenerate-leaf fallback) or "kv_head"
    (a KV-cache pool: one scale per token per head, `quantize_kv`)."""

    __slots__ = ("q", "scale", "mode")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 mode: str = "channel"):
        self.q = q
        self.scale = scale
        self.mode = mode

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def to(self, device) -> "QuantizedArray":
        return QuantizedArray(self.q.to(device), self.scale.to(device),
                              self.mode)

    def __repr__(self):
        return (f"QuantizedArray(shape={self.shape}, "
                f"scale={tuple(self.scale.shape)}, mode={self.mode!r})")


def quantize(w: torch.Tensor) -> QuantizedArray:
    """Symmetric int8 quantization of a 2-D+ float tensor (reference
    layout): per-channel scales over axis ``ndim - 2``, per-tensor
    fallback when any channel's amax is exactly zero. Load-time only."""
    if w.ndim < 2:
        raise ValueError(
            f"quantize() wants a 2-D+ kernel, got shape {tuple(w.shape)} — "
            "1-D leaves (biases, norms) should stay float (default_leaf_rule)")
    amax = w.abs().amax(dim=w.ndim - 2, keepdim=True)
    mode = "channel"
    # load-time scalar pull: once per leaf, outside the request hot path
    if not bool((amax > 0.0).all()):
        amax = w.abs().amax().expand(amax.shape)
        mode = "tensor"
    # divide by a tensor, not a Python number: on CUDA, torch turns
    # division by a scalar into a multiply by its reciprocal, which is off
    # by one ulp from the reference's quotient in a few channels
    scale = (torch.clamp(amax, min=_EPS)
             / torch.full_like(amax, _QMAX)).to(torch.float32)
    q = torch.clamp(torch.round(w.to(torch.float32) / scale),
                    -_QMAX, _QMAX).to(torch.int8)
    return QuantizedArray(q, scale.contiguous(), mode)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 for KV-cache tokens: one scale per token per head
    (amax over the LAST axis, keepdims). Returns ``(q int8, scale f32)``
    with ``scale.shape == x.shape[:-1] + (1,)``.

    Unlike `quantize` there is no degenerate-scale check (it runs inside
    every decode step and must not wait on the device): a zero-amax token
    lands on the `_EPS` floor and dequantizes to exact zeros. The division
    is by tensors, as in `quantize`, so the bits on the card equal the
    CPU's and the reference's."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (torch.clamp(amax, min=_EPS)
             / torch.full_like(amax, _QMAX)).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize(qa: QuantizedArray, dtype: torch.dtype | None = None):
    """`q * scale` back to float in `dtype` (the compute dtype; f32 when
    None) — the reference's rounding: both factors cast, then multiplied."""
    dtype = torch.float32 if dtype is None else dtype
    return qa.q.to(dtype) * qa.scale.to(dtype)


def materialize(w, dtype: torch.dtype | None = None):
    """A plain tensor passes through untouched; a QuantizedArray
    dequantizes into `dtype`."""
    if isinstance(w, QuantizedArray):
        return dequantize(w, dtype)
    return w


def q_dot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for either weight representation. A float tensor
    multiplies untouched; a 2-D `QuantizedArray` runs the `quant_matmul`
    kernel (its plain version for CPU tensors)."""
    if not isinstance(w, QuantizedArray):
        return x @ w.to(x.dtype)
    if w.ndim != 2:
        raise ValueError(
            f"q_dot wants a 2-D quantized kernel, got {w.shape}; stacked "
            "leaves are sliced to 2-D before the matmul")
    return quant_matmul(x, w.q, w.scale)


def _matmul_spec(spec: str) -> bool:
    """True when an einsum spec is exactly a last-axis matmul
    (``...k,kh->...h`` shapes, any labels): the second operand is 2-D, its
    first axis contracts with the first operand's last, and the output is
    the first operand's leading labels then the second's output label."""
    spec = spec.replace(" ", "")
    if "->" not in spec or spec.count(",") != 1:
        return False
    lhs, out = spec.split("->")
    a, b = lhs.split(",")
    if len(b) != 2 or "." in b or len(set(a)) != len(a):
        return False
    k, h = b
    return bool(a) and a[-1] == k and h not in a and out == a[:-1] + h


def q_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum twin of `q_dot`. A spec that is a last-axis matmul with a
    2-D `QuantizedArray` runs the `quant_matmul` kernel (its plain version
    for CPU tensors); every other contraction takes ``torch.einsum`` over
    the weight dequantized into `x`'s dtype, as the reference does."""
    if (isinstance(w, QuantizedArray) and w.ndim == 2
            and _matmul_spec(spec)):
        return quant_matmul(x, w.q, w.scale)
    return torch.einsum(spec, x, materialize(w, x.dtype))


# ---------------------------------------------------------------------------
# tree-level transform


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def default_leaf_rule(path, leaf) -> bool:
    """Quantize matmul/conv kernels; keep everything else float: the last
    path component names a kernel, the leaf is 2-D+ and floating."""
    if not path or not isinstance(leaf, torch.Tensor):
        return False
    return (str(path[-1]) in QUANT_LEAF_NAMES
            and leaf.ndim >= 2
            and leaf.is_floating_point())


def quantize_tree(tree, rule=default_leaf_rule):
    """Apply `quantize` to every leaf the rule selects; structure-preserving
    otherwise. Idempotent: QuantizedArray leaves pass through."""
    def one(path, leaf):
        if not isinstance(leaf, QuantizedArray) and rule(path, leaf):
            return quantize(leaf)
        return leaf

    return map_with_path(one, tree)


def is_quantized(tree) -> bool:
    """True when any leaf of `tree` is a QuantizedArray."""
    return any(isinstance(leaf, QuantizedArray)
               for _, leaf in flatten_with_path(tree))


def error_report(float_tree, quant_tree) -> dict:
    """Per-leaf quantization error of `quant_tree` against the float
    original: {"leaves": {path: {max_abs_err, rel_err, mode}},
    "max_abs_err", "max_rel_err", "n_quantized"}. rel_err is
    max|w - deq(q)| / max|w| per leaf. All per-leaf maxima come to the
    host in ONE transfer."""
    f_flat = {path_str(p): leaf for p, leaf in flatten_with_path(float_tree)}
    names, modes, stats = [], [], []
    for path, leaf in flatten_with_path(quant_tree):
        if not isinstance(leaf, QuantizedArray):
            continue
        name = path_str(path)
        w = f_flat.get(name)
        if w is None:
            continue
        wf = w.to(torch.float32)
        err = (wf - dequantize(leaf, torch.float32)).abs().amax()
        names.append(name)
        modes.append(leaf.mode)
        stats.append(torch.stack([err, wf.abs().amax()]))
    report = {"leaves": {}, "max_abs_err": 0.0, "max_rel_err": 0.0,
              "n_quantized": len(names)}
    if not names:
        return report
    vals = torch.stack(stats).cpu().tolist()
    for name, mode, (err, ref) in zip(names, modes, vals):
        rel = err / max(ref, _EPS)
        report["leaves"][name] = {
            "max_abs_err": err, "rel_err": rel, "mode": mode,
        }
        report["max_abs_err"] = max(report["max_abs_err"], err)
        report["max_rel_err"] = max(report["max_rel_err"], rel)
    return report
