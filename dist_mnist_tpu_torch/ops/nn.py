"""Functional NN layers: init fns returning param dicts + pure apply fns.

Port of the reference `ops/nn.py` for the layers the ported models use.
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
    """2-sigma truncated normal scaled by `stddev`: standard normals drawn
    from `gen`, each one outside [-2, 2] drawn again (all of them at once,
    in turns) until none is left.

    The port samples this itself rather than through
    `torch.nn.init.trunc_normal_`, whose algorithm changed between torch
    releases (an inverted uniform CDF before 2.13, this rejection loop
    since): with it, one seed gave the CPU tests one LeNet-5 or MLP and
    the card another. This loop is 2.13's, so one seed now gives the
    weights the CPU tests hold, under any torch."""
    t = torch.empty(tuple(shape), dtype=dtype).normal_(0.0, 1.0,
                                                        generator=gen)
    while True:
        out = (t < -2.0) | (t > 2.0)
        if not out.any():
            return stddev * t
        t = torch.where(out, torch.empty_like(t).normal_(0.0, 1.0,
                                                         generator=gen), t)


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


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC: the f32 mean over H and W, back in x's dtype."""
    return x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)


# ---------------------------------------------------------------------------
# input scaling / regularization / activations


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [0, 1]: ``x / 255`` with IEEE division.

    The divisor is a tensor on x's device. Torch on CUDA divides by a
    Python number (or a CPU scalar) as a multiply by its reciprocal, which
    gives another f32 than the reference's division for about half of the
    256 byte values."""
    x = x.to(torch.float32)
    return x / torch.full((), 255.0, dtype=torch.float32, device=x.device)


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            gen: torch.Generator | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout: ``where(mask, x / keep, 0)`` in x's dtype.

    The keep-mask is `mask` when given (a test feeds the reference's),
    else ``uniform[0, 1) < keep`` drawn from `gen`, a generator on x's
    device (`jax.random.bernoulli` draws the same way). The division is by
    a tensor of x's dtype, as the reference divides by a weakly typed
    constant."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        if gen is None:
            raise ValueError("dropout needs a generator or a keep-mask")
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    scaled = x / torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask.to(x.device), scaled,
                       torch.zeros((), dtype=x.dtype, device=x.device))


relu = F.relu


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# normalization / attention params


def init_layer_norm(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def ordered_sum(t: torch.Tensor, dim: int,
                keepdim: bool = False) -> torch.Tensor:
    """`t` summed over `dim` strictly in index order, as the last prefix
    sum of a scan along that axis.

    `torch.sum` groups a reduction by its length (vector lanes and a tail
    on the CPU) and, on CUDA, splits it among threads by the number of
    outputs, so one row summed among 2 rows or among 200, or with masked
    zeros appended, can round apart. A scan along an axis that is not the
    innermost runs in index order, on the CPU and on CUDA (one thread per
    output); an innermost axis is scanned as the middle axis of a view
    with a trailing axis of one."""
    dim = dim % t.ndim
    last = dim == t.ndim - 1
    if last:
        t = t.unsqueeze(-1)
    out = t.cumsum(dim).select(dim, -1)
    if last:
        out = out.squeeze(-1)
    return out.unsqueeze(dim) if keepdim else out


def layer_norm(p: Params, x: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics (the biased
    variance), ``(x - mean) * rsqrt(var + eps) * scale + bias``, back in
    x's dtype. Mean and variance are `ordered_sum`s divided (IEEE, by a
    tensor) by the width, so a row's statistics do not depend on how many
    rows are normalized with it."""
    xf = x.to(torch.float32)
    width = torch.full((), float(x.shape[-1]), device=x.device)
    mean = ordered_sum(xf, -1, keepdim=True) / width
    var = ordered_sum(torch.square(xf - mean), -1, keepdim=True) / width
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def init_batch_norm(dim: int) -> tuple[Params, Params]:
    """(params, state): scale and bias, and the running statistics the
    forward threads through (never assigned in place)."""
    params = {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def batch_norm(p: Params, state: Params, x: torch.Tensor, *, train: bool,
               momentum: float = 0.9,
               eps: float = 1e-5) -> tuple[torch.Tensor, Params]:
    """NHWC batch norm with the reference's rule: in training, f32
    statistics over N, H and W, the BIASED variance (the mean of the
    squared deviations from the mean, two passes), running statistics
    ``momentum * old + (1 - momentum) * batch``; in eval the running
    statistics; then ``(x - mean) * rsqrt(var + eps) * scale + bias`` in
    f32, back in x's dtype. (`F.batch_norm` updates with the unbiased
    variance and weighs the new value by its momentum.)

    Synchronized: when a mesh of more than one rank is ambient
    (`cluster.mesh.activate`, as the training step sets it), the
    statistics are over the GLOBAL batch, each pass's sums all-reduced by
    an all-reduce that autograd differentiates, as XLA inserts for the
    reference when the batch is sharded."""
    from dist_mnist_tpu_torch.cluster.mesh import ambient_mesh

    xf = x.to(torch.float32)
    if not train:
        mean, var = state["mean"], state["var"]
        new_state = state
    else:
        dims = tuple(range(x.ndim - 1))
        mesh = ambient_mesh()
        if mesh is None or mesh.size == 1:
            mean = xf.mean(dims)
            var = torch.square(xf - mean).mean(dims)
        else:
            from dist_mnist_tpu_torch.parallel.collectives import (
                all_reduce_sum,
            )

            count = torch.full((), float(xf.numel() // xf.shape[-1]
                                         * mesh.size), device=xf.device)
            mean = all_reduce_sum(xf.sum(dims), mesh) / count
            var = all_reduce_sum(torch.square(xf - mean).sum(dims),
                                 mesh) / count
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
        }
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype), new_state


def init_attention(gen, dim: int, num_heads: int) -> Params:
    """The `qkv` ``[dim, 3*dim]`` and `out` ``[dim, dim]`` dense pairs,
    xavier-uniform kernels and zero biases. `num_heads` is static: the
    callers split heads, the params do not store it."""
    del num_heads
    return {
        "qkv": {"w": xavier_uniform(gen, (dim, 3 * dim)),
                "b": torch.zeros(3 * dim)},
        "out": {"w": xavier_uniform(gen, (dim, dim)), "b": torch.zeros(dim)},
    }


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Row-major flatten of the NHWC layout — (h, w, c) order, the order
    the reference's dense kernels were laid out for."""
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# remat tags


@torch.library.custom_op("dist_mnist_tpu_torch::checkpoint_name",
                         mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _checkpoint_name_fake(x, name):
    return torch.empty_like(x)


def _checkpoint_name_backward(ctx, grad):
    return grad, None


_checkpoint_name.register_autograd(_checkpoint_name_backward)

#: the tag's operator, as a selective-checkpoint policy sees it
#: (`train/step.py` REMAT_POLICIES); its second argument is the name
CHECKPOINT_NAME = torch.ops.dist_mnist_tpu_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x` tagged `name` for the remat policies: the reference's
    ``jax.ad_checkpoint.checkpoint_name``. It is one registered operator
    (`CHECKPOINT_NAME`, a copy forward, the identity backward), so a
    selective-checkpoint policy sees the tag and its name, and may save
    the tagged tensor rather than recompute it. Outside a checkpointed
    region it is a copy of `x`."""
    return _checkpoint_name(x, name)


# ---------------------------------------------------------------------------
# attention (the plain "xla" path of ViT; the kernels live in ops/kernels)


def multi_head_attention(p: Params, x: torch.Tensor, num_heads: int,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, S, D]`` self-attention through `dot_product_attention`: the
    fused qkv projection split into heads, attention, the out
    projection. `mask` ``[B, S]`` marks real tokens."""
    b, s, d = x.shape
    qkv = dense(p["qkv"], x).reshape(b, s, 3, num_heads, d // num_heads)
    q, k, v = qkv.unbind(2)  # each [B, S, H, Dh]
    out = dot_product_attention(q, k, v, mask=mask)
    return dense(p["out"], out.reshape(b, s, d))


def dot_product_attention(q, k, v, mask: torch.Tensor | None = None):
    """``[B, S, H, Dh] -> [B, S, H, Dh]``, the reference's rounding: the
    scores einsum in q's dtype, then f32 times ``Dh**-0.5``; keys outside
    `mask` ``[B, S_k]`` get ``-1e30``; softmax in f32, the weights cast to
    q's dtype, weights @ V in q's dtype. The result is tagged
    ``attn_out`` (`checkpoint_name`) for the ``save_attn`` remat policy,
    as the reference tags it."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :].to(torch.bool), logits,
                             torch.full((), -1e30, device=logits.device))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return checkpoint_name(torch.einsum("bhqk,bkhd->bqhd", weights, v),
                           "attn_out")
