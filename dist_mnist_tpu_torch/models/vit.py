"""ViT-Tiny for CIFAR-10 (port of the reference `models/vit.py`).

DeiT-Ti's widths (dim 192, depth 12, 3 heads, MLP ratio 4), 4x4 patches so
a 32x32 image is 64 tokens, learned position embeddings, a CLS token (or
mean pooling), pre-LN blocks. Params stay f32; activations run in
`compute_dtype` (bf16 by default). The param tree has the reference's
layout, so `convert.params_from_jax` carries a reference tree across:
``block0..block{depth-1}``, or with ``scan_blocks=True`` one stacked
``blocks`` tree whose leaves lead with ``[depth, ...]``
(`convert_block_layout` moves between the two). PyTorch runs the stacked
layout as a loop over the depth; there is nothing to compile once.

`attention_impl` picks the attention inner loop: ``"xla"`` is the plain
einsum path (`ops/nn.dot_product_attention`), ``"flash"`` the hand-written
CUDA flash kernels (`parallel/flash.py` -> `ops/kernels/flash_attention.py`,
and with a token `mask` the masked kernels). The ring and Ulysses
variants, MoE blocks and the block pipeline raise until ROADMAP §1 item 11.

Dropout (after the MLP's GELU) takes one keep-mask per layer. `apply`
draws all of them up front from the generator `rng`
(`dropout_masks`), or takes them stacked as `dropout_mask` ``[depth, B,
S, mlp_dim]``: a rematerialized step draws them before its checkpointed
region and passes them in, so the recompute sees the same masks.

Tensor parallelism: under an ambient mesh with a ``model`` axis wider
than one (`train/step.py` installs it) the params are this rank's slices
by `parallel/sharding.TP_RULES`, and each block runs the Megatron layout
the reference's GSPMD program runs for ``vit_tiny_cifar_tp``, with the
collectives written out (`parallel/collectives`): qkv column-parallel
(``copy_to_model(y) @ qkv_local``, the outputs gathered on the feature
dim, attention replicated, since 3 heads do not split over 2 ranks),
attn/out row-parallel (this rank's feature slice of the attention output
``@ out_local``, `reduce_from_model`, then the bias), mlp_in
column-parallel and GELU on the sharded hidden, dropout with this rank's
columns of the full keep-mask (every rank of a model group draws the
same mask from the same generator), mlp_out row-parallel. Everything
else (patch embedding, layer norms, the head) runs replicated, so the
logits are the same bits on every rank of a model group.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from dist_mnist_tpu_torch.cluster.mesh import ambient_mesh
from dist_mnist_tpu_torch.ops import nn
from dist_mnist_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)
from dist_mnist_tpu_torch.parallel.flash import (
    flash_attention_sharded,
    masked_flash_attention_sharded,
)
from dist_mnist_tpu_torch.utils.tree import (
    flatten_with_path,
    leaves,
    map_with_path,
    tree_map,
)

_LATER = {
    "ring": "ring attention",
    "ring_flash": "ring attention",
    "ulysses": "Ulysses attention",
    "ulysses_flash": "Ulysses attention",
}


def stack_stage_params(params_list):
    """Stack isomorphic param trees into one with a leading axis (a copy of
    the reference's `parallel/pipeline.stack_stage_params`)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def unstack_params(stacked, depth: int) -> list:
    """The per-layer trees of a stacked tree. Each leaf is unbound once,
    so the backward stacks each leaf's grads in one op."""
    parts = {path: leaf.unbind(0) for path, leaf in
             flatten_with_path(stacked)}
    return [map_with_path(lambda path, _, i=i: parts[path][i], stacked)
            for i in range(depth)]


def convert_block_layout(params: dict) -> dict:
    """Convert a ViT param tree between the unrolled layout
    (``block0..blockN-1``) and the scanned layout (stacked ``blocks``),
    whichever it has; the layouts are numerically interchangeable."""
    if "blocks" in params:
        out = {k: v for k, v in params.items() if k != "blocks"}
        depth = leaves(params["blocks"])[0].shape[0]
        for i, block in enumerate(unstack_params(params["blocks"], depth)):
            out[f"block{i}"] = block
        return out
    block_keys = sorted((k for k in params if re.fullmatch(r"block\d+", k)),
                        key=lambda k: int(k[5:]))
    if not block_keys:
        raise ValueError("no block0.. or 'blocks' entry to convert")
    out = {k: v for k, v in params.items() if k not in block_keys}
    out["blocks"] = stack_stage_params([params[k] for k in block_keys])
    return out


def _row_parallel(p, y, mesh):
    """A row-parallel dense layer: this rank's input slice times its rows
    of the kernel, summed over the model group, then the (replicated)
    bias."""
    part = y @ p["w"].to(y.dtype)
    return reduce_from_model(part, mesh) + p["b"].to(y.dtype)


@dataclasses.dataclass(frozen=True)
class ViTTiny:
    num_classes: int = 10
    patch: int = 4
    dim: int = 192
    depth: int = 12
    heads: int = 3
    mlp_ratio: int = 4
    dropout_rate: float = 0.1
    compute_dtype: torch.dtype = torch.bfloat16
    # "xla" | "flash"; "ring" | "ring_flash" | "ulysses" | "ulysses_flash"
    # come with the parallel-attention slice
    attention_impl: str = "xla"
    pool: str = "cls"  # "cls" | "mean"
    mlp_impl: str = "dense"  # "moe" comes with the parallel slice
    scan_blocks: bool = False  # the stacked `blocks` layout
    block_pipeline: int = 0  # the GPipe stack comes with the parallel slice

    #: the blocks run on TP_RULES slices under a mesh's model axis
    tensor_parallel = True

    def __post_init__(self):
        if self.attention_impl in _LATER:
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: "
                f"{_LATER[self.attention_impl]} joins the port with the "
                "parallel-attention slice (ROADMAP §1 item 11)")
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; use "
                "'xla' | 'flash' | 'ring' | 'ring_flash' | 'ulysses' | "
                "'ulysses_flash'")
        if self.mlp_impl != "dense":
            raise NotImplementedError(
                f"mlp_impl={self.mlp_impl!r}: MoE blocks join the port with "
                "the parallel slice (ROADMAP §1 item 11)")
        if self.block_pipeline:
            raise NotImplementedError(
                "block_pipeline: the GPipe block stack joins the port with "
                "the parallel slice (ROADMAP §1 item 11)")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got "
                             f"{self.pool!r}")

    @property
    def mlp_dim(self) -> int:
        return self.dim * self.mlp_ratio

    def n_tokens(self, sample_shape) -> int:
        h, w = int(sample_shape[1]), int(sample_shape[2])
        return (h // self.patch) * (w // self.patch) + (
            1 if self.pool == "cls" else 0)

    def flops_per_example(self, sample_shape) -> float:
        """Analytic FORWARD FLOPs per example (matmul MACs x2; layer norm,
        softmax and elementwise ignored), the MFU numerator's count, as
        the reference's."""
        c = int(sample_shape[3])
        s = self.n_tokens(sample_shape)
        d = self.dim
        patch_embed = (s - (1 if self.pool == "cls" else 0)) * d \
            * (self.patch * self.patch * c) * 2
        per_block = (
            s * 3 * d * d * 2          # qkv projection
            + 2 * s * s * d * 2        # scores (QK^T) + apply (A*V)
            + s * d * d * 2            # output projection
            + 2 * s * d * (d * self.mlp_ratio) * 2  # mlp in + out
        )
        head = d * self.num_classes * 2
        return float(patch_embed + self.depth * per_block + head)

    def init(self, gen, sample_input):
        c = int(sample_input.shape[3])
        d = self.dim
        params = {
            "patch": nn.init_conv(gen, self.patch, self.patch, c, d,
                                  init=nn.xavier_uniform),
            "pos": 0.02 * torch.randn(
                (1, self.n_tokens(sample_input.shape), d), generator=gen),
            "head": nn.init_dense(gen, d, self.num_classes,
                                  init=nn.xavier_uniform),
            "final_ln": nn.init_layer_norm(d),
        }
        if self.pool == "cls":
            params["cls"] = torch.zeros((1, 1, d))
        blocks = [{
            "ln1": nn.init_layer_norm(d),
            "attn": nn.init_attention(gen, d, self.heads),
            "ln2": nn.init_layer_norm(d),
            "mlp_in": nn.init_dense(gen, d, self.mlp_dim,
                                    init=nn.xavier_uniform),
            "mlp_out": nn.init_dense(gen, self.mlp_dim, d,
                                     init=nn.xavier_uniform),
        } for _ in range(self.depth)]
        if self.scan_blocks:
            params["blocks"] = stack_stage_params(blocks)
        else:
            for i, block in enumerate(blocks):
                params[f"block{i}"] = block
        return params, {}

    def dropout_masks(self, gen: torch.Generator, x: torch.Tensor, *,
                      global_batch: int | None = None,
                      offset: int = 0) -> torch.Tensor | None:
        """Every layer's keep-mask for the NHWC batch `x`, ``[depth, B,
        tokens, mlp_dim]`` bool, ``uniform[0, 1) < 1 - rate`` drawn from
        `gen` (a generator on x's device); None without dropout. Drawn for
        `global_batch` rows (default x's), rows ``offset : offset + B``
        kept: a rank's slice of a global draw."""
        if self.dropout_rate == 0.0:
            return None
        b = x.shape[0]
        rows = b if global_batch is None else global_batch
        shape = (self.depth, rows, self.n_tokens(x.shape), self.mlp_dim)
        keep = torch.rand(shape, generator=gen, device=x.device) \
            < 1.0 - self.dropout_rate
        return keep if rows == b else keep[:, offset:offset + b]

    def _attention(self, p, x, mask=None, tp=None):
        if tp is not None:
            return self._tp_attention(p, x, tp, mask=mask)
        if self.attention_impl == "xla":
            return nn.multi_head_attention(p, x, self.heads, mask=mask)
        b, s, d = x.shape
        qkv = nn.dense(p["qkv"], x)
        return nn.dense(p["out"], self._attend(qkv, mask).reshape(b, s, d))

    def _attend(self, qkv, mask=None):
        """``[B, S, H, Dh]`` attention of the fused projection's output
        ``[B, S, 3D]``."""
        b, s, three_d = qkv.shape
        h = self.heads
        qkv = qkv.reshape(b, s, 3, h, three_d // (3 * h))
        q, k, v = qkv.unbind(2)  # strided views, read in place
        if self.attention_impl == "xla":
            return nn.dot_product_attention(q, k, v, mask=mask)
        if mask is not None:
            # token masks are key prefixes: the masked kernels take
            # per-row lengths and skip key tiles past them
            lengths = mask.to(torch.int32).sum(-1, dtype=torch.int32)
            out = masked_flash_attention_sharded(q, k, v, lengths)
        else:
            # full-K tiles, the reference's rule for every ViT call
            out = flash_attention_sharded(q, k, v)
        return out

    def _tp_attention(self, p, x, mesh, mask=None):
        """The Megatron attention (module docstring): qkv column-parallel
        and gathered, attention replicated, out row-parallel."""
        b, s, d = x.shape
        qkv = gather_from_model(nn.dense(p["qkv"], copy_to_model(x, mesh)),
                                mesh, -1)
        out = self._attend(qkv, mask).reshape(b, s, d)
        return _row_parallel(p["out"], scatter_to_model(out, mesh, -1), mesh)

    def _block(self, p, x, keep=None, mask=None, tp=None):
        """One pre-LN transformer block; `keep` is its dropout keep-mask
        (the full width: under `tp` this rank takes its columns)."""
        y = nn.layer_norm(p["ln1"], x)
        x = x + self._attention(p["attn"], y, mask=mask, tp=tp)
        y = nn.layer_norm(p["ln2"], x)
        if tp is None:
            y = nn.gelu(nn.dense(p["mlp_in"], y))
        else:
            y = nn.gelu(nn.dense(p["mlp_in"], copy_to_model(y, tp)))
            if keep is not None:
                width = y.shape[-1]
                keep = keep[..., tp.model_index * width:
                            (tp.model_index + 1) * width]
        if keep is not None:
            y = nn.dropout(y, self.dropout_rate, train=True, mask=keep)
        if tp is None:
            return x + nn.dense(p["mlp_out"], y)
        return x + _row_parallel(p["mlp_out"], y, tp)

    def apply(self, params, state, x, *, train=False, rng=None,
              dropout_mask=None, mask=None):
        """Logits (f32) for NHWC `x`. In training, dropout takes
        `dropout_mask` (every layer's, stacked) or draws it from `rng`.
        `mask` ``[B, patch_tokens]`` marks real patch tokens of an input
        whose height was right-padded (variable-length serving): padded
        keys leave every softmax and the pool, and `pos` is sliced to the
        token count."""
        use_dropout = train and self.dropout_rate > 0 and (
            rng is not None or dropout_mask is not None)
        if use_dropout and dropout_mask is None:
            dropout_mask = self.dropout_masks(rng, x)
        x = x.to(self.compute_dtype)
        x = nn.conv2d(params["patch"], x, stride=self.patch,
                      padding="VALID")
        b, ph, pw, d = x.shape
        x = x.reshape(b, ph * pw, d)
        tok_mask = None
        if mask is not None:
            if tuple(mask.shape) != (b, ph * pw):
                raise ValueError(f"mask shape {tuple(mask.shape)} != (batch, "
                                 f"patch_tokens) {(b, ph * pw)}")
            tok_mask = mask.to(torch.bool)
        if self.pool == "cls":
            cls = params["cls"].to(x.dtype).expand(b, 1, d)
            x = torch.cat([cls, x], dim=1)
            if tok_mask is not None:  # the CLS token is always real
                tok_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                                 device=x.device), tok_mask],
                                     dim=1)
        x = x + params["pos"][:, :x.shape[1]].to(x.dtype)
        layers = (unstack_params(params["blocks"], self.depth)
                  if self.scan_blocks
                  else [params[f"block{i}"] for i in range(self.depth)])
        mesh = ambient_mesh()
        tp = mesh if mesh is not None and mesh.model > 1 else None
        for i, p in enumerate(layers):
            x = self._block(p, x, dropout_mask[i] if use_dropout else None,
                            mask=tok_mask, tp=tp)
        x = nn.layer_norm(params["final_ln"], x)
        if self.pool == "cls":
            pooled = x[:, 0]
        elif tok_mask is None:
            pooled = x.mean(dim=1)
        else:  # masked mean: padded rows carry garbage, weight them 0
            m = tok_mask.to(x.dtype)[..., None]
            pooled = (x * m).sum(dim=1) / m.sum(dim=1)
        logits = nn.dense(params["head"], pooled)
        return logits.to(torch.float32), state
