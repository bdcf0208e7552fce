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
and with a token `mask` the masked kernels), ``"ring"`` and
``"ring_flash"`` ring attention over the mesh's ``seq`` axis
(`parallel/ring_attention.py`, its local blocks on the einsum or on
`flash_attention_lse`), ``"ulysses"`` and ``"ulysses_flash"`` the
all-to-all reshard (`parallel/ulysses.py`, needing heads % seq == 0, its
local attention plain or on the flash kernels). Without a seq axis the
four fall back to the exact attention of their engine.
`attention_block_k` streams K/V tiles of that many keys within the
kernel paths (None: the full-K rule). Every attention path tags its
output ``attn_out`` (`ops/nn.checkpoint_name`) for the ``save_attn``
remat policy. MoE blocks and the block pipeline raise until ROADMAP §1
item 11.

Sequence parallelism: under an ambient mesh with a ``seq`` axis of n > 1
and a ring or Ulysses `attention_impl`, each seq rank holds its
contiguous 1/n of the tokens from the patch embedding to the pool: the
patch embedding runs whole and keeps the rank's tokens, `pos` and every
layer's dropout keep-mask (drawn for all S tokens) are sliced to them,
layer norms, the MLP and the residuals run on them alone, attention
runs over the seq group, and the mean pool is a local sum, an all-reduce
over seq (`collectives.all_reduce_sum`, whose backward sums the
cotangent over seq) and a division by S. So each rank's activations are
O(S/n), and the logits are the same on every seq rank. ``pool="cls"``
raises there (the CLS token makes S odd). The step's gradient rule for
it is in `train/step.py`. Other impls on a seq mesh run the whole
sequence on every seq rank.

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

from dist_mnist_tpu_torch.cluster.mesh import SEQ_AXIS, ambient_mesh
from dist_mnist_tpu_torch.ops import nn
from dist_mnist_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)
from dist_mnist_tpu_torch.parallel.flash import (
    flash_attention_sharded,
    masked_flash_attention_sharded,
)
from dist_mnist_tpu_torch.parallel.ring_attention import ring_attention
from dist_mnist_tpu_torch.parallel.ulysses import ulysses_attention
from dist_mnist_tpu_torch.utils.tree import (
    flatten_with_path,
    leaves,
    map_with_path,
    tree_map,
)

#: the attention impls that run over a seq axis
SEQ_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
IMPLS = ("xla", "flash", *SEQ_IMPLS)


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
    # "xla" | "flash" | "ring" | "ring_flash" | "ulysses" | "ulysses_flash"
    attention_impl: str = "xla"
    # the kernel paths stream K/V tiles of this many keys; None: full-K
    attention_block_k: int | None = None
    pool: str = "cls"  # "cls" | "mean" (mean keeps S divisible by seq)
    mlp_impl: str = "dense"  # "moe" comes with the parallel slice
    scan_blocks: bool = False  # the stacked `blocks` layout
    block_pipeline: int = 0  # the GPipe stack comes with the parallel slice

    #: the blocks run on TP_RULES slices under a mesh's model axis
    tensor_parallel = True

    def __post_init__(self):
        if self.attention_impl not in IMPLS:
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
        if mask is not None and self.attention_impl in SEQ_IMPLS:
            # the reference's refusal: serve/zoo.py degrades these impls
            # to the native-length-only bucket
            raise ValueError(
                f"attention_impl {self.attention_impl!r} does not support a "
                "token mask; serve at native length or use 'xla'/'flash'")
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
        impl, block_k = self.attention_impl, self.attention_block_k
        if impl == "xla":
            return nn.dot_product_attention(q, k, v, mask=mask)
        if impl in SEQ_IMPLS:
            # ring / ulysses over the ambient seq axis; "_flash" runs
            # their local attention on the flash kernels. Each tags its
            # own output
            entry = (ring_attention if impl.startswith("ring")
                     else ulysses_attention)
            return entry(q, k, v, impl="flash" if impl.endswith("_flash")
                         else "xla", block_k=block_k)
        if mask is not None:
            # token masks are key prefixes: the masked kernels take
            # per-row lengths and skip key tiles past them
            lengths = mask.to(torch.int32).sum(-1, dtype=torch.int32)
            out = masked_flash_attention_sharded(q, k, v, lengths,
                                                 block_k=block_k)
        else:
            # block_k None: full-K tiles, the reference's rule for every
            # ViT config
            out = flash_attention_sharded(q, k, v, block_k=block_k)
        return nn.checkpoint_name(out, "attn_out")

    def _seq_tokens(self, s: int, mesh) -> slice:
        """This seq rank's contiguous share of `s` tokens; raises where
        the tokens do not split evenly (module docstring)."""
        n = mesh.seq
        if self.pool == "cls":
            raise ValueError(
                f"pool='cls' on a seq axis of {n}: the CLS token makes "
                f"S = {s} tokens, S % seq = {s % n}, and sequence "
                "parallelism shards the tokens; use pool='mean', as the "
                "ring and Ulysses configs do")
        if s % n:
            raise ValueError(f"{s} tokens % seq axis {n} = {s % n}: "
                             "sequence parallelism needs S % seq == 0")
        per = s // n
        return slice(mesh.seq_index * per, (mesh.seq_index + 1) * per)

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
        mesh = ambient_mesh()
        tp = mesh if mesh is not None and mesh.model > 1 else None
        sp = (mesh if mesh is not None and mesh.seq > 1
              and self.attention_impl in SEQ_IMPLS else None)
        tokens = slice(0, x.shape[1])
        if sp is not None:
            tokens = self._seq_tokens(x.shape[1], sp)
            x = x[:, tokens]
        x = x + params["pos"][:, tokens].to(x.dtype)
        layers = (unstack_params(params["blocks"], self.depth)
                  if self.scan_blocks
                  else [params[f"block{i}"] for i in range(self.depth)])
        for i, p in enumerate(layers):
            keep = dropout_mask[i][:, tokens] if use_dropout else None
            x = self._block(p, x, keep, mask=tok_mask, tp=tp)
        x = nn.layer_norm(params["final_ln"], x)
        if sp is not None:
            # the mean over all S tokens: this rank's sum, summed over seq
            total = all_reduce_sum(x.to(torch.float32).sum(dim=1), sp,
                                   SEQ_AXIS)
            pooled = (total / torch.full((), float(sp.seq * x.shape[1]),
                                         device=x.device)).to(x.dtype)
        elif self.pool == "cls":
            pooled = x[:, 0]
        elif tok_mask is None:
            pooled = x.mean(dim=1)
        else:  # masked mean: padded rows carry garbage, weight them 0
            m = tok_mask.to(x.dtype)[..., None]
            pooled = (x * m).sum(dim=1) / m.sum(dim=1)
        logits = nn.dense(params["head"], pooled)
        return logits.to(torch.float32), state
