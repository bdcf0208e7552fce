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
remat policy.

MoE (``mlp_impl="moe"``, `parallel/moe.py`): the block's MLP is a
switch-routed expert FFN over the block's ``[B*S, D]`` tokens, through
`moe_ffn_adaptive`: expert-parallel when the ambient mesh's ``model``
axis equals `n_experts` (every model rank runs the rest of the block
whole on the same batch, as the reference's ``dp`` rules do, and its
share of the MoE layer's tokens), else all experts local. Its output
takes dropout at width ``dim``. Each block's load-balance aux and
routing stats are summed over the depth; `apply` returns the model
state ``moe_aux`` (``moe_aux_weight`` x the depth mean: the step adds
it to the loss, the ``_aux`` contract of `train/step.py`) and the depth
means ``moe_drop_fraction_metric``, ``moe_expert_load_metric`` and
``moe_ep_engaged_metric`` (step outputs, the ``_metric`` contract).

The block pipeline (``block_pipeline=N``, `parallel/pipeline.py`): under
an ambient mesh whose ``pipe`` axis equals N, the stacked blocks run as
N GPipe stages (``pipeline_circular=v``: N*v chunks, interleaved) of
``depth / (N*v)`` blocks over `pipeline_microbatches` microbatches
(fewer when the batch does not divide: the reference's adaptation), the
rest of the model on every pipe rank. On any other mesh the same model
runs the plain stacked loop, warning when the pipe axis is wider than
one and mismatched. The stage of microbatch m takes its rows of each of
its layers' keep-masks, drawn for the whole batch before the forward,
so with dropout the pipelined stack computes what the plain one does
(the reference derives a key per (data shard, microbatch, stage)
instead, so the two packages' masks differ). It needs the stacked
layout, depth % (N*v) == 0, dense MLP blocks and no token mask.

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
dim, attention replicated, since 3 heads do not split over 2 ranks: with
``"flash"`` every rank launches the kernels on all heads),
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
import logging
import re

import torch

from dist_mnist_tpu_torch.cluster.mesh import SEQ_AXIS, activate, ambient_mesh
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
from dist_mnist_tpu_torch.parallel.moe import init_moe, moe_ffn_adaptive
from dist_mnist_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from dist_mnist_tpu_torch.parallel.ring_attention import ring_attention
from dist_mnist_tpu_torch.parallel.ulysses import ulysses_attention
from dist_mnist_tpu_torch.utils.tree import (
    flatten_with_path,
    leaves,
    map_with_path,
    tree_map,
)

log = logging.getLogger(__name__)
#: (block_pipeline, pipe axis) pairs the plain-stack fallback warned about
_PIPE_WARNED: set = set()

#: the attention impls that run over a seq axis
SEQ_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
IMPLS = ("xla", "flash", *SEQ_IMPLS)
MLP_IMPLS = ("dense", "moe")


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
    mlp_impl: str = "dense"  # "dense" | "moe" (parallel/moe.py)
    n_experts: int = 4
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1  # 1 = Switch routing; >=2 = GShard-style top-k
    moe_aux_weight: float = 1e-2  # the load-balance loss's weight
    scan_blocks: bool = False  # the stacked `blocks` layout
    block_pipeline: int = 0  # N > 0: N GPipe stages over the pipe axis
    pipeline_microbatches: int = 8  # GPipe M; bubble (N-1)/(M+N-1)
    pipeline_skip_bubble: bool = False  # skip the fill/drain ticks' compute
    pipeline_circular: int = 0  # v > 1: the circular schedule's chunks

    def __post_init__(self):
        if self.attention_impl not in IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; use "
                "'xla' | 'flash' | 'ring' | 'ring_flash' | 'ulysses' | "
                "'ulysses_flash'")
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"unknown mlp_impl {self.mlp_impl!r}; use "
                             "'dense' | 'moe'")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got "
                             f"{self.pool!r}")

    @property
    def tensor_parallel(self) -> bool:
        """Whether the blocks run on TP_RULES slices under a mesh's model
        axis: dense ones do; MoE blocks run whole there, the model axis
        carrying their experts."""
        return self.mlp_impl == "dense"

    @property
    def is_moe(self) -> bool:
        return self.mlp_impl == "moe"

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
        blocks = []
        for _ in range(self.depth):
            block = {"ln1": nn.init_layer_norm(d),
                     "attn": nn.init_attention(gen, d, self.heads),
                     "ln2": nn.init_layer_norm(d)}
            if self.is_moe:
                block["moe"] = init_moe(gen, d, self.mlp_dim, self.n_experts)
            else:
                block["mlp_in"] = nn.init_dense(gen, d, self.mlp_dim,
                                                init=nn.xavier_uniform)
                block["mlp_out"] = nn.init_dense(gen, self.mlp_dim, d,
                                                 init=nn.xavier_uniform)
            blocks.append(block)
        if self.scan_blocks:
            params["blocks"] = stack_stage_params(blocks)
        else:
            for i, block in enumerate(blocks):
                params[f"block{i}"] = block
        # the aux loss and the routing stats (the structure `apply`
        # returns)
        state = ({"moe_aux": torch.zeros(()),
                  "moe_drop_fraction_metric": torch.zeros(()),
                  "moe_expert_load_metric": torch.zeros((self.n_experts,)),
                  "moe_ep_engaged_metric": torch.zeros(())}
                 if self.is_moe else {})
        return params, state

    def dropout_masks(self, gen: torch.Generator, x: torch.Tensor, *,
                      global_batch: int | None = None,
                      offset: int = 0) -> torch.Tensor | None:
        """Every layer's keep-mask for the NHWC batch `x`, ``[depth, B,
        tokens, width]`` bool (width: the MLP's hidden dim, or ``dim``
        for the MoE output), ``uniform[0, 1) < 1 - rate`` drawn from `gen`
        (a generator on x's device); None without dropout. Drawn for
        `global_batch` rows (default x's), rows ``offset : offset + B``
        kept: a rank's slice of a global draw."""
        if self.dropout_rate == 0.0:
            return None
        b = x.shape[0]
        rows = b if global_batch is None else global_batch
        width = self.dim if self.is_moe else self.mlp_dim
        shape = (self.depth, rows, self.n_tokens(x.shape), width)
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
        # every rank runs the whole attention on the gathered qkv: the
        # flash entries see no mesh here, so they launch the kernels on
        # all heads rather than split them over model (3 heads do not
        # split over 2 ranks)
        with activate(None):
            out = self._attend(qkv, mask).reshape(b, s, d)
        return _row_parallel(p["out"], scatter_to_model(out, mesh, -1), mesh)

    def _block(self, p, x, keep=None, mask=None, tp=None):
        """One pre-LN transformer block: ``(x, moe_aux, moe_stats)``, the
        last two None for a dense block. `keep` is its dropout keep-mask
        (the full width: under `tp` this rank takes its columns)."""
        y = nn.layer_norm(p["ln1"], x)
        x = x + self._attention(p["attn"], y, mask=mask, tp=tp)
        y = nn.layer_norm(p["ln2"], x)
        if self.is_moe:
            b, s, d = y.shape
            y, aux, stats = moe_ffn_adaptive(
                p["moe"], y.reshape(b * s, d),
                capacity_factor=self.moe_capacity_factor,
                top_k=self.moe_top_k)
            y = y.reshape(b, s, d)
            if keep is not None:
                y = nn.dropout(y, self.dropout_rate, train=True, mask=keep)
            return x + y, aux, stats
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
            return x + nn.dense(p["mlp_out"], y), None, None
        return x + _row_parallel(p["mlp_out"], y, tp), None, None

    def _pipe_axis_matches(self, mesh) -> bool:
        """True only when the ambient mesh's pipe axis equals the
        configured stage count; a wider-than-one but mismatched axis runs
        the plain stack, with the reference's warning (once per process
        and pair)."""
        axis = mesh.pipe if mesh is not None else 1
        if axis > 1 and axis == self.block_pipeline:
            return True
        if axis > 1 and (self.block_pipeline, axis) not in _PIPE_WARNED:
            _PIPE_WARNED.add((self.block_pipeline, axis))
            log.warning(
                "block_pipeline=%d != pipe axis %d — running the plain "
                "scanned stack (no pipeline); size the pipe axis to the "
                "stage count for pipeline parallelism",
                self.block_pipeline, axis)
        return False

    def _pipelined_blocks(self, params, x, mesh, dropout_mask=None):
        """The block stack as GPipe stages over the mesh's pipe axis
        (module docstring): stage g runs blocks ``[g*depth/(N*v),
        (g+1)*depth/(N*v))`` on each microbatch, with its rows of those
        blocks' keep-masks."""
        n = mesh.pipe
        v = max(1, self.pipeline_circular)
        if not self.scan_blocks or self.depth % (n * v):
            raise ValueError(
                "block_pipeline needs scan_blocks=True and depth % "
                "(stages * circular_chunks) == 0")
        if self.is_moe:
            raise ValueError("block_pipeline supports dense MLP blocks only")
        per_stage = self.depth // (n * v)
        stage_params = tree_map(
            lambda a: a.reshape((n * v, per_stage) + tuple(a.shape[1:])),
            params["blocks"])
        # the output does not depend on M, so M adapts down to the largest
        # count this batch supports (B % M == 0 and, circular, M % stages
        # == 0: the reference's rule on its global batch, which the data
        # axis divides as this rank's batch)
        b = x.shape[0]
        m = min(self.pipeline_microbatches, b)
        while m > 1 and (b % m or (v > 1 and m % n)):
            m -= 1
        if v > 1 and m % n:
            raise ValueError(
                f"pipeline_circular={v} needs a microbatch count divisible "
                f"by the {n}-way pipe axis; none fits batch {b}")
        rows = b // m

        def stage_fn(p, xx, mb, g):
            for i, layer in enumerate(unstack_params(p, per_stage)):
                keep = None
                if dropout_mask is not None:
                    keep = dropout_mask[g * per_stage + i][
                        mb * rows:(mb + 1) * rows]
                xx, _, _ = self._block(layer, xx, keep)
            return xx

        return pipeline_apply(stage_fn, stage_params, x, m, mesh,
                              circular_chunks=v, positions=True,
                              skip_bubble=self.pipeline_skip_bubble)

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
        tp = (mesh if mesh is not None and mesh.model > 1
              and self.tensor_parallel else None)
        sp = (mesh if mesh is not None and mesh.seq > 1
              and self.attention_impl in SEQ_IMPLS else None)
        tokens = slice(0, x.shape[1])
        if sp is not None:
            tokens = self._seq_tokens(x.shape[1], sp)
            x = x[:, tokens]
        x = x + params["pos"][:, tokens].to(x.dtype)
        if tok_mask is not None and self.block_pipeline:
            raise ValueError("mask is not supported with block_pipeline")
        aux_total, stats_total = None, None
        if self.block_pipeline and self._pipe_axis_matches(mesh):
            x = self._pipelined_blocks(
                params, x, mesh, dropout_mask if use_dropout else None)
        else:
            layers = (unstack_params(params["blocks"], self.depth)
                      if self.scan_blocks
                      else [params[f"block{i}"] for i in range(self.depth)])
            for i, p in enumerate(layers):
                keep = dropout_mask[i][:, tokens] if use_dropout else None
                x, aux, stats = self._block(p, x, keep, mask=tok_mask, tp=tp)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
                    stats_total = stats if stats_total is None else {
                        k: stats_total[k] + stats[k] for k in stats}
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
        if self.is_moe:
            state = self._moe_state(aux_total, stats_total)
        return logits.to(torch.float32), state

    def _moe_state(self, aux_total, stats_total) -> dict:
        """The model state of an MoE forward: the weighted depth-mean aux
        and the depth means of the routing stats."""
        depth = torch.full((), float(self.depth), device=aux_total.device)
        return {
            "moe_aux": self.moe_aux_weight * aux_total / depth,
            "moe_drop_fraction_metric":
                stats_total["drop_fraction"] / depth,
            "moe_expert_load_metric": stats_total["expert_load"] / depth,
            # 1.0: every block dispatched over the expert axis; 0.0: the
            # dense fallback
            "moe_ep_engaged_metric": stats_total["ep_engaged"] / depth,
        }
