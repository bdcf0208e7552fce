"""Ring attention: sequence parallelism over the ``seq`` axis of the rank
mesh (port of the reference `parallel/ring_attention.py`).

Each seq rank holds its contiguous share of every sequence's tokens,
``[B, S/n, H, D]`` of q, k and v. K and V blocks move around the ring
(`parallel/collectives.ring_shift`: rank s sends to s+1), and each rank
merges the blockwise softmax of its queries against every block in
log-sum-exp form, so no rank holds the S x S scores. The reference runs
the same body under `shard_map`; the port runs one device per process,
so the body runs on each rank's own tokens:

- `ring_attention_inner(q, k, v, mesh, impl, block_k)`: the body, on
  this rank's ``[B, S/n, H, D]``;
- `ring_self_attention(q, k, v, mesh, ...)`: the same over `mesh`'s seq
  group, checking the layout;
- `ring_attention(q, k, v, impl, block_k)`: the entry the models call,
  the ring over the ambient mesh's seq axis when it is wider than one,
  else the impl's exact attention on one rank (`flash_attention_tagged`
  for ``impl="flash"``, `ops/nn.dot_product_attention` otherwise), so
  one model runs on any mesh and keeps its kernel.

`impl` picks the engine of a local block: ``"xla"`` the einsum block
with an f32 upcast of q, k and v, ``"flash"`` the port's
`flash_attention_lse` (the CUDA kernels on the card), whose ``(out,
lse)`` pair drops into the merge as ``(out, 1, lse)``: out is the
block-normalized numerator, so ``out * exp(lse - max)`` is the block's
``exp(logits - max) @ V`` and ``exp(lse - max)`` its row sum. The merge
is f32 in both, in the reference's order: the rank's own block first,
then the block that arrived from s-1, and so on, with the running-max
rescale. The merge consumes lse through ``exp(lse - max)``, so the flash
engine's backward gets a nonzero lse cotangent, which its kernels fold
into delta.

A departure in bytes, not in results: the reference also shifts K and V
after the last block, a shift its result never reads; the port skips
it, so a forward shifts each of K and V ``seq - 1`` times.

Non-causal, as `ops/nn.dot_product_attention`. The output is tagged
``attn_out`` (`ops/nn.checkpoint_name`) for the ``save_attn`` remat
policy.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import Mesh, ambient_mesh
from dist_mnist_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_lse,
)
from dist_mnist_tpu_torch.ops.nn import checkpoint_name, dot_product_attention
from dist_mnist_tpu_torch.parallel.collectives import ring_shift

IMPLS = ("xla", "flash")


def _check_impl(impl: str, what: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{what} impl {impl!r}: use 'xla' | 'flash'")


def ring_attention_inner(q, k, v, mesh: Mesh, impl: str = "xla",
                         block_k: int | None = None):
    """Blockwise log-sum-exp ring attention of this rank's ``[B, S/n, H,
    D]`` q, k, v over `mesh`'s seq ranks (module docstring). `block_k`
    streams K/V tiles within a local block of the flash engine."""
    _check_impl(impl, "ring attention")
    n = mesh.seq
    scale = q.shape[-1] ** -0.5
    qf = q.to(torch.float32)

    def block_xla(k_blk, v_blk):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf,
                              k_blk.to(torch.float32)) * scale
        m = logits.amax(-1)  # [B, H, Sq]
        p = torch.exp(logits - m[..., None])
        num = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.to(torch.float32))
        return num, p.sum(-1), m

    def block_flash(k_blk, v_blk):
        out, lse = flash_attention_lse(q, k_blk, v_blk, block_k=block_k)
        return out.to(torch.float32), torch.ones_like(lse), lse

    block = block_flash if impl == "flash" else block_xla

    def sc(t):  # [B, H, Sq] -> [B, Sq, H, 1]
        return t.movedim(-1, 1)[..., None]

    b, sl, h, d = q.shape
    acc_num = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    acc_den = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    acc_max = torch.full((b, h, sl), float("-inf"), dtype=torch.float32,
                         device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        num, den, m = block(k_blk, v_blk)
        new_max = torch.maximum(acc_max, m)
        old_scale = torch.exp(acc_max - new_max)
        blk_scale = torch.exp(m - new_max)
        acc_num = acc_num * sc(old_scale) + num * sc(blk_scale)
        acc_den = acc_den * old_scale + den * blk_scale
        acc_max = new_max
        if i < n - 1:  # the block s-1 held; no shift after the last
            k_blk = ring_shift(k_blk, mesh)
            v_blk = ring_shift(v_blk, mesh)
    out = acc_num / sc(acc_den)
    return checkpoint_name(out.to(q.dtype), "attn_out")


def ring_self_attention(q, k, v, mesh: Mesh, impl: str = "xla",
                        block_k: int | None = None):
    """Ring attention of this rank's ``[B, S/n, H, D]`` share of q, k, v
    over `mesh`'s seq group: the batch stays this rank's data slice and
    the tokens ring over seq (the reference's ``P(data, seq, model,
    None)`` layout with model = 1). `impl` picks the local engine."""
    if q.ndim != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(f"ring attention wants q, k, v of one [B, S/n, H, "
                         f"D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return ring_attention_inner(q, k, v, mesh, impl=impl, block_k=block_k)


def ring_attention(q, k, v, impl: str = "xla",
                   block_k: int | None = None):
    """The models' entry (module docstring): a ring over the ambient
    mesh's seq axis when it is wider than one, else the impl's exact
    attention of ``[B, S, H, D]`` on this rank."""
    _check_impl(impl, "ring attention")
    mesh = ambient_mesh()
    if mesh is None or mesh.seq == 1:
        if impl == "flash":
            from dist_mnist_tpu_torch.parallel.flash import (
                flash_attention_tagged,
            )

            return flash_attention_tagged(q, k, v, block_k=block_k)
        return dot_product_attention(q, k, v)
    return ring_self_attention(q, k, v, mesh, impl=impl, block_k=block_k)
