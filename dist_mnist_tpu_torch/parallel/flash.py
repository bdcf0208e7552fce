"""The flash kernels' entry for a mesh (port of the reference
`parallel/flash.py`, one device).

The reference shards the kernel over heads with `shard_map` when the
ambient mesh has a >1 `model` axis (Megatron TP attention). The port runs
on one device: with no mesh, or a mesh whose model axis is 1, these call
the kernels directly; a >1 model axis raises until the tensor- and
data-parallel slice (ROADMAP §1 item 12) brings the sharded branch.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
from dist_mnist_tpu_torch.ops.kernels.flash_attention import flash_attention
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention,
)


def _one_device(mesh: MeshSpec | None) -> None:
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(
            f"flash attention over a {mesh.model}-way model axis (heads "
            "sharded per device) joins the port with the tensor- and "
            "data-parallel slice (ROADMAP §1 item 12); the port runs it on "
            "one device")


def flash_attention_sharded(q, k, v, block_k=None, *,
                            mesh: MeshSpec | None = None):
    """``[B, S, H, D]`` flash attention (`ops/kernels/flash_attention.py`)
    on one device; `block_k` selects the streamed rounding rule."""
    _one_device(mesh)
    return flash_attention(q, k, v, block_k=block_k)


def masked_flash_attention_sharded(q, k, v, lengths, block_k=None, *,
                                   mesh: MeshSpec | None = None):
    """Variable-length twin: row b attends keys ``[0, lengths[b])``
    (`ops/kernels/masked_flash.py`). `block_k` is the reference's and
    changes nothing here: the kernels skip key tiles of their own size.
    The masked kernels take contiguous operands, so strided views (one
    fused projection's q, k, v) are copied first."""
    del block_k
    _one_device(mesh)
    return masked_flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), lengths.to(torch.int32))
