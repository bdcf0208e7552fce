"""The flash kernels' entry for a mesh (port of the reference
`parallel/flash.py`).

The reference shards the kernel over heads with `shard_map` when the
ambient mesh has a >1 `model` axis (Megatron TP attention): a bare kernel
call would run replicated on every device. The port does the same over
the ranks of the mesh's model group: with no mesh, or a model axis of
one, these call the kernels directly; with a wider model axis each rank
takes its contiguous slice of the heads, ``[..., m*H/M:(m+1)*H/M, :]``
(`parallel/collectives.scatter_to_model`: its backward all-gathers the
heads' gradients, so q, k and v, replicated on the model group, get
their whole gradient on every rank), runs the CUDA kernel on them and
gathers the outputs over heads (`gather_from_model`: its backward takes
this rank's slice of the replicated cotangent, so the kernels' backward
runs on the local heads too). Every head is computed by the same kernel
on the same inputs, so the result is the unsharded kernel's, bit for
bit. The batch rides the ``data`` axis: a rank of
the step already holds its data slice of the batch, so the kernel sees
that slice. A head count the model axis cannot divide raises the
reference's ValueError. The reference also warns when the data axis does
not divide the batch, since GSPMD then replicates the whole batch on
every device; the port has no such case: `q` is already this rank's
slice, and `cluster/mesh.local_batch_slice` refuses a global batch the
data axis does not divide, so the port does not warn.

`flash_attention_tagged` is the reference's entry with the ``attn_out``
remat tag (`ops/nn.checkpoint_name`), which the ``save_attn`` policy
saves (`train/step.py` REMAT_POLICIES); the ring and Ulysses entries
fall back to it without a seq axis.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import ambient_mesh
from dist_mnist_tpu_torch.ops.kernels.flash_attention import flash_attention
from dist_mnist_tpu_torch.ops.nn import checkpoint_name
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention,
)
from dist_mnist_tpu_torch.parallel.collectives import (
    gather_from_model,
    scatter_to_model,
)


def _heads_mesh(q, mesh):
    """The mesh whose model axis shards `q`'s heads, or None to run on
    one device; raises on an indivisible head count."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None or mesh.model <= 1:
        return None
    m, heads = mesh.model, q.shape[2]
    if heads % m:
        raise ValueError(
            f"flash attention on a {m}-way model axis shards the kernel "
            f"over heads (Megatron TP attention) and cannot split a head: "
            f"heads={heads} % model={m} != 0. Use a head count divisible "
            f"by {m}, or attention_impl='xla' (einsums partition without "
            "head granularity)."
        )
    return mesh


def _local_heads(t, mesh):
    """This rank's contiguous head slice of ``[B, S, H, D]``, contiguous
    (the kernels' operands)."""
    return scatter_to_model(t, mesh, 2)


def flash_attention_sharded(q, k, v, block_k=None, *, mesh=None):
    """``[B, S, H, D]`` flash attention (`ops/kernels/flash_attention.py`)
    on the ambient mesh (or `mesh`, a `cluster.mesh.Mesh`): the plain
    kernel without a >1 model axis, this rank's heads and a gather over
    them with one. `block_k` selects the streamed rounding rule."""
    tp = _heads_mesh(q, mesh)
    if tp is None:
        return flash_attention(q, k, v, block_k=block_k)
    out = flash_attention(_local_heads(q, tp), _local_heads(k, tp),
                          _local_heads(v, tp), block_k=block_k)
    return gather_from_model(out, tp, 2)


def flash_attention_tagged(q, k, v, block_k=None, *, mesh=None):
    """`flash_attention_sharded` tagged ``attn_out`` (module
    docstring)."""
    return checkpoint_name(
        flash_attention_sharded(q, k, v, block_k=block_k, mesh=mesh),
        "attn_out")


def masked_flash_attention_sharded(q, k, v, lengths, block_k=None, *,
                                   mesh=None):
    """Variable-length twin: row b attends keys ``[0, lengths[b])``
    (`ops/kernels/masked_flash.py`); the same mesh policy, `lengths`
    following the batch. `block_k` is the reference's and changes nothing
    here: the kernels skip key tiles of their own size. The masked
    kernels take contiguous operands, so strided views (one fused
    projection's q, k, v) are copied first."""
    del block_k
    lengths = lengths.to(torch.int32)
    tp = _heads_mesh(q, mesh)
    if tp is None:
        return masked_flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), lengths)
    out = masked_flash_attention(_local_heads(q, tp), _local_heads(k, tp),
                                 _local_heads(v, tp), lengths)
    return gather_from_model(out, tp, 2)
