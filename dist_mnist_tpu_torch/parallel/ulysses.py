"""Ulysses sequence parallelism: an all-to-all head <-> sequence reshard
(port of the reference `parallel/ulysses.py`).

The alternative to ring attention: one all-to-all over the seq group
(`parallel/collectives.all_to_all` over ``seq``) turns each rank's
sequence-sharded ``[B, S/n, H, D]`` into a head-sharded ``[B, S, H/n,
D]``; attention then runs whole on each rank's heads, exact with no
streamed softmax, and a second all-to-all restores the sequence
sharding. It needs H % n == 0. As in the ring's port, one device runs
per process, so the body runs on each rank's own tokens:

- `ulysses_attention_inner(q, k, v, mesh, impl, block_k)`: the body;
- `ulysses_self_attention(q, k, v, mesh, ...)`: the same, checking the
  layout;
- `ulysses_attention(q, k, v, impl, block_k)`: the models' entry, the
  reshard over the ambient mesh's seq axis when it is wider than one,
  else the impl's exact attention on one rank (`flash_attention_tagged`
  for ``impl="flash"``, `ops/nn.dot_product_attention` otherwise).

`impl` picks the local attention over the whole sequence: ``"xla"``
(`ops/nn.dot_product_attention`, which tags its output) or ``"flash"``
(the port's `flash_attention`, the CUDA kernels on the card, its output
tagged ``attn_out`` here, as the reference tags it). Head dims the
kernels are not instantiated for take the next instantiation
(`ops/kernels/flash_attention.padded_head_dim`: 48 runs as 64).
"""

from __future__ import annotations

from dist_mnist_tpu_torch.cluster.mesh import SEQ_AXIS, Mesh, ambient_mesh
from dist_mnist_tpu_torch.ops.kernels.flash_attention import flash_attention
from dist_mnist_tpu_torch.ops.nn import checkpoint_name, dot_product_attention
from dist_mnist_tpu_torch.parallel.collectives import all_to_all

IMPLS = ("xla", "flash")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(
            f"ulysses attention impl {impl!r}: use 'xla' | 'flash'")


def ulysses_attention_inner(q, k, v, mesh: Mesh, impl: str = "xla",
                            block_k: int | None = None):
    """This rank's ``[B, S/n, H, D]`` q, k, v; H % n == 0 (module
    docstring). `block_k` streams K/V tiles in the flash engine."""
    _check_impl(impl)
    n = mesh.seq
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by seq axis {n}")

    def reshard(t):  # scatter heads, gather the sequence
        return all_to_all(t, mesh, axis=SEQ_AXIS, split_axis=2,
                          concat_axis=1)

    if impl == "flash":
        out = checkpoint_name(
            flash_attention(reshard(q), reshard(k), reshard(v),
                            block_k=block_k), "attn_out")
    else:
        out = dot_product_attention(reshard(q), reshard(k), reshard(v))
    return all_to_all(out, mesh, axis=SEQ_AXIS, split_axis=1,
                      concat_axis=2)


def ulysses_self_attention(q, k, v, mesh: Mesh, impl: str = "xla",
                           block_k: int | None = None):
    """Ulysses attention of this rank's ``[B, S/n, H, D]`` share of q, k,
    v over `mesh`'s seq group (the reference's ``P(data, seq, None,
    None)`` layout)."""
    if q.ndim != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(f"ulysses attention wants q, k, v of one [B, S/n, "
                         f"H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return ulysses_attention_inner(q, k, v, mesh, impl=impl, block_k=block_k)


def ulysses_attention(q, k, v, impl: str = "xla",
                      block_k: int | None = None):
    """The models' entry (module docstring): the reshard over the ambient
    mesh's seq axis when it is wider than one, else the impl's exact
    attention of ``[B, S, H, D]`` on this rank."""
    _check_impl(impl)
    mesh = ambient_mesh()
    if mesh is None or mesh.seq == 1:
        if impl == "flash":
            from dist_mnist_tpu_torch.parallel.flash import (
                flash_attention_tagged,
            )

            return flash_attention_tagged(q, k, v, block_k=block_k)
        return dot_product_attention(q, k, v)
    return ulysses_self_attention(q, k, v, mesh, impl=impl, block_k=block_k)
