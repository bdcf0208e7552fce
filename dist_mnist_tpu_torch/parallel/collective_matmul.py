"""Collective matmul: a collective decomposed into ring hops interleaved
with chunk matmuls (port of the reference `parallel/collective_matmul.py`).

A Megatron layer needs ``all_gather(x) @ W_col`` before the column-
parallel matmul and a reduce(-scatter) after the row-parallel one. Done
as one collective and one matmul they serialize. The decomposition runs
the collective as its ring steps (one `collectives.ring_shift` hop a
step) and matmuls the chunk already resident beside each hop. Here each
hop is a blocking point-to-point exchange, so nothing overlaps: the two
functions are the schedule and its arithmetic. The FSDP overlap
(`parallel/overlap.py`) takes the same ring for its ``chunk="ring"``
gathers and overlaps the asynchronous all-gathers instead. No config
calls them.

Both use one counter-clockwise ring (`ring_shift(..., reverse=True)`: rank
i receives rank i+1's block); `axis` is any mesh axis. Autograd
differentiates through them (the shift's backward is the opposite
shift).
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import MODEL_AXIS, Mesh
from dist_mnist_tpu_torch.parallel.collectives import ring_shift


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                     axis: str = MODEL_AXIS) -> torch.Tensor:
    """``all_gather(x, axis) @ w`` as ring steps.

    x: this rank's ``[m, D]`` rows (rank i holds rows ``i*m:(i+1)*m`` of
      the ``[n*m, D]`` whole).
    w: this rank's ``[D, F/n]`` columns.
    Returns ``[n*m, F/n]``: every row against this rank's columns, one
    row block a step, the x blocks rotating around the ring between the
    steps."""
    n = mesh.shape[axis]
    i = mesh.axis_index(axis)
    blocks: list = [None] * n
    buf = x
    for k in range(n):
        # buf holds block (i + k) % n
        blocks[(i + k) % n] = buf @ w
        if k < n - 1:
            buf = ring_shift(buf, mesh, axis=axis, reverse=True)
    return torch.cat(blocks)


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                         axis: str = MODEL_AXIS) -> torch.Tensor:
    """``reduce_scatter(x @ w, axis)`` as ring steps.

    x: this rank's ``[M, D/n]`` (its columns of the whole x).
    w: this rank's ``[D/n, F]`` (its rows of the whole w).
    Returns this rank's ``[M/n, F]`` row block of the whole product. The
    full local partial ``x @ w`` is never built: each step matmuls one
    row block of x against w and adds it to the accumulator arriving
    around the ring; after n - 1 hops each block is home, summed over
    every rank."""
    n = mesh.shape[axis]
    i = mesh.axis_index(axis)
    rows = x.shape[0]
    if rows % n:
        raise ValueError(f"rows {rows} not divisible by {axis}={n}")
    m = rows // n

    def chunk_dot(idx: int) -> torch.Tensor:
        return x[idx * m:(idx + 1) * m] @ w  # [m, F], a partial sum

    # at step s the accumulator on rank i holds the partial sum for row
    # block (i + 1 + s) % n
    acc = chunk_dot((i + 1) % n)
    for s in range(1, n):
        acc = ring_shift(acc, mesh, axis=axis, reverse=True)
        acc = acc + chunk_dot((i + 1 + s) % n)
    return acc
