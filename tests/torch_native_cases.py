"""The native loader's multi-rank cases, run on every rank of a gloo group
by `torch_ranks.run_ranks`. This module imports the port and never JAX."""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.data.native import NativeBatcher


def native_slices(dataset, global_batch: int, steps: int, axes: dict) -> dict:
    """This rank's `steps` slices of the seeded stream on a mesh of
    `axes`, with its coordinates."""
    mesh = make_mesh(MeshSpec(**axes), device="cpu")
    nb = NativeBatcher(dataset, global_batch, mesh, seed=7)
    try:
        batches = [nb.next_local() for _ in range(steps)]
    finally:
        nb.close()
    return {"rank": torch.distributed.get_rank(), "data": mesh.rank,
            "model": mesh.model_index, "batches": batches}
