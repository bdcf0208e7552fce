"""The multislice rank layout's cases, run on every rank of a gloo group by
`torch_ranks.run_ranks`. This module imports the port and never JAX."""

from __future__ import annotations

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import (
    AXES,
    MeshSpec,
    SliceTag,
    make_mesh,
    validate_mesh,
    with_fake_slices,
)
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.sharding import shard_train_state
from dist_mnist_tpu_torch.train import create_train_state, make_train_step
from torch_ranks import to_numpy


def _dp_steps(mesh, batch_np: dict, steps: int = 2) -> dict:
    """`steps` DP steps of a narrow MLP (Adam) on this rank's data slice
    of `batch_np`: the final params."""
    model = MLP(hidden_units=16)
    opt = optim.adam(1e-2)
    state = create_train_state(model, opt, 0, torch.zeros(1, 28, 28, 1),
                               "cpu")
    state = shard_train_state(state, mesh)
    step = make_train_step(model, opt, mesh=mesh)
    n = batch_np["label"].shape[0] // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in batch_np.items()}
    for _ in range(steps):
        state, _ = step(state, batch)
    return to_numpy(state.params)


def _layout(mesh) -> dict:
    """This rank's coordinates, each wide axis's group ranks, and a sum
    of the global ranks over each wide axis (a collective on the group)."""
    out = {"coords": (mesh.rank, mesh.model_index, mesh.seq_index,
                      mesh.pipe_index), "groups": {}, "sums": {},
           "model_chief": mesh.model_chief}
    me = torch.tensor([float(torch.distributed.get_rank())])
    for axis in AXES:
        group = mesh.axis_group(axis)
        if group is None:
            continue
        out["groups"][axis] = torch.distributed.get_process_group_ranks(
            group)
        out["sums"][axis] = float(collectives.all_reduce_sum(
            me, mesh, axis)[0])
    return out


def multislice_cases(batch_np: dict) -> dict:
    """On four ranks: the DP steps on a data = 4 mesh over two fake slices
    and on the row-major mesh; the layout of data 2 x pipe 2 over two
    slices whose ranks interleave (slice 0 = ranks 0 and 2), which the
    hybrid layout puts on pipe-major blocks."""
    world = torch.distributed.get_world_size()
    sliced = make_mesh(MeshSpec(data=-1), device="cpu",
                       slices=with_fake_slices(range(world), 2))
    row_major = make_mesh(MeshSpec(data=-1), device="cpu")
    validate_mesh(sliced)
    interleaved = [SliceTag(r, r % 2) for r in range(world)]
    hybrid = make_mesh(MeshSpec(data=2, pipe=2), device="cpu",
                       slices=interleaved)
    validate_mesh(hybrid)
    return {"sliced": _dp_steps(sliced, batch_np),
            "row_major": _dp_steps(row_major, batch_np),
            "sliced_grid": sliced.grid.tolist(),
            "hybrid_grid": hybrid.grid.tolist(),
            "hybrid": _layout(hybrid)}
