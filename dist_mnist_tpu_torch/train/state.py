"""TrainState — everything a training job's next step depends on (port
of the reference `train/state.py`).

`step` is an int32 tensor on the device (the global step), `params` the
f32 master weights, `opt_state` the optimizer's slots and counter. The
reference's base PRNG key becomes `rng`, one `torch.Generator` on the
device from which every step draws its batch indices, then its dropout
mask; ``rng.get_state()`` is the bytes a checkpoint keeps and
``rng.set_state()`` restores them exactly. A step returns a new
TrainState and draws from the same generator.

On a mesh, every rank holds the same state, except that under FSDP each
sharded leaf is this rank's slice; `placement`
(`parallel.sharding.Placement`, None for a state never placed) says
which leaves those are and along which dim.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from dist_mnist_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int32 scalar on the device
    params: Any  # f32 master weights
    model_state: Any  # {} for stateless models
    opt_state: Any  # optimizer slots (Adam m/v + count)
    rng: torch.Generator  # batch sampling and dropout, on the device
    placement: Any = None  # parallel.sharding.Placement, or None

    @property
    def step_int(self) -> int:
        """The step as a host int; it waits for the device, so only cold
        paths (logging, checkpoints) call it."""
        return int(self.step.item())


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def state_memory_bytes(state: TrainState) -> dict:
    """Bytes this rank's device holds for the resident state under its
    actual placement: params, optimizer slots (and counter) and model
    state, and their total. A replicated leaf costs its full size on
    every rank, an FSDP leaf its 1/N slice."""
    out = {
        "param_bytes": _nbytes(state.params),
        "opt_state_bytes": _nbytes(state.opt_state),
        "model_state_bytes": _nbytes(state.model_state),
    }
    out["total_bytes"] = sum(out.values())
    return out


def params_digest(params) -> str:
    """sha256 of every leaf's bytes in the tree's leaf order (on the
    host): equal digests mean bit-equal params."""
    h = hashlib.sha256()
    for x in leaves(params):
        h.update(x.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


def _seeds(seed: int) -> tuple[int, int]:
    """Two independent 63-bit seeds (init, loop) from one: the reference
    splits its key in two."""
    init, loop = np.random.SeedSequence(seed).spawn(2)
    return (int(init.generate_state(1, np.uint64)[0] >> np.uint64(1)),
            int(loop.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def create_train_state(model, optimizer, seed: int, sample_input,
                       device: torch.device | str) -> TrainState:
    """The initial state: params drawn on the CPU from the init seed (the
    same numbers whatever the device), moved to `device`; the loop
    generator seeded on `device`."""
    device = torch.device(device)
    init_seed, loop_seed = _seeds(seed)
    params, model_state = model.init(
        torch.Generator().manual_seed(init_seed),
        torch.as_tensor(np.asarray(sample_input)))
    params = tree_map(lambda p: p.to(device), params)
    model_state = tree_map(lambda x: x.to(device), model_state)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        model_state=model_state,
        opt_state=optimizer.init(params),
        rng=torch.Generator(device=device).manual_seed(loop_seed),
    )
