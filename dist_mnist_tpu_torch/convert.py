"""Carry weights across from the reference package.

`params_from_jax` takes the reference's param tree as host numpy arrays
(e.g. from `jax.device_get(params)`) and returns the port's: the same
nested dicts with torch tensors, in the SAME layouts (HWIO conv kernels,
``[in, out]`` dense kernels), so `ops.quant.quantize` reduces over the
same axes and yields the same int8 bits. Any nesting is carried leaf for
leaf: a switch-MoE ViT block's ``moe`` tree (the gate ``[D, E]`` and the
expert stacks ``w1``/``b1``/``w2``/``b2``, leading dim E) and the stacked
``blocks`` layout included. Fresh inits of the two packages
differ (different generators); every parity check starts from weights
carried across by this function.

`train_state_from_jax` carries a whole reference `TrainState` across
(params, model state, the optimizer's slots and counters, the step), so
a run can continue in the port from the reference's state. It is one
way: the port never reads the reference's orbax files.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_mnist_tpu_torch.train.state import TrainState, _seeds
from dist_mnist_tpu_torch.utils.tree import tree_map


def params_from_jax(tree, device: str | torch.device = "cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def train_state_from_jax(state, *, seed: int,
                         device: str | torch.device = "cpu") -> TrainState:
    """The port's `TrainState` from a reference one given as numpy trees
    (e.g. `jax.device_get(state)`, or a dict with its fields): ``step``,
    ``params``, ``model_state`` and ``opt_state`` — Adam's and AdamW's
    ``{"m", "v", "count"}`` slots, momentum's ``velocity``, a chain's
    tuple of states — carried leaf for leaf, in the same trees. The
    reference's PRNG key has no torch counterpart: `rng` is the loop
    generator `create_train_state` seeds from `seed` on `device`."""
    get = (state.get if isinstance(state, dict)
           else lambda name: getattr(state, name))
    device = torch.device(device)
    return TrainState(
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32,
                          device=device),
        params=params_from_jax(get("params"), device),
        model_state=params_from_jax(get("model_state"), device),
        opt_state=params_from_jax(get("opt_state"), device),
        rng=torch.Generator(device=device).manual_seed(_seeds(seed)[1]),
    )
