"""Carry weights across from the reference package.

`params_from_jax` takes the reference's param tree as host numpy arrays
(e.g. from `jax.device_get(params)`) and returns the port's: the same
nested dicts with torch tensors, in the SAME layouts (HWIO conv kernels,
``[in, out]`` dense kernels), so `ops.quant.quantize` reduces over the
same axes and yields the same int8 bits. Fresh inits of the two packages
differ (different generators); every parity check starts from weights
carried across by this function.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_mnist_tpu_torch.utils.tree import tree_map


def params_from_jax(tree, device: str | torch.device = "cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
