"""The model contract (port of the reference `models/base.py`).

A model is two plain functions over explicit parameter dicts: `init`
builds them from a `torch.Generator`, `apply` is a pure forward. Params
stay float32 (or `QuantizedArray` leaves when served int8); activations
run in `compute_dtype`.
"""

from __future__ import annotations

from typing import Protocol

import torch

Params = dict
State = dict  # mutable model state (BN running stats); {} for stateless models


class Model(Protocol):
    """- ``init(gen, sample_input) -> (params, state)``; only the sample's
      shape is read.
    - ``apply(params, state, x, *, train=False) -> (logits, new_state)``;
      `x` is an NHWC float batch, logits are float32.
    """

    compute_dtype: torch.dtype

    def init(self, gen: torch.Generator,
             sample_input: torch.Tensor) -> tuple[Params, State]: ...

    def apply(self, params: Params, state: State, x: torch.Tensor, *,
              train: bool = False) -> tuple[torch.Tensor, State]: ...
