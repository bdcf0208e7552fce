"""Config -> servable model (port of the reference `serve/loader.py`).

`load_for_serving` serves the params it is given (e.g. carried across
from the reference with `convert.params_from_jax`), or a fresh init
seeded from the config, then applies the load-time int8 transform
(`quantize_for_serving`) when asked. Checkpoint restore joins with the
port of `checkpoint/manager.py`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import torch

from dist_mnist_tpu_torch.configs import Config, get_config
from dist_mnist_tpu_torch.data.datasets import DATASETS
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.ops.quant import error_report, quantize_tree
from dist_mnist_tpu_torch.utils.device import resolve_device
from dist_mnist_tpu_torch.utils.tree import tree_map

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServingBundle:
    model: Any
    params: Any
    model_state: Any
    image_shape: tuple[int, ...]
    step: int  # train step the weights came from; 0 on fresh init
    restored: bool
    #: weight-only quant mode ("int8") when `params` was converted at load
    #: time; None = full-width float weights
    quant: str | None = None
    #: ops/quant.error_report of the conversion
    quant_report: dict | None = None


def quantize_for_serving(params, *, mode: str = "int8"):
    """The load-time param transform: float params -> (int8 weights, f32
    scales) tree + per-leaf error report."""
    if mode != "int8":
        raise ValueError(f"unsupported quant mode {mode!r} "
                         "(supported: 'int8')")
    qparams = quantize_tree(params)
    return qparams, error_report(params, qparams)


def load_for_serving(
    cfg: Config | str,
    device: str | torch.device | None = None,
    *,
    quant: str | None = None,
    params=None,
) -> ServingBundle:
    """Everything `InferenceEngine` needs from a config. `params` (float,
    reference layouts) are served as given; without them the model is
    freshly initialized from `torch.Generator().manual_seed(cfg.seed)`."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    device = resolve_device(device)
    model = get_model(cfg.model, **cfg.model_kwargs)
    image_shape = tuple(DATASETS[cfg.dataset]["image_shape"])
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params, model_state = model.init(gen, torch.zeros(1, *image_shape))
        log.info("serving a FRESH init (seed %d)", cfg.seed)
    else:
        model_state = {}
    params = tree_map(lambda t: t.to(device), params)
    quant_report = None
    if quant:
        params, quant_report = quantize_for_serving(params, mode=quant)
        log.info(
            "quantized %d leaves to %s for serving (max rel err %.2e)",
            quant_report["n_quantized"], quant,
            quant_report["max_rel_err"])
    return ServingBundle(
        model=model,
        params=params,
        model_state=model_state,
        image_shape=image_shape,
        step=0,
        restored=False,
        quant=quant or None,
        quant_report=quant_report,
    )
