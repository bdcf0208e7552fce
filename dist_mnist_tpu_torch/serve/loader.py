"""Config -> servable model (port of the reference `serve/loader.py`).

`load_for_serving` serves the params it is given (e.g. carried across
from the reference with `convert.params_from_jax`), or the weights of a
committed checkpoint step (`checkpoint_dir`, `step`; restored through
`CheckpointManager.restore_weights`, which builds no optimizer), or a
fresh init seeded from the config, then applies the load-time int8
transform (`quantize_for_serving`) when asked; `init_lm_for_serving` is
the decode side's seam for a registry causal LM.

On a `mesh` of several ranks the weights are placed by the serve rules,
the config's unless `sharding_rules` overrides them (a cross-strategy
restore: an fsdp-trained checkpoint served under tp, say). The port's
checkpoints hold full-shape leaves, so each rank restores them whole and
keeps only its shard (`parallel/sharding.derive_state_specs` and
`shard_tree`); the bundle carries the rules, the mesh and the specs.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import torch

from dist_mnist_tpu_torch.configs import Config, get_config
from dist_mnist_tpu_torch.data.datasets import DATASETS
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.ops.quant import error_report, quantize_tree
from dist_mnist_tpu_torch.parallel.sharding import (
    ShardingRules,
    derive_state_specs,
    resolve_rules,
    shard_tree,
)
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
    #: the serve placement: rules, mesh and per-leaf specs (None: every
    #: leaf whole on one device)
    rules: Any = None
    mesh: Any = None
    specs: Any = None


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
    checkpoint_dir: str | Path | None = None,
    step: int | None = None,
    mesh=None,
    sharding_rules=None,
) -> ServingBundle:
    """Everything `InferenceEngine` needs from a config. `params` (float,
    reference layouts) are served as given; else the weights of `step`
    (None: the latest committed step) under `checkpoint_dir` when it
    holds one; else a fresh init from
    `torch.Generator().manual_seed(cfg.seed)`. On a `mesh` of several
    ranks each keeps its shard under `sharding_rules` (a name or a
    `ShardingRules`; default the config's) on the mesh's device."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    rules = sharding_rules if isinstance(sharding_rules, ShardingRules) \
        else resolve_rules(sharding_rules or cfg.sharding_rules)
    sharded = mesh is not None and mesh.ranks > 1
    device = mesh.device if sharded else resolve_device(device)
    model = get_model(cfg.model, **cfg.model_kwargs)
    image_shape = tuple(DATASETS[cfg.dataset]["image_shape"])
    ckpt_step, restored = 0, None
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params, model_state = model.init(gen, torch.zeros(1, *image_shape))
        if checkpoint_dir is not None and Path(checkpoint_dir).exists():
            from dist_mnist_tpu_torch.checkpoint.manager import (
                CheckpointManager,
            )

            mgr = CheckpointManager(checkpoint_dir, async_save=False)
            try:
                # the fresh init is the template: structure, shapes, dtypes
                restored = mgr.restore_weights(params, model_state,
                                               step=step, device=device)
            finally:
                mgr.close()
        if restored is not None:
            ckpt_step, params, model_state = restored
            log.info("serving weights from step %d of %s", ckpt_step,
                     checkpoint_dir)
        else:
            if checkpoint_dir is not None:
                log.warning("no checkpoint under %s; serving a FRESH init",
                            checkpoint_dir)
            log.info("serving a FRESH init (seed %d)", cfg.seed)
    else:
        model_state = {}
    specs = None
    if sharded:
        # every rank holds the same full leaves here; keep this rank's
        specs = derive_state_specs(SimpleNamespace(
            params=params, model_state=model_state, opt_state={}), mesh,
            rules)
        params = shard_tree(params, specs.params, mesh)
        model_state = shard_tree(model_state, specs.model_state, mesh)
    params = tree_map(lambda t: t.to(device), params)
    model_state = tree_map(lambda t: t.to(device), model_state)
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
        step=ckpt_step,
        restored=restored is not None,
        quant=quant or None,
        quant_report=quant_report,
        rules=rules,
        mesh=mesh if sharded else None,
        specs=specs,
    )


def init_lm_for_serving(model_name: str, *, seed: int = 0,
                        **model_overrides):
    """(model, params) for a registry causal LM (serve/decode.py).

    The synthetic-token decode workload has no checkpoint lineage yet, so
    the params are a fresh init from ``torch.Generator().manual_seed(
    seed)`` — two engines built with the same seed serve the same
    weights. Params stay on the host; the decode engine places them."""
    model = get_model(model_name, **model_overrides)
    if not hasattr(model, "decode_step"):
        raise ValueError(
            f"model {model_name!r} has no decode surface (decode_step/"
            "prefill/init_cache) — decode serving needs a causal LM")
    params, _state = model.init(torch.Generator().manual_seed(seed))
    return model, params
