"""`compile_cache_key_fields` — everything that changes the compiled
step program, as a flat dict (a copy of the reference
`compilecache/key_fields.py`). It lives apart from `cli/train.py` so
that processes other than the trainer (`cli/serve.py`, the benches) can
build the key without importing the training CLI. This module is
import-pure: no flags, no torch. `cli/train.py` re-exports the name.

The fields are the reference's, the overlap knobs among them, so that a
test can hold this dict equal to the reference's for the same config. In
the port an eager step compiles nothing; the store keys the kernel
libraries (`compilecache/store.py`), and these fields describe the run
that loads them.
"""

from __future__ import annotations

__all__ = ["compile_cache_key_fields"]


def compile_cache_key_fields(cfg, mesh, *, scan_chunk=0,
                             input_pipeline="python", quant="none"):
    """Everything that changes the compiled step program, as a flat dict —
    the ExecutableStore key is `cache_key({"kind": ..., **fields})`. The
    overlap knobs are in here so a cached serial executable can never be
    served to an overlapped run (or vice versa): the two lower to different
    HLO even though they are value-identical. `quant` likewise: an int8
    weight-only program takes (int8, scale) weight arguments, so it can
    never satisfy a float key (or vice versa); "none" keeps the field OUT
    of the payload entirely — every pre-quant disk key stays warm."""
    fields = {
        "config": cfg.name,
        "model": cfg.model,
        "model_kwargs": cfg.model_kwargs,
        "batch_size": cfg.batch_size,
        "optimizer": cfg.optimizer,
        "loss": cfg.loss,
        "remat": cfg.remat,
        "remat_policy": cfg.remat_policy,
        "augment": cfg.augment,
        "mesh": tuple(sorted(mesh.shape.items())),
        "sharding": cfg.sharding_rules,
        "overlap": cfg.overlap,
        "overlap_bucket_mb": cfg.overlap_bucket_mb,
        "overlap_chunk": cfg.overlap_chunk,
        "dtype": "float32",
        "donate": True,
        "scan_chunk": scan_chunk,
        "input_pipeline": input_pipeline,
        "prng": cfg.prng_impl,
        # the optimizer chain closes over these as Python scalars, so they
        # are constant-folded into the jitted update: a cached executable
        # from a different schedule/regularization would train wrong —
        # silently. Likewise dataset (input shapes) and
        # replicas_to_aggregate (accumulation loop structure).
        "dataset": cfg.dataset,
        "train_steps": cfg.train_steps,
        "learning_rate": cfg.learning_rate,
        "lr_schedule": cfg.lr_schedule,
        "warmup_steps": cfg.warmup_steps,
        "replicas_to_aggregate": cfg.replicas_to_aggregate,
        "grad_clip_norm": cfg.grad_clip_norm,
        "weight_decay": cfg.weight_decay,
    }
    if quant and quant != "none":
        fields["quant"] = quant
    return fields
