"""The zoo's sharded-placement cases, run on every rank of a gloo group by
`torch_ranks.run_ranks`: each serves a narrow ViT through
`serve.load_for_serving(mesh=, sharding_rules=)` and `build_zoo_engine`,
the chief (rank 0) predicting the fixed batches while the other ranks
follow. This module imports the port and never JAX."""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.ops.kernels import launch_counts
from dist_mnist_tpu_torch.serve import build_zoo_engine, load_for_serving
from torch_ranks import from_numpy


def serve_on_mesh(cfg, axes: dict, rules: str, batches, *, params=None,
                  checkpoint_dir=None, max_bucket: int = 8) -> dict:
    """`cfg` served over a ``data x model`` mesh of this group under
    `rules`: the chief's logits of each ``(images, heights)`` batch, and
    every rank's resident bytes, cells run and smallest bucket."""
    mesh = make_mesh(MeshSpec(**axes), device="cpu")
    bundle = load_for_serving(
        cfg, "cpu", params=None if params is None else from_numpy(params),
        checkpoint_dir=checkpoint_dir, mesh=mesh, sharding_rules=rules)
    engine = build_zoo_engine(bundle, "cpu", model_name=cfg.model,
                              max_bucket=max_bucket, seq_buckets="auto")
    out = {"rank": torch.distributed.get_rank(),
           "bytes": engine.state_bytes_per_device(),
           "buckets": engine.buckets(), "restored": bundle.restored}
    if engine.is_follower:
        out["calls"] = engine.follow()
    else:
        try:
            out["logits"] = [engine.predict(x, heights=h)
                             for x, h in batches]
        finally:
            engine.close()
    out["cells"] = engine.runs_per_cell()
    out["launches"] = {k: v for k, v in launch_counts().items() if v}
    return out


def zoo_cases(runs: list) -> list:
    """`serve_on_mesh(*args, **kwargs)` for each ``(args, kwargs)`` of
    `runs` whose mesh fits this group, in order."""
    world = torch.distributed.get_world_size()
    out = []
    for args, kwargs in runs:
        axes = args[1]
        if axes.get("data", 1) * axes.get("model", 1) == world:
            out.append(serve_on_mesh(*args, **kwargs))
    return out
