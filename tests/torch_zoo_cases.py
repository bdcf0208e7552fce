"""The zoo's sharded-placement cases, run on every rank of a gloo group by
`torch_ranks.run_ranks`: each serves a narrow ViT through
`serve.load_for_serving(mesh=, sharding_rules=)` and `build_zoo_engine`,
the chief (rank 0) predicting the fixed batches while the other ranks
follow. This module imports the port and never JAX."""

from __future__ import annotations

import threading
import time

import torch

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.ops.kernels import launch_counts
from dist_mnist_tpu_torch.serve import build_zoo_engine, load_for_serving
from dist_mnist_tpu_torch.utils.tree import tree_map
from torch_ranks import from_numpy


def serve_on_mesh(cfg, axes: dict, rules: str, batches, *, params=None,
                  checkpoint_dir=None, max_bucket: int = 8,
                  swap_shift: float | None = None) -> dict:
    """`cfg` served over a ``data x model`` mesh of this group under
    `rules`: the chief's logits of each ``(images, heights)`` batch, and
    every rank's resident bytes, cells run and smallest bucket. With
    `swap_shift` the chief then hot-swaps the full weights plus that
    shift (each rank keeps its own slices; the followers take the swap
    through `follow`) while a second thread predicts the first batch
    (`_swap_under_load`), and predicts the batches again."""
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
            if swap_shift is not None:
                full = load_for_serving(cfg, "cpu",
                                        params=from_numpy(params))
                out["under_load"] = _swap_under_load(
                    engine, tree_map(lambda p: p + swap_shift, full.params),
                    full.model_state, batches[0])
                out["logits_swapped"] = [engine.predict(x, heights=h)
                                         for x, h in batches]
        finally:
            engine.close()
    out["version"] = engine.weights_version
    out["cells"] = engine.runs_per_cell()
    out["launches"] = {k: v for k, v in launch_counts().items() if v}
    return out


def _swap_under_load(engine, params, model_state, batch,
                     timeout: float = 120.0) -> list:
    """`engine.swap_weights(params, model_state, version=5)` on this
    thread while another predicts `batch` over and over, from before the
    swap to two batches after it (the batcher beside a POST /swap);
    returns that thread's logits in order."""
    x, h = batch
    got, errors = [], []
    first, stop = threading.Event(), threading.Event()

    def load():
        try:
            while not stop.is_set():
                got.append(engine.predict(x, heights=h))
                first.set()
        except BaseException as err:  # noqa: BLE001 — raised below
            errors.append(err)
            first.set()

    t = threading.Thread(target=load, name="SwapLoad", daemon=True)
    t.start()
    try:
        if not first.wait(timeout):
            raise TimeoutError("no predict before the swap")
        engine.swap_weights(params, model_state, version=5)
        after, deadline = len(got) + 2, time.monotonic() + timeout
        while len(got) < after and not errors \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout)
    if errors:
        raise errors[0]
    if t.is_alive():
        raise TimeoutError("the predicting thread did not finish")
    return got


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
