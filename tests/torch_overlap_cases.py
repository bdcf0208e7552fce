"""The overlap schedule's cases (`parallel/overlap.py`), run on every rank
of a gloo group by `torch_ranks.run_ranks`. Each takes numpy inputs and
returns numpy results; this module imports the port and never JAX."""

from __future__ import annotations

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import DATA_AXIS, MeshSpec, make_mesh
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.models.resnet import ResNet20
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.overlap import (
    OverlapConfig,
    StepGather,
    plan_stats,
    prefetched_layer_matmul,
)
from dist_mnist_tpu_torch.parallel.sharding import (
    FSDP_RULES,
    FSDP_TP_RULES,
    gather_tree,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.train import TrainState, make_train_step
from dist_mnist_tpu_torch.utils.tree import flatten_with_path
from torch_ranks import to_numpy

#: the schedules every case runs: the plain FSDP step (None), the serial
#: twin, the overlapped one and its ring gather
SCHEDULES = ("plain", "serial", "overlapped", "ring")
#: the narrow ViT of the FSDP x TP case (f32, the stacked layout)
VIT_KW = dict(dim=32, depth=2, heads=4, patch=8, scan_blocks=True,
              compute_dtype=torch.float32)


def overlap_config(name: str, bucket_mb: float):
    """The `OverlapConfig` of a schedule name (None: the plain step)."""
    if name == "plain":
        return None
    return OverlapConfig(bucket_mb=bucket_mb, serial=name == "serial",
                         chunk="ring" if name == "ring" else "all_gather")


def _state(params_np, model_state_np, opt):
    params = params_from_jax(params_np)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      model_state=params_from_jax(model_state_np),
                      opt_state=opt.init(params),
                      rng=torch.Generator().manual_seed(0))


def _local(arr, mesh):
    n = arr.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        arr[mesh.rank * n:(mesh.rank + 1) * n]))


def _batch(b, mesh):
    return {"image": _local(b["image"], mesh), "label": _local(b["label"],
                                                                mesh)}


def run_schedule(model, opt, case: dict, mesh, rules, name: str,
                 bucket_mb: float, *, masks=None, **step_kw) -> dict:
    """`case`'s batches through one schedule from its init: each step's
    loss, the collectives of one step (the first), the final params and
    the placed state's plan."""
    cfg = overlap_config(name, bucket_mb)
    state = shard_train_state(
        _state(case["params"], case.get("model_state", {}), opt), mesh,
        rules)
    step = make_train_step(model, opt, mesh=mesh, rules=rules, overlap=cfg,
                           **step_kw)
    stats = collectives.collective_stats(mesh)
    losses, one_step = [], None
    for i, b in enumerate(case["batches"]):
        before = dict(stats)
        kw = {}
        if masks is not None:  # [depth, batch, ...]: this rank's rows
            n = masks[i].shape[1] // mesh.size
            kw["dropout_mask"] = torch.from_numpy(np.ascontiguousarray(
                masks[i][:, mesh.rank * n:(mesh.rank + 1) * n]))
        state, m = step(state, _batch(b, mesh), **kw)
        if one_step is None:
            one_step = {k: v - before.get(k, 0) for k, v in stats.items()
                        if v - before.get(k, 0)}
        losses.append(np.float32(m["loss"].item()))
    out = {"losses": np.array(losses), "collectives": one_step,
           "params": to_numpy(unshard_state(state).params)}
    if cfg is not None:
        out["plan"] = plan_stats(state.params, mesh, rules, cfg,
                                 specs=state.placement.specs.params)
    return out


def gather_identity(case: dict, mesh, bucket_mb: float) -> dict:
    """Every leaf `StepGather.params()` gives (bucket by bucket, the
    overlapped schedule) against `gather_tree`'s one flat gather: the
    same shapes and bits."""
    opt = optim.adam(1e-3)
    state = shard_train_state(_state(case["params"], {}, opt), mesh,
                              FSDP_RULES)
    specs = state.placement.specs.params
    want = gather_tree(state.params, specs, mesh, axes=(DATA_AXIS,))
    got = StepGather(state.params, specs, mesh, FSDP_RULES,
                     OverlapConfig(bucket_mb=bucket_mb)).params()
    return {"/".join(map(str, p)): (tuple(a.shape) == tuple(
                got[p[0]][p[1]].shape)
                and torch.equal(a, got[p[0]][p[1]]))
            for p, a in flatten_with_path(want)}


def prefetch(spec: dict, mesh) -> dict:
    """`prefetched_layer_matmul` against the serial loop (each layer's
    slices gathered, then its matmul) on this rank's rows and slices."""
    ws, x = spec["ws"], spec["x"]
    n, d = mesh.size, ws.shape[2]
    local_ws = torch.from_numpy(np.ascontiguousarray(
        ws[:, mesh.rank * d // n:(mesh.rank + 1) * d // n]))
    h = _local(x, mesh)
    got = prefetched_layer_matmul(h, local_ws, mesh)
    for w_shard in local_ws:
        w = collectives.gather_leaves([w_shard], [0], mesh)[0]
        h = torch.tanh(h @ w)
    return {"got": got.numpy(), "serial": h.numpy()}


def two_rank_cases(spec: dict) -> dict:
    """Every data = 2 case in one group: the MLP under the four
    schedules, ResNet-20 (synchronized batch norm, the card's path)
    under three, the gather's identity and the layer prefetch."""
    mesh = make_mesh(MeshSpec(data=-1), device="cpu")
    out = {"rank": mesh.rank}
    model = MLP(hidden_units=spec["mlp"]["hidden"])
    out["mlp"] = {name: run_schedule(model, optim.adam(1e-3), spec["mlp"],
                                     mesh, FSDP_RULES, name,
                                     spec["bucket_mb"])
                  for name in SCHEDULES}
    resnet = ResNet20(compute_dtype=torch.float32)
    out["resnet"] = {name: run_schedule(resnet, optim.adam(1e-3),
                                        spec["resnet"], mesh, FSDP_RULES,
                                        name, spec["bucket_mb"],
                                        augment=True)
                     for name in ("plain", "overlapped", "ring")}
    out["identity"] = gather_identity(spec["mlp"], mesh, spec["bucket_mb"])
    out["prefetch"] = prefetch(spec["prefetch"], mesh)
    return out


def four_rank_cases(spec: dict) -> dict:
    """FSDP x TP on data = 2 x model = 2: the narrow ViT (remat, the
    reference's dropout masks) and the MLP, whose leaves no TP rule
    matches, each plain and overlapped."""
    mesh = make_mesh(MeshSpec(data=2, model=2), device="cpu")
    out = {"rank": mesh.rank, "model_index": mesh.model_index}
    vit = ViTTiny(**VIT_KW)
    out["vit"] = {name: run_schedule(vit, optim.adam(1e-3), spec["vit"],
                                     mesh, FSDP_TP_RULES, name,
                                     spec["vit"]["bucket_mb"],
                                     masks=spec["vit"]["masks"], remat=True)
                  for name in ("plain", "overlapped")}
    model = MLP(hidden_units=spec["mlp"]["hidden"])
    out["mlp"] = {name: run_schedule(model, optim.adam(1e-3), spec["mlp"],
                                     mesh, FSDP_TP_RULES, name,
                                     spec["bucket_mb"])
                  for name in ("plain", "overlapped")}
    return out
