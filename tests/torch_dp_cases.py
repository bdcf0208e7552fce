"""The port's data-parallel cases, run on every rank of a gloo group by
`torch_ranks.run_ranks` (and on one process by the tests themselves, for
the one-rank comparisons). Each takes numpy inputs and returns numpy
results; this module imports the port and never JAX."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data.datasets import Dataset
from dist_mnist_tpu_torch.data.pipeline import DeviceDataset, ShardedBatcher
from dist_mnist_tpu_torch.models.lenet import LeNet5
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.models.resnet import ResNet20
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.collectives import make_explicit_dp_step
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    FSDP_RULES,
    reshard_state,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.train import (
    TrainState,
    create_train_state,
    evaluate,
    make_eval_step,
    make_fused_train_step,
    make_train_step,
    state_memory_bytes,
)
from dist_mnist_tpu_torch.utils.tree import flatten_with_path
from torch_ranks import to_numpy


def _mesh():
    return make_mesh(MeshSpec(data=-1), device="cpu")


def _rows(arr, mesh):
    n = arr.shape[0] // mesh.size
    return arr[mesh.rank * n:(mesh.rank + 1) * n]


def _batch(batch_np, mesh):
    return {"image": torch.from_numpy(np.ascontiguousarray(
                _rows(batch_np["image"], mesh))),
            "label": torch.from_numpy(np.ascontiguousarray(
                _rows(batch_np["label"], mesh), np.int32))}


def _state(params_np, model_state_np, optimizer, seed=0):
    params = params_from_jax(params_np)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      model_state=params_from_jax(model_state_np),
                      opt_state=optimizer.init(params),
                      rng=torch.Generator().manual_seed(seed))


def _delta(new, old):
    """new - old per leaf (under sgd(1.0): minus the gradient)."""
    return {"/".join(map(str, p)): (a - b).numpy() for (p, a), (_, b) in zip(
        flatten_with_path(new), flatten_with_path(old))}


def dp_steps(spec: dict) -> dict:
    """One synchronous DP step of LeNet-5 and of ResNet-20 (f32 compute,
    `sgd(1.0)`, so the update is minus the mean gradient) on this rank's
    slice of the global batch, and ResNet-20 through the per-replica-BN
    explicit step."""
    mesh = _mesh()
    out = {}
    sgd = optim.sgd(1.0)
    lenet = LeNet5(compute_dtype=torch.float32)
    st = _state(spec["lenet"]["params"], {}, sgd)
    new, m = make_train_step(lenet, sgd, mesh=mesh)(
        st, _batch(spec["lenet"]["batch"], mesh),
        dropout_mask=torch.from_numpy(np.array(_rows(spec["lenet"]["mask"],
                                                     mesh))))
    out["lenet"] = {"loss": float(m["loss"]), "accuracy": float(
        m["accuracy"]), "delta": _delta(new.params, st.params)}
    resnet = ResNet20(compute_dtype=torch.float32)
    for name, make in (("resnet", lambda: make_train_step(resnet, sgd,
                                                          mesh=mesh)),
                       ("resnet_per_replica_bn",
                        lambda: make_explicit_dp_step(resnet, sgd, mesh))):
        st = _state(spec["resnet"]["params"], spec["resnet"]["model_state"],
                    sgd)
        new, m = make()(st, _batch(spec["resnet"]["batch"], mesh))
        out[name] = {"loss": float(m["loss"]),
                     "accuracy": float(m["accuracy"]),
                     "delta": _delta(new.params, st.params),
                     "model_state": to_numpy(new.model_state)}
    return out


def _dataset(d: dict) -> Dataset:
    return Dataset(name=d["name"], train_images=d["train_images"],
                   train_labels=d["train_labels"],
                   test_images=d["test_images"],
                   test_labels=d["test_labels"], num_classes=10,
                   synthetic=True)


def draws(spec: dict) -> dict:
    """Fused steps that draw everything from the state's generator: the
    sampled rows, ResNet-20's crops and flips, LeNet-5's dropout. The
    same on 1, 2 or 4 ranks: each rank draws the global batch's numbers
    and keeps its slice. Also `evaluate` of the final ResNet state."""
    mesh = _mesh()
    out = {}
    for name, model, data_key in (
            ("resnet", ResNet20(compute_dtype=torch.float32), "cifar"),
            ("lenet", LeNet5(compute_dtype=torch.float32), "mnist")):
        ds = _dataset(spec[data_key])
        opt = optim.adam(1e-3)
        state = create_train_state(model, opt, 7, ds.train_images[:1], "cpu")
        step = make_fused_train_step(model, opt, DeviceDataset(ds, "cpu",
                                                                mesh=mesh),
                                     8, mesh=mesh, augment=name == "resnet")
        losses_ = []
        for _ in range(3):
            state, m = step(state)
            losses_.append(float(m["loss"]))
        out[name] = {"losses": losses_, "params": to_numpy(
            unshard_state(state).params)}
        if name == "resnet":
            out["eval"] = evaluate(make_eval_step(model), state,
                                   ds.test_images, ds.test_labels,
                                   batch_size=10)
    return out


def _mlp_states(ds, rules, mesh, opt):
    model = MLP(hidden_units=64)
    base = create_train_state(model, opt, 0, ds.train_images[:1], "cpu")
    return model, shard_train_state(base, mesh, rules)


def fsdp(spec: dict, ckpt_root: str) -> dict:
    """FSDP against DP: two epochs of the host batcher (MLP, hidden 64),
    three ResNet-20 steps of its config's optimizer (clip + cosine Adam),
    per-rank state bytes, the checkpoint round trip DP -> FSDP -> DP,
    evaluation, and the MemoryHook's numbers."""
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import MemoryHook

    mesh = _mesh()
    ds = _dataset(spec["mnist"])
    out: dict = {"rank": mesh.rank}
    for name, rules in (("dp", DP_RULES), ("fsdp", FSDP_RULES)):
        opt = optim.adam(1e-3)
        model, state = _mlp_states(ds, rules, mesh, opt)
        out[f"{name}_bytes"] = state_memory_bytes(state)
        step = make_train_step(model, opt, mesh=mesh)
        batches = iter(ShardedBatcher(ds, 64, "cpu", seed=0, mesh=mesh))
        traj = []
        for _ in range(2 * (len(ds.train_labels) // 64)):
            state, m = step(state, next(batches))
            traj.append(float(m["loss"]))
        out[f"{name}_traj"] = traj
        out[f"{name}_params"] = to_numpy(unshard_state(state).params)
        out[f"{name}_eval"] = evaluate(make_eval_step(model), state,
                                       ds.test_images, ds.test_labels,
                                       batch_size=100)
        if name == "fsdp":
            hook = MemoryHook(None, every_steps=10)

            class _Loop:
                initial_step = 0

            _Loop.state = state
            hook.begin(_Loop())
            out["memory_hook"] = dict(hook.last)
            out["fsdp_state_bytes_now"] = state_memory_bytes(state)
            # the round trip DP -> FSDP -> DP: saved under DP, restored
            # under FSDP, saved again, restored under DP
            src = dataclasses.replace(
                state, step=torch.tensor(7, dtype=torch.int32))
            trip = []
            for i, (save_rules, load_rules) in enumerate(
                    ((DP_RULES, FSDP_RULES), (FSDP_RULES, DP_RULES))):
                src = reshard_state(src, mesh, save_rules)
                mgr = CheckpointManager(os.path.join(ckpt_root, f"trip{i}"),
                                        async_save=False)
                try:
                    assert mgr.save(src)
                    target = shard_train_state(
                        create_train_state(model, opt, 99, ds.train_images[:1],
                                           "cpu"), mesh, load_rules)
                    restored = mgr.restore(target)
                finally:
                    mgr.close()
                trip.append({
                    "step": restored.step_int,
                    "rules": "fsdp" if restored.placement.rules.fsdp_axis
                    else "dp",
                    "hid_w_shape": tuple(restored.params["hid"]["w"].shape),
                    "slot_shape": tuple(
                        restored.opt_state["m"]["hid"]["w"].shape),
                    "params": to_numpy(unshard_state(restored).params),
                    "opt": to_numpy(unshard_state(restored).opt_state)})
                src = restored
            out["trip"] = trip
            out["trip_src"] = {"params": to_numpy(unshard_state(
                state).params), "opt": to_numpy(unshard_state(
                    state).opt_state)}
            out["chief_wrote"] = sorted(os.listdir(os.path.join(ckpt_root,
                                                                "trip0")))
    # ResNet-20 under its config's optimizer: FSDP against DP
    cfg = get_config("resnet20_cifar")
    cifar = _dataset(spec["cifar"])
    for name, rules in (("dp", DP_RULES), ("fsdp", FSDP_RULES)):
        model = ResNet20(compute_dtype=torch.float32)
        opt = optim.build_optimizer(cfg)
        state = shard_train_state(create_train_state(
            model, opt, 3, cifar.train_images[:1], "cpu"), mesh, rules)
        step = make_fused_train_step(model, opt, DeviceDataset(cifar, "cpu",
                                                                mesh=mesh),
                                     8, mesh=mesh, augment=True)
        traj = []
        for _ in range(3):
            state, m = step(state)
            traj.append(float(m["loss"]))
        out[f"resnet_{name}_traj"] = traj
        out[f"resnet_{name}_params"] = to_numpy(unshard_state(state).params)
        out[f"resnet_{name}_model_state"] = to_numpy(state.model_state)
    # the collectives on their own: gather of a reduce-scatter
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (mesh.rank + 1)
    mine = collectives.reduce_scatter_leaves([x], [0], mesh)[0]
    out["scatter_gather"] = collectives.gather_leaves([mine], [0], mesh)[
        0].numpy()
    out["psum_mean"] = collectives.psum_mean(
        {"a": torch.full((3,), float(mesh.rank))}, mesh)["a"].numpy()
    out["world"] = mesh.size
    return out


def all_cases(spec: dict, ckpt_root: str) -> dict:
    """Every case above in one group (a group's start costs seconds)."""
    return {"dp": dp_steps(spec), "draws": draws(spec),
            "fsdp": fsdp(spec, ckpt_root)}
