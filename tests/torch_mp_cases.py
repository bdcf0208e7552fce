"""The port's model-parallel cases (expert parallelism, the block pipeline,
the collective matmul), run on every rank of a gloo group by
`torch_ranks.run_ranks`. Each takes numpy inputs and returns numpy
results; this module imports the port and never JAX."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import (
    PIPE_AXIS,
    MeshSpec,
    activate,
    make_mesh,
)
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.ops import losses
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)
from dist_mnist_tpu_torch.parallel.moe import moe_ffn
from dist_mnist_tpu_torch.parallel.pipeline import pipeline_apply
from dist_mnist_tpu_torch.parallel.sharding import DP_RULES, shard_train_state
from dist_mnist_tpu_torch.train import TrainState, make_train_step
from dist_mnist_tpu_torch.train.step import loss_and_grads
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

#: (capacity_factor, top_k) of the MoE layer cases: generous and tight
#: capacity, Switch and top-2 routing
MOE_CASES = ((4.0, 1), (4.0, 2), (0.5, 1), (1.25, 2))
#: the aux weight of the MoE layer cases' loss (the reference's test)
AUX_W = 0.01
#: (circular_chunks, skip_bubble) of the pipeline cases, 8 microbatches
PIPE_CASES = ((1, False), (1, True), (2, False), (2, True))
PIPE_MB = 8
#: the reference's TestMoEInViT and TestPipelineInViT geometries (f32)
VIT_MOE_KW = dict(depth=1, dim=32, heads=4, patch=8, pool="mean",
                  mlp_impl="moe", n_experts=2, moe_capacity_factor=4.0,
                  compute_dtype=torch.float32)
VIT_MOE_STEP_KW = dict(depth=2, dim=32, heads=4, patch=8, pool="mean",
                       mlp_impl="moe", n_experts=2, dropout_rate=0.0,
                       scan_blocks=True, compute_dtype=torch.float32)
VIT_PP_KW = dict(depth=4, dim=32, heads=4, patch=8, pool="mean",
                 dropout_rate=0.0, scan_blocks=True,
                 compute_dtype=torch.float32)
#: the pipelined ViTs of the forward cases: GPipe and circular
VIT_PP_VARIANTS = {"gpipe": dict(block_pipeline=2, pipeline_microbatches=2),
                   "circular": dict(block_pipeline=2, pipeline_circular=2,
                                    pipeline_microbatches=4)}
#: the small configs the CLI cases run (the config's recipe at this width)
SMALL = dict(depth=4, dim=32, heads=4, patch=8)


def _mesh(**axes):
    return make_mesh(MeshSpec(**axes), device="cpu")


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): x.detach().numpy()
            for p, x in flatten_with_path(tree)}


def _rows(n: int, mesh) -> slice:
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _batch(b: dict, rows: slice) -> dict:
    return {"image": torch.from_numpy(np.ascontiguousarray(b["image"][rows])),
            "label": torch.from_numpy(np.ascontiguousarray(b["label"][rows]))}


def _tracked(params_np) -> dict:
    return {k: v.requires_grad_() for k, v in
            params_from_jax(params_np).items()}


def _stats(mesh) -> dict:
    return dict(mesh.stats)


# -- expert parallelism -------------------------------------------------------

def moe_layer(spec: dict, mesh) -> dict:
    """`moe_ffn` over the mesh's model axis on this data rank's tokens of
    ``spec["x"]``, per `MOE_CASES`: the output (this data rank's rows),
    aux, the stats, the gradients of ``sum(out**2) + AUX_W * aux``
    reduced by the step's rule (the mean over the data ranks), and the
    tokens' gradient."""
    x_all = torch.from_numpy(spec["x"])
    out = {}
    for cf, k in MOE_CASES:
        x = x_all[_rows(x_all.shape[0], mesh)].clone().requires_grad_()
        params = _tracked(spec["params"])
        before = _stats(mesh)
        o, aux, stats = moe_ffn(params, x, mesh, cf, k)
        loss = (o ** 2).sum() + AUX_W * aux
        *grads, x_grad = torch.autograd.grad(
            loss, [*params.values(), x])
        grads = collectives.psum_mean(dict(zip(params, grads)), mesh)
        out[(cf, k)] = {
            "out": o.detach().numpy(), "aux": float(aux),
            "drop_fraction": float(stats["drop_fraction"]),
            "expert_load": stats["expert_load"].numpy(),
            "grads": {n: g.numpy() for n, g in grads.items()},
            "x_grad": x_grad.numpy(),
            "stats": {key: v - before.get(key, 0)
                      for key, v in _stats(mesh).items()}}
    return out


def vit_moe_forward(spec: dict, mesh) -> dict:
    """The MoE ViT (`VIT_MOE_KW`) on this data rank's rows under the mesh:
    logits and the model state."""
    model = ViTTiny(**VIT_MOE_KW)
    x = torch.from_numpy(spec["x"][_rows(spec["x"].shape[0], mesh)])
    with activate(mesh), torch.no_grad():
        logits, state = model.apply(params_from_jax(spec["params"]),
                                    params_from_jax(spec["state"]), x)
    return {"logits": logits.numpy(),
            "state": {k: v.numpy() for k, v in state.items()}}


def _sgd_state(params_np, model_state_np=None):
    params = params_from_jax(params_np)
    opt = optim.sgd(1.0)
    return opt, TrainState(
        step=torch.zeros((), dtype=torch.int32), params=params,
        model_state=params_from_jax(model_state_np or {}),
        opt_state=opt.init(params), rng=torch.Generator().manual_seed(0))


def train_step(spec: dict, model_kw: dict, mesh) -> dict:
    """One remat step of `sgd(1.0)` (the update is minus the gradient) of
    the ViT `model_kw` on this data rank's rows of ``spec["batch"]``: the
    metrics, the params after it and what the step moved."""
    model = ViTTiny(**model_kw)
    opt, state = _sgd_state(spec["params"], spec.get("state"))
    state = shard_train_state(state, mesh, DP_RULES)
    step = make_train_step(model, opt, mesh=mesh, remat=True)
    before = _stats(mesh)
    batch = _batch(spec["batch"], _rows(spec["batch"]["label"].shape[0],
                                        mesh))
    state, metrics = step(state, batch)
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "params": _flat(state.params),
            "stats": {k: v - before.get(k, 0)
                      for k, v in _stats(mesh).items()}}


def collective_matmul(spec: dict, mesh) -> dict:
    """`allgather_matmul` and `matmul_reducescatter` over the model axis on
    this rank's shards of the whole operands, and the gradient of
    ``sum(allgather_matmul(x, w)**2)`` for this rank's columns of w."""
    n, i = mesh.model, mesh.model_index
    x, w = (torch.from_numpy(spec["ag"][k]) for k in "xw")
    rows, cols = x.shape[0] // n, w.shape[1] // n
    ag = allgather_matmul(x[i * rows:(i + 1) * rows],
                          w[:, i * cols:(i + 1) * cols], mesh)
    x2, w2 = (torch.from_numpy(spec["rs"][k]) for k in "xw")
    k = x2.shape[1] // n
    rs = matmul_reducescatter(x2[:, i * k:(i + 1) * k],
                              w2[i * k:(i + 1) * k], mesh)
    xg, wg = (torch.from_numpy(spec["grad"][k]) for k in "xw")
    rows, cols = xg.shape[0] // n, wg.shape[1] // n
    w_mine = wg[:, i * cols:(i + 1) * cols].clone().requires_grad_()
    out = allgather_matmul(xg[i * rows:(i + 1) * rows], w_mine, mesh)
    (g,) = torch.autograd.grad((out ** 2).sum(), [w_mine])
    return {"index": i, "ag": ag.numpy(), "rs": rs.numpy(),
            "w_grad": g.numpy()}


# -- the pipeline -------------------------------------------------------------

def _stage_fn(params, x):
    return torch.relu(x @ params["w"] + params["b"])


def pipeline_stages(spec: dict, mesh) -> dict:
    """`pipeline_apply` of `_stage_fn` per `PIPE_CASES` on this data rank's
    rows of ``spec["x"]``: the output and the gradients of ``sum(out**2)``
    by the step's rule (each pipe rank's loss over the pipe size, the sum
    over the pipe ranks, the mean over the data ranks)."""
    x_all = torch.from_numpy(spec["x"])
    x = x_all[_rows(x_all.shape[0], mesh)]
    out = {}
    for v, skip in PIPE_CASES:
        params = _tracked({k: a[:mesh.pipe * v]
                           for k, a in spec["stages"].items()})
        y = pipeline_apply(_stage_fn, params, x, PIPE_MB, mesh,
                           circular_chunks=v, skip_bubble=skip)
        share = (y ** 2).sum() / mesh.pipe
        grads = dict(zip(params, torch.autograd.grad(
            share, list(params.values()))))
        grads = collectives.sum_over_axis(grads, mesh, PIPE_AXIS)
        grads = collectives.psum_mean(grads, mesh)
        out[(v, skip)] = {"out": y.detach().numpy(),
                          "grads": {n: g.numpy() for n, g in grads.items()}}
    return out


def _reduced_grads(model, params_np, batch, mesh, **kw):
    """The loss and the gradients of `model` on this data rank's batch,
    reduced by the step's rule."""
    with activate(mesh):
        loss, logits, _, grads = loss_and_grads(
            model, losses.softmax_cross_entropy, params_from_jax(params_np),
            {}, batch, **kw)
    for axis in ("seq", PIPE_AXIS):
        grads = collectives.sum_over_axis(grads, mesh, axis)
    grads, loss = collectives.psum_mean(grads, mesh, loss.reshape(1))
    return float(loss[0]), logits, _flat(grads)


def vit_pp_forward_backward(spec: dict, mesh) -> dict:
    """Each pipelined ViT of `VIT_PP_VARIANTS` on this data rank's rows:
    the logits, and the loss and gradients reduced by the step's rule."""
    batch = _batch(spec["batch"], _rows(spec["batch"]["label"].shape[0],
                                        mesh))
    out = {}
    for name, extra in VIT_PP_VARIANTS.items():
        model = ViTTiny(**VIT_PP_KW, **extra)
        loss, logits, grads = _reduced_grads(model, spec["params"], batch,
                                             mesh)
        out[name] = {"loss": loss, "logits": logits.numpy(),
                     "grads": grads}
    return out


def vit_pp_dropout(spec: dict, mesh) -> dict:
    """The pipelined ViT with dropout 0.1 under remat, its keep-masks drawn
    for the global batch from one seed (this data rank's rows kept),
    against the plain stacked ViT on the same rows and masks without a
    pipe axis: the reduced loss and gradients of both, and this rank's
    masks' digest."""
    n = spec["batch"]["label"].shape[0]
    rows = _rows(n, mesh)
    batch = _batch(spec["batch"], rows)
    kw = dict(VIT_PP_KW, dropout_rate=0.1)
    piped = ViTTiny(**kw, **VIT_PP_VARIANTS["gpipe"])
    masks = piped.dropout_masks(torch.Generator().manual_seed(3),
                                torch.zeros(n, 32, 32, 3))[:, rows]
    loss, _, grads = _reduced_grads(piped, spec["params"], batch, mesh,
                                    dropout_mask=masks, remat=True)
    with activate(None):
        _, _, _, plain = loss_and_grads(
            ViTTiny(**kw), losses.softmax_cross_entropy,
            params_from_jax(spec["params"]), {}, batch, dropout_mask=masks)
    plain = collectives.psum_mean(plain, mesh)
    return {"loss": loss, "grads": grads, "plain_grads": _flat(plain),
            "mask_sum": int(masks.sum())}


# -- the training CLI ---------------------------------------------------------

def cli_run(name: str, mesh_spec: MeshSpec, data_dir: str,
            ckpt_root: str) -> dict:
    """`name` through the training CLI's `run_config` at the small width
    (`SMALL`) on `mesh_spec`, 4 steps at batch 8 with a checkpoint at the
    last: the final params' digest and element count, the loss, the
    per-step collectives, launches and metrics."""
    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import Hook
    from dist_mnist_tpu_torch.train.state import params_digest

    rows = []

    class Keep(Hook):
        def after_step(self, step, state, outputs):
            rows.append({k: v.detach().numpy() for k, v in outputs.items()})

    cfg = get_config(name)
    cfg = dataclasses.replace(
        cfg, batch_size=8, train_steps=4, eval_every=0, log_every=2,
        mesh=mesh_spec, model_kwargs={**cfg.model_kwargs, **SMALL})
    state, final, ctx = run_config(
        cfg, device="cpu", data_dir=data_dir,
        checkpoint_dir=os.path.join(ckpt_root, name),
        checkpoint_every_steps=4, extra_hooks=[Keep()])
    return {"step": state.step_int, "loss": final["loss"],
            "digest": params_digest(state.params),
            "param_elements": sum(x.numel() for _, x in
                                  flatten_with_path(state.params)),
            "collectives": ctx["collectives_per_step"],
            "launches": ctx["launches"], "outputs": rows,
            "mesh": dict(ctx["mesh"].shape)}


# -- the groups ---------------------------------------------------------------

def moe4_cases(spec: dict, ckpt_root: str, data_dir: str) -> dict:
    """Every case of the four-rank expert-parallel group: the MoE layer on
    data = 1 x model = 4 and data = 2 x model = 2, the MoE ViT's forward
    and one step on data = 2 x model = 2, the collective matmul over
    model = 4, and `vit_tiny_cifar_moe` through the CLI on model = 4."""
    m4 = _mesh(data=1, model=4)
    d2m2 = _mesh(data=2, model=2)
    return {
        "rank": (d2m2.rank, d2m2.model_index),
        "layer": {"d1m4": moe_layer(spec["layer"]["e4"], m4),
                  "d2m2": moe_layer(spec["layer"]["e2"], d2m2)},
        "vit_forward": vit_moe_forward(spec["vit"], d2m2),
        "step": train_step(spec["step"], VIT_MOE_STEP_KW, d2m2),
        "cmm": collective_matmul(spec["cmm"], m4),
        "cli": cli_run("vit_tiny_cifar_moe", MeshSpec(data=1, model=4),
                       data_dir, ckpt_root),
    }


def pp4_cases(spec: dict, ckpt_root: str, data_dir: str) -> dict:
    """Every case of the four-rank pipeline group: `pipeline_apply` on
    data = 1 x pipe = 4 and data = 2 x pipe = 2, the pipelined ViTs'
    forward and backward, dropout and one step on data = 2 x pipe = 2,
    and `vit_tiny_cifar_pp` through the CLI on pipe = 4."""
    p4 = _mesh(data=1, pipe=4)
    d2p2 = _mesh(data=2, pipe=2)
    return {
        "rank": (d2p2.rank, d2p2.pipe_index),
        "stages": {"d1p4": pipeline_stages(spec["stages"], p4),
                   "d2p2": pipeline_stages(spec["stages"], d2p2)},
        "vit": vit_pp_forward_backward(spec["vit"], d2p2),
        "dropout": vit_pp_dropout(spec["vit"], d2p2),
        "step": train_step(spec["step"],
                           dict(VIT_PP_KW, **VIT_PP_VARIANTS["gpipe"]), d2p2),
        "cli": cli_run("vit_tiny_cifar_pp", MeshSpec(data=1, pipe=4),
                       data_dir, ckpt_root),
    }

