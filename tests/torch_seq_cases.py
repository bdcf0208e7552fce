"""The port's sequence-parallel cases, run on every rank of a gloo group by
`torch_ranks.run_ranks` (and on one process by the tests themselves, for
the one-rank comparisons). Each takes numpy inputs and returns numpy
results; this module imports the port and never JAX."""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, activate, make_mesh
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.vit import SEQ_IMPLS, ViTTiny
from dist_mnist_tpu_torch.ops import losses
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.flash import flash_attention_sharded
from dist_mnist_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    shard_train_state,
)
from dist_mnist_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_self_attention,
)
from dist_mnist_tpu_torch.train import TrainState, make_train_step
from dist_mnist_tpu_torch.train.step import REMAT_POLICIES, loss_and_grads
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

#: the small ViT of every case (the reference's
#: tests/test_parallel_attention.py geometry, f32, the stacked layout)
VIT_KW = dict(depth=2, dim=64, heads=4, patch=8, pool="mean",
              scan_blocks=True, compute_dtype=torch.float32)
ENTRIES = {"ring": ring_self_attention, "ulysses": ulysses_self_attention}
ADAPTIVE = {"ring": ring_attention, "ulysses": ulysses_attention}


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): x.detach().numpy()
            for p, x in flatten_with_path(tree)}


def _mesh(**axes):
    return make_mesh(MeshSpec(**axes), device="cpu")


def _tokens(n_tokens: int, mesh) -> slice:
    per = n_tokens // mesh.seq
    return slice(mesh.seq_index * per, (mesh.seq_index + 1) * per)


# -- attention ----------------------------------------------------------------

def attention(spec: dict, mesh) -> dict:
    """Ring and Ulysses attention, both engines, on this rank's tokens of
    the full q, k, v: the output and the q, k, v gradients of ``sum(out
    * g)`` (this rank's tokens), and whether the mesh-adaptive entry gives
    the same bits; and this rank's seq index."""
    q, k, v, g = (torch.from_numpy(spec[n]) for n in "qkvg")
    tok = _tokens(q.shape[1], mesh)
    out = {"seq_index": mesh.seq_index}
    for name, fn in ENTRIES.items():
        for impl in ("xla", "flash"):
            leaves = [t[:, tok].clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, mesh, impl=impl)
            grads = torch.autograd.grad((o * g[:, tok]).sum(), leaves)
            with activate(mesh):
                adaptive = ADAPTIVE[name](*leaves, impl=impl)
            out[f"{name}/{impl}"] = {
                "out": o.detach().numpy(),
                "grads": [x.numpy() for x in grads],
                "adaptive_equal": bool(torch.equal(adaptive, o))}
    return out


def refusals(mesh) -> dict:
    """What a seq mesh still refuses: a head count Ulysses cannot split
    over it, and the CLS pool (the reference's messages)."""
    out = {}
    q = torch.zeros(1, 4 // mesh.seq, mesh.seq + 1, 8)
    try:
        ulysses_self_attention(q, q, q, mesh)
    except ValueError as err:
        out["ulysses_heads"] = str(err)
    model = ViTTiny(**{**VIT_KW, "pool": "cls"}, attention_impl="ring")
    params, _ = model.init(torch.Generator().manual_seed(0),
                           torch.zeros(1, 32, 32, 3))
    try:
        with activate(mesh):
            model.apply(params, {}, torch.zeros(2, 32, 32, 3))
    except ValueError as err:
        out["cls_pool"] = str(err)
    return out


# -- the ViT ------------------------------------------------------------------

def _batch(b: dict, rows: slice) -> dict:
    return {"image": torch.from_numpy(np.ascontiguousarray(b["image"][rows])),
            "label": torch.from_numpy(np.ascontiguousarray(b["label"][rows]))}


def _rows(n: int, mesh) -> slice:
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _reduce(grads, mesh, loss):
    """The step's rule (train/step.py): the seq sum, then the data mean."""
    grads = collectives.sum_over_axis(grads, mesh, "seq")
    return collectives.psum_mean(grads, mesh, loss.reshape(1))


def vit_fwd_bwd(spec: dict, mesh) -> dict:
    """ViT-Tiny (`VIT_KW`) with each ring and Ulysses impl on this rank's
    data rows and tokens: the logits, and the loss's gradients reduced by
    the step's rule (the whole batch's mean loss)."""
    batch = _batch(spec["batch"], _rows(spec["batch"]["label"].shape[0],
                                        mesh))
    out = {}
    for impl in SEQ_IMPLS:
        model = ViTTiny(attention_impl=impl, **VIT_KW)
        with activate(mesh):
            loss, logits, _, grads = loss_and_grads(
                model, losses.softmax_cross_entropy,
                params_from_jax(spec["params"]), {}, batch)
        grads, loss = _reduce(grads, mesh, loss)
        out[impl] = {"logits": logits.numpy(), "loss": float(loss[0]),
                     "grads": _flat(grads)}
    return out


def _step_state(params_np, opt):
    params = params_from_jax(params_np)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, model_state={},
                      opt_state=opt.init(params),
                      rng=torch.Generator().manual_seed(0))


def step_optimizer():
    from dist_mnist_tpu_torch.configs import get_config

    return optim.build_optimizer(get_config("vit_tiny_cifar_ring_flash",
                                            warmup_steps=1, train_steps=4))


def vit_steps(spec: dict, mesh) -> dict:
    """Three steps of each ring and Ulysses ViT (`VIT_KW`) on this rank's
    data rows with the reference's dropout masks: the losses, the final
    params, and the first step's gradients after the step's reduction."""
    n = spec["batches"][0]["label"].shape[0]
    rows = _rows(n, mesh)
    out = {}
    for impl in SEQ_IMPLS:
        model = ViTTiny(attention_impl=impl, **VIT_KW)
        opt = step_optimizer()
        state = shard_train_state(_step_state(spec["params"], opt), mesh,
                                  DP_RULES)
        mask = torch.from_numpy(np.ascontiguousarray(
            spec["masks"][0][:, rows]))
        with activate(mesh):
            loss, _, _, grads = loss_and_grads(
                model, losses.softmax_cross_entropy, state.params, {},
                _batch(spec["batches"][0], rows), dropout_mask=mask,
                remat=True)
        grads, _ = _reduce(grads, mesh, loss)
        step = make_train_step(model, opt, mesh=mesh, remat=True)
        traj = []
        for b, m in zip(spec["batches"], spec["masks"]):
            mask = torch.from_numpy(np.ascontiguousarray(m[:, rows]))
            state, metrics = step(state, _batch(b, rows), dropout_mask=mask)
            traj.append(float(metrics["loss"]))
        out[impl] = {"losses": traj, "grads": _flat(grads),
                     "params": _flat(state.params)}
    return out


def remat_policies(spec: dict, mesh) -> dict:
    """One backward of `ring_flash` and `ulysses_flash` (`VIT_KW`, the
    first batch and its masks) without remat and under each policy: is
    every gradient the same bits, and what each run moved over seq."""
    rows = _rows(spec["batches"][0]["label"].shape[0], mesh)
    batch = _batch(spec["batches"][0], rows)
    mask = torch.from_numpy(np.ascontiguousarray(spec["masks"][0][:, rows]))
    out = {}
    for impl in ("ring_flash", "ulysses_flash"):
        model = ViTTiny(attention_impl=impl, **VIT_KW)
        runs = {}
        for policy in ("off", *REMAT_POLICIES):
            kw = ({} if policy == "off"
                  else dict(remat=True, remat_policy=policy))
            before = dict(mesh.stats)
            with activate(mesh):
                _, _, _, grads = loss_and_grads(
                    model, losses.softmax_cross_entropy,
                    params_from_jax(spec["params"]), {}, batch,
                    dropout_mask=mask, **kw)
            runs[policy] = {
                "grads": _flat(grads),
                "sp": {k: v - before.get(k, 0) for k, v in mesh.stats.items()
                       if k.startswith("sp_")}}
        base = runs["off"]["grads"]
        out[impl] = {policy: {
            "equal": all(np.array_equal(r["grads"][k], base[k])
                         for k in base),
            "sp": r["sp"]} for policy, r in runs.items()}
    return out


def cli_run(data_dir: str, ckpt_root: str) -> dict:
    """`vit_tiny_cifar_ring_flash` through the training CLI's `run_config`
    at the small width on this seq = 2 group, with a checkpoint at its
    last step: the final params' digest, the loss and the run's
    collectives a step."""
    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.train.state import params_digest

    small = {k: v for k, v in VIT_KW.items() if k != "compute_dtype"}
    cfg = get_config("vit_tiny_cifar_ring_flash")
    cfg = dataclasses.replace(
        cfg, batch_size=8, train_steps=4, eval_every=0, log_every=2,
        mesh=MeshSpec(data=1, seq=2),
        model_kwargs={**cfg.model_kwargs, **small})
    state, final, ctx = run_config(
        cfg, device="cpu", data_dir=data_dir,
        checkpoint_dir=os.path.join(ckpt_root, "cli"),
        checkpoint_every_steps=4)
    return {"step": state.step_int, "loss": final["loss"],
            "digest": params_digest(state.params),
            "param_elements": sum(x.numel() for _, x in
                                  flatten_with_path(state.params)),
            "collectives": ctx["collectives_per_step"],
            "mesh": dict(ctx["mesh"].shape)}


def f1_warnings() -> list[str]:
    """The sharded flash entry on data = 2 x model = 2 at per-rank batches
    1, 2 and 3: every warning logged (none is due: each rank's batch is
    its slice of a global batch the data axis divides)."""
    mesh = _mesh(data=2, model=2)
    seen: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                seen.append(record.getMessage())

    handler = Keep()
    root = logging.getLogger()
    root.addHandler(handler)
    try:
        gen = torch.Generator().manual_seed(7)
        for b in (1, 2, 3):
            q, k, v = (torch.randn(b, 5, 4, 8, generator=gen)
                       for _ in range(3))
            flash_attention_sharded(q, k, v, mesh=mesh)
    finally:
        root.removeHandler(handler)
    return seen


# -- the groups ---------------------------------------------------------------

def seq2_cases(spec: dict, ckpt_root: str, data_dir: str) -> dict:
    """Every data = 1 x seq = 2 case (two ranks) in one group."""
    mesh = _mesh(data=1, seq=2)
    out = {"seq_index": mesh.seq_index, "rank": mesh.rank}
    out["attention"] = attention(spec["attn"], mesh)
    out["refusals"] = refusals(mesh)
    out["remat"] = remat_policies(spec["steps"], mesh)
    out["cli"] = cli_run(data_dir, ckpt_root)
    return out


def seq4_cases(spec: dict) -> dict:
    """The four-rank cases: attention over seq = 4, the ViT's forward and
    backward and three steps on data = 2 x seq = 2, and F1's sharded
    flash entry on data = 2 x model = 2."""
    seq4 = _mesh(data=1, seq=4)
    out = {"attention": attention(spec["attn"], seq4),
           "refusals": refusals(seq4)}
    mesh = _mesh(data=2, seq=2)
    out.update(rank=mesh.rank, seq_index=mesh.seq_index,
               fwd_bwd=vit_fwd_bwd(spec["fwd"], mesh),
               steps=vit_steps(spec["steps"], mesh),
               f1_warnings=f1_warnings())
    return out
