"""The port's tensor-parallel cases, run on every rank of a gloo group by
`torch_ranks.run_ranks` (and on one process by the tests themselves, for
the one-rank comparisons). Each takes numpy inputs and returns numpy
results; this module imports the port and never JAX."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.cluster.mesh import (
    DATA_AXIS,
    MeshSpec,
    activate,
    make_mesh,
)
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.ops import losses
from dist_mnist_tpu_torch.ops.kernels.flash_attention import flash_attention
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention,
)
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.flash import (
    flash_attention_sharded,
    masked_flash_attention_sharded,
)
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    gather_tree,
    replicated_leaves,
    resolve_rules,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.serve import (
    DecodeScheduler,
    build_decode_engine,
    run_decode_loadgen,
)
from dist_mnist_tpu_torch.train import (
    TrainState,
    make_train_step,
    state_memory_bytes,
)
from dist_mnist_tpu_torch.train.step import loss_and_grads
from dist_mnist_tpu_torch.utils.tree import flatten_with_path
from torch_ranks import to_numpy

#: the decode geometry (the reference's tests/test_serve_decode.py LM_KW)
LM_KW = dict(vocab_size=64, dim=32, depth=2, heads=4, max_seq=32)
LM_LAYOUTS = {
    "dense": dict(LM_KW),
    "int8": dict(LM_KW, cache_layout="paged", kv_page_tokens=8,
                 kv_quant="int8"),
}
#: the small ViT of the TP step (f32, the stacked layout)
VIT_KW = dict(dim=32, depth=2, heads=4, patch=8, scan_blocks=True,
              compute_dtype=torch.float32)


def _mesh(data: int, model: int):
    return make_mesh(MeshSpec(data=data, model=model), device="cpu")


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): x.detach().numpy()
            for p, x in flatten_with_path(tree)}


# -- decode -------------------------------------------------------------------

def lm_forward_and_decode(params_np, tokens, layout: str, mesh=None) -> dict:
    """The full forward of `tokens` ``[B, S]`` and an incremental decode
    of the same tokens (a prefill of the first, then one step a
    position), under `mesh` when given; logits and this rank's cache."""
    model = CausalLMTiny(**LM_LAYOUTS[layout])
    params = params_from_jax(params_np)
    tok = torch.from_numpy(tokens)
    b, s = tokens.shape
    with torch.no_grad(), activate(mesh):
        full, _ = model.apply(params, {}, tok)
        cache = model.init_cache(b, mesh=mesh)
        table = None
        if model.cache_layout == "paged":
            table = torch.arange(b * model.pages_per_slot, dtype=torch.int32
                                 ).reshape(b, model.pages_per_slot)
        slots = torch.arange(b, dtype=torch.int32)
        first, _ = model.prefill(params, cache, tok[:, :1], slots,
                                 torch.ones(b, dtype=torch.int32),
                                 page_table=table)
        steps = [first]
        for pos in range(1, s):
            logits, _ = model.decode_step(
                params, cache, tok[:, pos], torch.full((b,), pos,
                                                       dtype=torch.int32),
                page_table=table)
            steps.append(logits)
    return {"full": full.numpy(), "decode": torch.stack(steps, 1).numpy(),
            "cache_k_shape": tuple((cache["k"].q if layout == "int8"
                                    else cache["k"]).shape)}


def decode_streams(layout: str, mesh=None) -> dict | None:
    """Seeded decode traffic through an engine (the chief's streams and
    byte counts; None on a follower, which follows the chief)."""
    engine = build_decode_engine("cpu", seed=0, max_slots=4, mesh=mesh,
                                 **LM_LAYOUTS[layout])
    if engine.is_follower:
        calls = engine.follow()
        return {"follower_calls": calls,
                "decode_steps": engine.decode_steps,
                "rank_kv_bytes": engine.rank_kv_bytes}
    try:
        engine.prewarm()
        sched = DecodeScheduler(engine)
        try:
            out = run_decode_loadgen(sched, n_requests=6, concurrency=4,
                                     seed=5, keep_streams=True)
        finally:
            sched.close()
    finally:
        engine.close()
    return {"streams": out["streams"], "ok": out["ok"],
            "decode_steps": engine.decode_steps,
            "rank_kv_bytes": engine.rank_kv_bytes,
            "kv_stats": engine.kv_stats(),
            "resident": engine.resident_bytes_per_device()}


# -- flash entry --------------------------------------------------------------

def flash_sharded(spec: dict, mesh) -> dict:
    """The sharded flash entries against the unsharded plain versions on
    the same inputs: output and q/k/v gradients, bit for bit."""
    q, k, v, g = (torch.from_numpy(spec[n]) for n in ("q", "k", "v", "g"))
    lengths = torch.from_numpy(spec["lengths"])
    out = {}
    for name, sharded, plain in (
            ("flash", lambda a, b, c: flash_attention_sharded(
                a, b, c, mesh=mesh), flash_attention),
            ("masked", lambda a, b, c: masked_flash_attention_sharded(
                a, b, c, lengths, mesh=mesh),
             lambda a, b, c: masked_flash_attention(a, b, c, lengths))):
        res = []
        for fn in (sharded, plain):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves)
            grads = torch.autograd.grad((o * g).sum(), leaves)
            res.append([o.detach().numpy()] + [x.numpy() for x in grads])
        out[name] = {"equal": [bool(np.array_equal(a, b))
                               for a, b in zip(*res)],
                     "launch_shape": tuple(q.shape)}
    return out


# -- the ViT step -------------------------------------------------------------

def _vit_state(params_np, opt):
    params = params_from_jax(params_np)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, model_state={},
                      opt_state=opt.init(params),
                      rng=torch.Generator().manual_seed(0))


def _vit_optimizer():
    from dist_mnist_tpu_torch.configs import get_config

    return optim.build_optimizer(get_config("vit_tiny_cifar_tp",
                                            warmup_steps=1, train_steps=4))


def vit_steps(spec: dict, rules_name: str, mesh) -> dict:
    """Three steps of the TP (or FSDP x TP) ViT step on this rank's data
    slice of each batch with the reference's dropout masks; losses, the
    gathered final params, per-rank bytes, local shapes, and the first
    step's gradients of the replicated leaves."""
    model = ViTTiny(**VIT_KW)
    opt = _vit_optimizer()
    rules = resolve_rules(rules_name)
    state = shard_train_state(_vit_state(spec["params"], opt), mesh, rules)
    out = {"bytes": state_memory_bytes(state),
           "local_shapes": {k: tuple(v.shape)
                            for k, v in _flat(state.params).items()}}
    rows_per = spec["batches"][0]["label"].shape[0] // mesh.size
    rows = slice(mesh.rank * rows_per, (mesh.rank + 1) * rows_per)

    def local(i):
        b = spec["batches"][i]
        batch = {"image": torch.from_numpy(np.ascontiguousarray(
                     b["image"][rows])),
                 "label": torch.from_numpy(np.ascontiguousarray(
                     b["label"][rows]))}
        return batch, torch.from_numpy(np.ascontiguousarray(
            spec["masks"][i][:, rows]))

    # the first step's gradients, this rank's placement
    batch, mask = local(0)
    params = gather_tree(state.params, state.placement.specs.params, mesh,
                         axes=(DATA_AXIS,))
    with activate(mesh):
        _, _, _, grads = loss_and_grads(
            model, losses.softmax_cross_entropy, params, {}, batch,
            dropout_mask=mask, remat=True)
    out["replicated_grads"] = _flat(replicated_leaves(
        grads, state.placement.specs.params))
    step = make_train_step(model, opt, mesh=mesh, rules=rules, remat=True)
    traj = []
    for i in range(len(spec["batches"])):
        batch, mask = local(i)
        state, m = step(state, batch, dropout_mask=mask)
        traj.append(float(m["loss"]))
    out["losses"] = traj
    out["replicated_digest"] = _flat(replicated_leaves(
        state.params, state.placement.specs.params))
    out["model_replicated"] = _flat(replicated_leaves(
        state.params, state.placement.specs.params, axes=("model",)))
    out["params"] = to_numpy(unshard_state(state).params)
    out["state"] = state
    return out


def checkpoint_round_trip(state, mesh, ckpt_root: str) -> dict:
    """A TP-placed state saved, restored under DP, saved again and
    restored under its own rules: every leaf bit for bit."""
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager

    rules = state.placement.rules
    src = dataclasses.replace(state, step=torch.tensor(7, dtype=torch.int32))
    nested = to_numpy(unshard_state(src).params)
    full = _flat(unshard_state(src).params)
    trips = []
    for i, load_rules in enumerate((DP_RULES, rules)):
        mgr = CheckpointManager(os.path.join(ckpt_root, f"trip{i}"),
                                async_save=False)
        try:
            assert mgr.save(src)
            fresh = _vit_state(_zeros_like_tree(nested), _vit_optimizer())
            restored = mgr.restore(shard_train_state(fresh, mesh,
                                                     load_rules))
        finally:
            mgr.close()
        got = _flat(unshard_state(restored).params)
        trips.append({"step": restored.step_int,
                      "equal": all(np.array_equal(got[k], full[k])
                                   for k in full),
                      "qkv_local": tuple(
                          restored.params["blocks"]["attn"]["qkv"]["w"]
                          .shape)})
        src = restored
    return {"trips": trips, "wrote": sorted(os.listdir(
        os.path.join(ckpt_root, "trip0")))}


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return np.zeros_like(tree)


def cli_run(data_dir: str, ckpt_root: str) -> dict:
    """`vit_tiny_cifar_tp` through the training CLI's `run_config` at the
    small width on this model = 2 group: the final state's digests, the
    resident bytes and the run's collectives."""
    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.train.state import params_digest

    small = {k: v for k, v in VIT_KW.items() if k != "compute_dtype"}
    cfg = dataclasses.replace(
        get_config("vit_tiny_cifar_tp"), batch_size=8, train_steps=4,
        eval_every=0, log_every=2, mesh=MeshSpec(data=1, model=2),
        model_kwargs=small)
    state, final, ctx = run_config(
        cfg, device="cpu", data_dir=data_dir,
        checkpoint_dir=os.path.join(ckpt_root, "cli"),
        checkpoint_every_steps=4)
    return {"step": state.step_int, "loss": final["loss"],
            "replicated": params_digest(replicated_leaves(
                state.params, state.placement.specs.params)),
            "model_replicated": params_digest(replicated_leaves(
                state.params, state.placement.specs.params,
                axes=("model",))),
            "full": params_digest(unshard_state(state).params),
            "bytes": state_memory_bytes(state),
            "collectives": ctx["collectives_per_step"],
            "qkv_local": tuple(state.params["blocks"]["attn"]["qkv"]["w"]
                               .shape),
            "mesh": dict(ctx["mesh"].shape)}


# -- the groups ---------------------------------------------------------------

def tp2_cases(spec: dict, ckpt_root: str, data_dir: str) -> dict:
    """Every model = 2 case (data = 1, two ranks) in one group."""
    mesh = _mesh(1, 2)
    out = {"model_index": mesh.model_index}
    out["lm"] = {layout: lm_forward_and_decode(spec["lm_params"],
                                               spec["tokens"], layout, mesh)
                 for layout in LM_LAYOUTS}
    out["engine"] = {layout: decode_streams(layout, mesh)
                     for layout in LM_LAYOUTS}
    out["flash"] = flash_sharded(spec["flash"], mesh)
    vit = vit_steps(spec["vit"], "tp", mesh)
    out["ckpt"] = checkpoint_round_trip(vit.pop("state"), mesh, ckpt_root)
    out["vit"] = vit
    before = dict(collectives.collective_stats(mesh))
    out["stats"] = {k: v for k, v in before.items() if k.startswith("tp_")}
    out["cli"] = cli_run(data_dir, ckpt_root)
    return out


def tp4_cases(spec: dict) -> dict:
    """FSDP x TP on data = 2 x model = 2."""
    mesh = _mesh(2, 2)
    vit = vit_steps(spec["vit"], "fsdp_tp", mesh)
    vit.pop("state")
    return {"rank": mesh.rank, "model_index": mesh.model_index, "vit": vit,
            "stats": dict(collectives.collective_stats(mesh))}
