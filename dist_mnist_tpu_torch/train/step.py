"""The training and evaluation steps (port of the reference `train/step.py`).

A step is forward, backward (`torch.autograd.grad` over the param leaves,
so no `.grad` accumulates between steps), the optimizer update and the
step increment. The reference compiles it into one XLA program; here it
runs eagerly. Every value a step produces stays on the device: the
metrics are device scalars that the caller fetches when it needs them
(`make_scanned_train_fn` averages a chunk's on the device, so a chunk
needs one fetch).

Batches hold uint8 NHWC images and int32 labels; the step normalizes on
the device (`ops.nn.normalize_images`, IEEE division). With `augment` the
step first pad-crop-flips the batch (`data/augment.py`) from the state's
generator. With `remat` the forward runs under `torch.utils.checkpoint`
(non-reentrant), as the reference wraps it in `jax.checkpoint`; the remat
policies are in `REMAT_POLICIES`. A generator's draws are not replayed by
a recompute, so every random number the forward needs (the crop and flip,
every layer's dropout keep-mask, `model.dropout_masks`) is drawn before
the checkpointed region and passed in; the region draws nothing. The
reference's grad-norm outputs join with the slice that uses them.

The model-state contracts, the reference's: a top-level scalar entry of
the model state whose key ends in ``_aux`` (the MoE load-balance term
``moe_aux``, `models/vit.py`) is an auxiliary loss, already weighted,
added to the loss inside the gradient by every step implementation (they
all differentiate through `loss_and_grads`, the explicit DP step
included; `model_aux_loss`), and reported in it; an entry whose key
ends in ``_metric`` (the MoE routing stats) is a health statistic copied
into the step outputs without the suffix, averaged over the data ranks,
where `LoggingHook` prints the scalars and `SummaryHook` histograms the
vectors.

On a mesh (`cluster/mesh.py`) of N data ranks, each rank runs the step
on its slice of the global batch: under DP the params are replicated and
the gradients' mean is one all-reduce of a flat buffer, the loss and
accuracy riding in it (`parallel/collectives.psum_mean`); under FSDP
(`parallel/sharding.py`) the sharded params are all-gathered before the
forward, their gradients reduce-scattered, and each rank's optimizer
updates its slices, the global-norm clip adding the slices' sums of
squares over ranks (`optim.base.sharded_sum_of_squares`). With
``overlap`` (`parallel/overlap.py`) the gather and the reduce-scatter
run bucket by bucket instead: the gathers issued at the step's start and
waited on at the forward's first read of a bucket's leaves, each
bucket's reduce-scatter issued as soon as the backward has its
gradients; the same values, so the same trajectory bit for bit. Batch norm is
synchronized over the ranks (the mesh is ambient during the forward,
`ops/nn.batch_norm`). The metrics are global means, equal on every rank.
Each rank draws the GLOBAL batch's random numbers from the same generator
(the sampled indices, the crops and flips, the dropout masks) and takes
its slice, so the trajectory does not depend on N, as the reference's
does not. Without a mesh a step runs on one device, the same code with no
collective.

With a ``model`` axis (TP, FSDP x TP) the ranks of one model group hold
one replica: the same batch, the same generator state, and each its
slice of the tensor-parallel leaves, which stay local through the step.
The model's forward runs the Megatron operators over the model group
(`models/vit.py`), so each rank's gradients come out in its own
placement; they are averaged over the data group only. The mesh is
installed inside the forward function itself, so a rematerialized
forward, which autograd replays on its own thread, sees it too.

With a ``seq`` axis (sequence parallelism, `models/vit.py`) the ranks of
one seq group see the same batch and generator state, and each holds
its share of every sequence's tokens through the block stack. A leaf
used before the mean pool gets, on each seq rank, the part of its
gradient that rank's tokens give; a leaf after it (the head) gets the
whole gradient on every seq rank. The rule that makes both right: each
seq rank differentiates its loss divided by seq (`loss_and_grads`), the
pool's all-reduce over seq has a sum-all-reduce backward, and
`_reduce_grads` sums every leaf's gradient over the seq ranks (one
all-reduce of a flat f32 buffer) before the mean over the data ranks.
The pre-pool leaves then get the sum of their tokens' parts, the head
seq times its 1/seq share. The reported loss and accuracy are the
undivided ones, equal on every seq rank, averaged over the data ranks.
Params and optimizer state are replicated over seq, and the updates are
the same bits on every seq rank.

With a ``pipe`` axis (the block pipeline, `parallel/pipeline.py`) the
ranks of one pipe group see the same batch and generator state and
compute the same loss from the last stage's broadcast outputs; each runs
its stages of the stacked blocks. The seq rule serves here too: each
pipe rank differentiates its loss divided by pipe, the broadcast's
backward sums the cotangents into the last stage, and `_reduce_grads`
sums every leaf over the pipe ranks, which gives the stacked blocks the
sum of their stages' parts, the leaves before the pipeline rank 0's
whole gradient and those after it pipe times their 1/pipe share.

Expert parallelism (`parallel/moe.py`, a ``model`` axis under the ``dp``
rules) needs no rule here: every model rank computes the same loss, and
the MoE layer's operators give each its whole gradient (the
tensor-parallel convention), so the gradients are averaged over the data
ranks only, as under TP. The expert stacks are whole on every rank and
each rank runs its expert's slice; the operators sum the slices'
gradients over the model group.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dist_mnist_tpu_torch.cluster.mesh import (
    AXES,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    activate,
    ambient_mesh,
    validate_mesh,
)
from dist_mnist_tpu_torch.data.augment import random_crop_flip
from dist_mnist_tpu_torch.ops import losses, metrics, nn
from dist_mnist_tpu_torch.optim.base import (
    Optimizer,
    apply_updates,
    sharded_sum_of_squares,
    sum_of_squares_over,
)
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    ShardingRules,
    gather_tree,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.train.state import TrainState
from dist_mnist_tpu_torch.utils.tree import (
    flatten_with_path,
    map_with_path,
    tree_map,
)

LossFn = Callable[..., torch.Tensor]

#: the 2-D weight products: what `dots_no_batch` keeps
_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
#: every matmul product, the batched attention ones included: what `dots`
#: keeps
_ALL_MATMULS = _WEIGHT_MATMULS + (torch.ops.aten.bmm.default,
                                  torch.ops.aten.baddbmm.default)


def _saving(ops: tuple, names: tuple = ()):
    """The `context_fn` of a selective checkpoint that saves the outputs
    of `ops` and of the tensors tagged with one of `names`
    (`ops/nn.checkpoint_name`), and recomputes the rest."""

    def policy(ctx, op, *args, **kwargs):
        if op in ops or (op == nn.CHECKPOINT_NAME and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


# The reference's named remat policies (`Config.remat_policy`), as the
# `context_fn` of a non-reentrant `torch.utils.checkpoint`. All give the
# same numbers; they trade recompute against saved activations:
#   dots_no_batch  save the outputs of the 2-D weight matmuls (`aten.mm`,
#                  `aten.addmm`: every dense layer), recompute the rest
#                  (JAX's dots_with_no_batch_dims_saveable)
#   save_attn      dots_no_batch plus the tensors tagged ``attn_out``
#                  (every attention path's output, one [B, S, H, Dh] a
#                  layer)
#   dots           every matmul output: the weight products and the
#                  batched attention products (`aten.bmm`, the einsums of
#                  the plain attention and of the ring's "xla" engine)
#   nothing        recompute everything
# What each recomputes: torch's recompute replays the region's forward
# eagerly, and a saved operator returns its saved output instead of
# running; every other operator runs again. So the einsum attention's
# products (the "xla", "ring" and "ulysses" paths) run again under
# dots_no_batch and save_attn, and not under dots. A custom
# autograd.Function keeps its own saved tensors, which the recompute
# regenerates by running it: the flash kernels (`flash`, `ring_flash`,
# `ulysses_flash`: one more forward launch a call) and the collectives
# inside the region (the ring's shifts, Ulysses' all-to-alls, the mean
# pool's seq all-reduce, the TP all-gathers and all-reduces) run again
# under every policy; `save_attn` then saves the tagged output beside
# them and `dots` saves no kernel output.
REMAT_POLICIES = {
    "dots_no_batch": _saving(_WEIGHT_MATMULS),
    "save_attn": _saving(_WEIGHT_MATMULS, ("attn_out",)),
    "dots": _saving(_ALL_MATMULS),
    "nothing": None,
}


def resolve_remat_policy(name: str):
    """The checkpoint `context_fn` for a policy name (None: the default,
    save nothing)."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; use one of "
                         f"{sorted(REMAT_POLICIES)}")
    return REMAT_POLICIES[name]


def model_aux_loss(model_state):
    """The aux-objective contract: the sum of the model state's top-level
    scalar entries whose key ends in ``_aux``, or None when there are
    none."""
    if not isinstance(model_state, dict):
        return None
    terms = [v for k, v in model_state.items()
             if k.endswith("_aux") and getattr(v, "ndim", None) == 0]
    return sum(terms[1:], terms[0]) if terms else None


def model_metrics(model_state) -> dict:
    """The metric contract: the model state's top-level ``_metric``
    entries, keyed without the suffix."""
    if not isinstance(model_state, dict):
        return {}
    return {k[:-len("_metric")]: v for k, v in model_state.items()
            if k.endswith("_metric")}


def _check_batch(batch) -> None:
    img, lab = batch["image"], batch["label"]
    if img.ndim != 4 or lab.ndim != 1:
        raise ValueError(f"batch wants image NHWC and label [N], got "
                         f"{tuple(img.shape)} and {tuple(lab.shape)}")
    if lab.dtype.is_floating_point or lab.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {lab.dtype}")
    if img.shape[0] != lab.shape[0]:
        raise ValueError(f"{img.shape[0]} images but {lab.shape[0]} labels")


def loss_and_grads(model, loss_fn: LossFn, params, model_state, batch, *,
                   rng: torch.Generator | None = None,
                   dropout_mask: torch.Tensor | None = None,
                   remat: bool = False,
                   remat_policy: str = "dots_no_batch",
                   augment: bool = False,
                   split: tuple[int, int] = (0, 1),
                   gathered=None):
    """Training forward and backward of one batch.

    Returns ``(loss, logits, new_model_state, grads)``: loss (with the
    model's ``_aux`` terms), logits and the model state detached, grads a
    tree shaped like `params` (f32 on f32 leaves).
    `augment` crops and flips the batch from `rng`; dropout draws from
    `rng` unless `dropout_mask` is given. `remat` recomputes the forward
    in the backward under `remat_policy`. ``split = (rank, ranks)`` says
    the batch is this rank's slice of a global batch ``ranks`` times as
    large: the crops, flips and dropout masks are drawn for the global
    batch and this rank's rows taken. Under an ambient mesh with seq x
    pipe = n > 1 ranks the grads are this rank's share, of the loss
    divided by n, which summed over those ranks give the whole (module
    docstring); the loss returned is not divided. `gathered` (a
    `parallel.overlap.StepGather` over `params`, this rank's FSDP slices)
    gathers the params bucket by bucket as the forward reads them and
    flushes their gradients as the backward produces them; the grads
    returned are then still the full leaves' (the caller takes the
    slices from `gathered.finish`)."""
    _check_batch(batch)
    context_fn = resolve_remat_policy(remat_policy) if remat else None
    rank, ranks = split
    b = batch["image"].shape[0]
    draw_kw = ({} if ranks == 1
               else {"global_batch": b * ranks, "offset": rank * b})
    images = batch["image"]
    if augment:
        if rng is None:
            raise ValueError("augment draws its crops from rng; got None")
        images = random_crop_flip(rng, images, **draw_kw)
    x = nn.normalize_images(images)
    if (remat or ranks > 1) and dropout_mask is None and rng is not None:
        draw = getattr(model, "dropout_masks", None)
        if draw is None:
            raise NotImplementedError(
                f"remat or a batch split over ranks with dropout needs "
                f"{type(model).__name__}.dropout_masks to draw the masks "
                "before the forward")
        dropout_mask = draw(rng, x, **draw_kw)
        rng = None
    if gathered is None:
        flat = flatten_with_path(params)
        tracked = {path: leaf.detach().requires_grad_()
                   for path, leaf in flat}
    else:
        tracked = gathered
    mesh = ambient_mesh()

    def forward(tracked_params):
        # a recompute runs on autograd's thread: install the mesh here
        with activate(mesh):
            tree = (tracked_params.params() if gathered is not None
                    else map_with_path(lambda path, _: tracked_params[path],
                                       params))
            return model.apply(tree, model_state, x, train=True, rng=rng,
                               dropout_mask=dropout_mask)

    with torch.enable_grad():
        if remat:
            # nothing in the region draws random numbers, so no RNG state
            # needs replaying
            kw = {} if context_fn is None else {"context_fn": context_fn}
            logits, new_model_state = checkpoint(
                forward, tracked, use_reentrant=False,
                preserve_rng_state=False, **kw)
        else:
            logits, new_model_state = forward(tracked)
        loss = loss_fn(logits, batch["label"])
        aux = model_aux_loss(new_model_state)
        if aux is not None:
            loss = loss + aux
        n = 1 if mesh is None else mesh.seq * mesh.pipe
        share = loss if n == 1 else loss / torch.full(
            (), float(n), dtype=loss.dtype, device=loss.device)
        if gathered is not None:
            tracked = dict(zip(gathered.paths, gathered.leaves()))
        grads = torch.autograd.grad(share, list(tracked.values()))
    new_model_state = tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
        new_model_state)
    # a conv kernel's grad comes back in the strides of its OIHW view;
    # the optimizer (and its kernels) take the params' contiguous layout
    by_path = {path: g.contiguous() for path, g in zip(tracked, grads)}
    return (loss.detach(), logits.detach(), new_model_state,
            map_with_path(lambda path, _: by_path[path], params))


def _state_mesh(state: TrainState) -> Mesh:
    """The mesh of a placed state; one rank on the state's device for a
    state never placed."""
    if state.placement is not None:
        return state.placement.mesh
    return Mesh(shape={axis: 1 for axis in AXES}, device=state.step.device)


def _place(state: TrainState, mesh, rules: ShardingRules) -> TrainState:
    """`state` placed on `mesh` by `rules` unless it already is placed."""
    if state.placement is not None or mesh is None:
        return state
    return shard_train_state(state, mesh, rules)


def _sharded_paths(state: TrainState) -> set | None:
    """The param paths this rank holds data-axis (FSDP) slices of, or
    None when none."""
    placement = state.placement
    if placement is None or not placement.sharded_on(DATA_AXIS):
        return None
    return {path for path, spec in flatten_with_path(placement.specs.params)
            if spec.dim(DATA_AXIS) is not None}


def _reduce_grads(grads, state: TrainState, mesh, extra: torch.Tensor,
                  gathered=None):
    """The global mean gradient in this rank's placement (full leaves
    under DP, slices under FSDP; a tensor-parallel slice stays this
    rank's) and the mean of `extra` over the data ranks. Each rank's
    share is first summed over the seq and the pipe ranks (module
    docstring). With `gathered` (the overlap schedule's `StepGather`)
    the FSDP leaves' slices come from its bucketed flush, and only the
    other leaves go through here."""
    if gathered is not None:
        flat = flatten_with_path(grads)
        mine = gathered.finish([g for _, g in flat])
        whole = {p: g for p, g in flat if p not in mine}
        for axis in (SEQ_AXIS, PIPE_AXIS):
            whole = collectives.sum_over_axis(whole, mesh, axis)
        whole, means = collectives.psum_mean(whole, mesh, extra)
        by_path = {**mine, **whole}
        return map_with_path(lambda p, _: by_path[p], grads), means
    for axis in (SEQ_AXIS, PIPE_AXIS):
        grads = collectives.sum_over_axis(grads, mesh, axis)
    sharded = _sharded_paths(state)
    if sharded is None:
        return collectives.psum_mean(grads, mesh, extra)
    specs = dict(flatten_with_path(state.placement.specs.params))
    flat = flatten_with_path(grads)
    split = [(p, g) for p, g in flat if p in sharded]
    whole = {p: g for p, g in flat if p not in sharded}
    mine = collectives.reduce_scatter_leaves(
        [g for _, g in split], [specs[p].dim(DATA_AXIS) for p, _ in split],
        mesh)
    whole, means = collectives.psum_mean(whole, mesh, extra)
    by_path = {**dict(zip((p for p, _ in split), mine)), **whole}
    return map_with_path(lambda p, _: by_path[p], grads), means


def _train_core(model, optimizer: Optimizer, loss_fn: LossFn,
                state: TrainState, batch, *, dropout_mask=None,
                param_gather=None, **step_kw):
    """One step on this rank's slice of the batch (module docstring).
    `param_gather` (`parallel.overlap.build_param_gather`'s) replaces the
    flat FSDP gather and reduce-scatter by its bucketed schedule."""
    mesh = _state_mesh(state)
    placement = state.placement
    any_slices = placement is not None and placement.sharded
    if (any_slices and placement.sharded_on(MODEL_AXIS)
            and not getattr(model, "tensor_parallel", False)):
        raise NotImplementedError(
            f"{type(model).__name__} has no tensor-parallel forward; the "
            "port's TP rules train ViT-Tiny (models/vit.py)")
    sharded = _sharded_paths(state)
    params, gathered = state.params, None
    if sharded is not None:
        if param_gather is not None:
            gathered = param_gather(params, placement.specs.params, mesh)
        else:
            params = gather_tree(params, placement.specs.params, mesh,
                                 axes=(DATA_AXIS,))
    with activate(mesh):
        loss, logits, new_model_state, grads = loss_and_grads(
            model, loss_fn, params, state.model_state, batch,
            rng=state.rng, dropout_mask=dropout_mask,
            split=(mesh.rank, mesh.size), gathered=gathered, **step_kw)
    del params
    with torch.no_grad():
        extra = model_metrics(new_model_state)
        local = torch.cat([
            torch.stack([loss.to(torch.float32),
                         metrics.accuracy(logits, batch["label"])]),
            *(v.reshape(-1).to(torch.float32) for v in extra.values())])
        grads, means = _reduce_grads(grads, state, mesh, local, gathered)
        norm = (sum_of_squares_over(sharded_sum_of_squares(placement))
                if any_slices else contextlib.nullcontext())
        with norm:
            updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                      state.params)
        new_state = TrainState(
            step=state.step + 1,
            params=apply_updates(state.params, updates),
            model_state=new_model_state,
            opt_state=new_opt_state,
            rng=state.rng,
            placement=state.placement,
        )
        out = {"loss": means[0], "accuracy": means[1]}
        off = 2
        for k, v in extra.items():
            out[k] = means[off:off + v.numel()].reshape(v.shape)
            off += v.numel()
    return new_state, out


def _overlap_gather(mesh, rules: ShardingRules, overlap):
    """`OverlapConfig` -> the bucketed gather (None passes through).
    Validation (overlap needs an FSDP rule set) happens here, at
    step-build time, before any data work."""
    if overlap is None:
        return None
    from dist_mnist_tpu_torch.parallel.overlap import build_param_gather

    return build_param_gather(mesh, rules, overlap)


def _consume_compile_s() -> float:
    """The seconds spent building or loading kernel and native libraries
    since the last call: what the step wrapper's `consume_compile_s`
    reports (the first call pays the loads; `train/loop.py` charges them
    to the goodput compile bucket)."""
    from dist_mnist_tpu_torch.ops.kernels import build
    from dist_mnist_tpu_torch.utils import native_build

    return build.consume_build_s() + native_build.consume_build_s()


def make_train_step(model, optimizer: Optimizer, *, mesh=None,
                    rules: ShardingRules = DP_RULES,
                    loss_fn: LossFn = losses.softmax_cross_entropy,
                    remat: bool = False, remat_policy: str = "dots_no_batch",
                    augment: bool = False, overlap=None):
    """``step(state, batch, *, dropout_mask=None) -> (state, metrics)`` on
    an explicit batch (uint8 images and int32 labels on the state's
    device): on a `mesh`, this rank's slice of the global batch, and a
    state not yet placed is placed by `rules` first. Augmentation and
    dropout draw from ``state.rng``, in that order, unless a keep-mask
    is given. `overlap` (`parallel.overlap.OverlapConfig`, needs `rules`
    with an FSDP axis) runs the FSDP gather and gradient flush bucket by
    bucket: the same trajectory bit for bit on two data ranks. The step
    has `consume_compile_s()` (`_consume_compile_s`)."""
    resolve_remat_policy(remat_policy)  # refuse a bad name up front
    if mesh is not None:
        validate_mesh(mesh)
    step_kw = dict(remat=remat, remat_policy=remat_policy, augment=augment,
                   param_gather=_overlap_gather(mesh, rules, overlap))

    def step(state: TrainState, batch, *, dropout_mask=None):
        return _train_core(model, optimizer, loss_fn,
                           _place(state, mesh, rules), batch,
                           dropout_mask=dropout_mask, **step_kw)

    step.consume_compile_s = _consume_compile_s
    return step


def make_fused_train_step(model, optimizer: Optimizer, device_dataset,
                          batch_size: int, *, mesh=None,
                          rules: ShardingRules = DP_RULES,
                          loss_fn: LossFn = losses.softmax_cross_entropy,
                          remat: bool = False,
                          remat_policy: str = "dots_no_batch",
                          augment: bool = False, overlap=None):
    """``step(state) -> (state, metrics)`` drawing its batch on the device
    from the resident dataset (`data.pipeline.DeviceDataset`): with-
    replacement sampling from ``state.rng`` (`batch_size` is global; on a
    mesh the dataset gives this rank its slice), then augmentation and
    dropout from the same generator. The host does no per-step data
    work. `overlap` as in `make_train_step`."""
    resolve_remat_policy(remat_policy)
    if mesh is not None:
        validate_mesh(mesh)
    step_kw = dict(remat=remat, remat_policy=remat_policy, augment=augment,
                   param_gather=_overlap_gather(mesh, rules, overlap))

    def step(state: TrainState):
        state = _place(state, mesh, rules)
        batch = device_dataset.sample(state.rng, batch_size)
        return _train_core(model, optimizer, loss_fn, state, batch,
                           **step_kw)

    step.consume_compile_s = _consume_compile_s
    return step


def make_scanned_train_fn(model, optimizer: Optimizer, device_dataset,
                          batch_size: int, chunk: int, *,
                          loss_fn: LossFn = losses.softmax_cross_entropy,
                          **step_kw):
    """``run(state) -> (state, metrics)``: `chunk` fused steps (`step_kw`:
    mesh, rules, remat, remat_policy, augment, overlap); the metrics are
    each one's mean over the chunk, computed on the device (the
    reference's `lax.scan` returns the same means)."""
    one_step = make_fused_train_step(model, optimizer, device_dataset,
                                     batch_size, loss_fn=loss_fn, **step_kw)

    def run(state: TrainState):
        outs = []
        for _ in range(chunk):
            state, out = one_step(state)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]).mean()
                       for k in outs[0]}

    run.consume_compile_s = _consume_compile_s
    return run


def make_eval_step(model):
    """``eval_step(state, batch) -> (sum_loss, correct_count, n)``:
    summable device scalars, so a whole test set streams in fixed-size
    batches. Padding rows carry label -1: they add 0 to the loss sum
    (one-hot of -1 is the zero row), never count as correct, and are not
    counted in n. A state whose params are FSDP slices is gathered first
    (a collective: `evaluate` gathers once for the whole split)."""

    def eval_step(state: TrainState, batch):
        state = unshard_state(state)
        with torch.inference_mode():
            x = nn.normalize_images(batch["image"])
            y = batch["label"]
            logits, _ = model.apply(state.params, state.model_state, x,
                                    train=False)
            loss_sum = losses.softmax_cross_entropy(logits, y,
                                                    reduction="sum")
            correct = metrics.correct_count(logits, y)
            n = torch.sum(y >= 0, dtype=torch.int32)
        return loss_sum, correct, n

    return eval_step


def evaluate(eval_step, state: TrainState, images: np.ndarray,
             labels: np.ndarray, batch_size: int = 1000,
             mesh=None) -> dict:
    """Whole-split evaluation: pads the tail batch (label -1), keeps the
    partial sums on the device and fetches them once at the end. On a
    mesh (default: the state's) each rank evaluates its slice of every
    batch (the batch rounded up to a multiple of the ranks) and the sums
    are all-reduced, so every rank returns the same numbers."""
    if mesh is None:
        mesh = _state_mesh(state)
    state = unshard_state(state)
    device = state.step.device
    ranks = mesh.size
    batch_size = -(-batch_size // ranks) * ranks
    local = batch_size // ranks
    n = images.shape[0]
    totals = None
    for i in range(0, n, batch_size):
        img = images[i:i + batch_size]
        lab = labels[i:i + batch_size]
        if img.shape[0] < batch_size:  # pad the tail; label -1 marks it
            pad = batch_size - img.shape[0]
            img = np.concatenate(
                [img, np.zeros((pad, *img.shape[1:]), img.dtype)])
            lab = np.concatenate([lab, np.full((pad,), -1, lab.dtype)])
        rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
        batch = {"image": torch.from_numpy(
                     np.ascontiguousarray(img[rows])).to(device),
                 "label": torch.from_numpy(
                     np.ascontiguousarray(lab[rows], np.int32)).to(device)}
        part = eval_step(state, batch)
        totals = part if totals is None else tuple(
            t + p for t, p in zip(totals, part))
    if ranks > 1:
        packed = torch.stack([t.to(torch.float64) for t in totals])
        totals = tuple(collectives.all_reduce_(packed, mesh))
    total_loss, total_correct, total_n = (t.item() for t in totals)
    return {"loss": float(total_loss) / int(total_n),
            "accuracy": int(total_correct) / int(total_n),
            "n": int(total_n)}
