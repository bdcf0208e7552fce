"""The training and evaluation steps (port of the reference `train/step.py`,
one device).

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
reference's fsdp param gather, grad-norm outputs and the model-state
`_aux`/`_metric` contracts join with the slices that use them.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dist_mnist_tpu_torch.data.augment import random_crop_flip
from dist_mnist_tpu_torch.ops import losses, metrics, nn
from dist_mnist_tpu_torch.optim.base import Optimizer, apply_updates
from dist_mnist_tpu_torch.train.state import TrainState
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, map_with_path

LossFn = Callable[..., torch.Tensor]

#: the 2-D weight products: what `dots_no_batch` keeps
_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# The reference's named remat policies (`Config.remat_policy`), as the
# `context_fn` of a non-reentrant `torch.utils.checkpoint`:
#   dots_no_batch  keep the outputs of the 2-D weight matmuls (`aten.mm`,
#                  `aten.addmm`: every dense layer), recompute the rest,
#                  the batched attention products and the flash kernels
#                  included (JAX's dots_with_no_batch_dims_saveable)
#   nothing        recompute everything
# `save_attn` and `dots` (ROADMAP §1 item 4) raise: no ported config uses
# them.
REMAT_POLICIES = {
    "dots_no_batch": functools.partial(create_selective_checkpoint_contexts,
                                       _save_weight_matmuls),
    "nothing": None,
}
_LATER_POLICIES = ("save_attn", "dots")


def resolve_remat_policy(name: str):
    """The checkpoint `context_fn` for a policy name (None: the default,
    save nothing)."""
    if name in _LATER_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} joins the port with the configs that "
            "use it (ROADMAP §1 item 4); the port has 'dots_no_batch' and "
            "'nothing'")
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; use one of "
                         f"{sorted(REMAT_POLICIES) + list(_LATER_POLICIES)}")
    return REMAT_POLICIES[name]


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
                   augment: bool = False):
    """Training forward and backward of one batch.

    Returns ``(loss, logits, new_model_state, grads)``: loss and logits
    detached, grads a tree shaped like `params` (f32 on f32 leaves).
    `augment` crops and flips the batch from `rng`; dropout draws from
    `rng` unless `dropout_mask` is given. `remat` recomputes the forward
    in the backward under `remat_policy`."""
    _check_batch(batch)
    context_fn = resolve_remat_policy(remat_policy) if remat else None
    images = batch["image"]
    if augment:
        if rng is None:
            raise ValueError("augment draws its crops from rng; got None")
        images = random_crop_flip(rng, images)
    x = nn.normalize_images(images)
    if remat and dropout_mask is None and rng is not None:
        draw = getattr(model, "dropout_masks", None)
        if draw is None:
            raise NotImplementedError(
                f"remat with dropout needs {type(model).__name__}."
                "dropout_masks to draw the masks before the checkpointed "
                "region")
        dropout_mask = draw(rng, x)
    flat = flatten_with_path(params)
    tracked = {path: leaf.detach().requires_grad_() for path, leaf in flat}

    def forward(tracked_params):
        return model.apply(
            map_with_path(lambda path, _: tracked_params[path], params),
            model_state, x, train=True, rng=None if remat else rng,
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
        grads = torch.autograd.grad(loss, list(tracked.values()))
    # a conv kernel's grad comes back in the strides of its OIHW view;
    # the optimizer (and its kernels) take the params' contiguous layout
    by_path = {path: g.contiguous() for path, g in zip(tracked, grads)}
    return (loss.detach(), logits.detach(), new_model_state,
            map_with_path(lambda path, _: by_path[path], params))


def _train_core(model, optimizer: Optimizer, loss_fn: LossFn,
                state: TrainState, batch, *, dropout_mask=None, **step_kw):
    loss, logits, new_model_state, grads = loss_and_grads(
        model, loss_fn, state.params, state.model_state, batch,
        rng=state.rng, dropout_mask=dropout_mask, **step_kw)
    with torch.no_grad():
        updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
        new_state = TrainState(
            step=state.step + 1,
            params=apply_updates(state.params, updates),
            model_state=new_model_state,
            opt_state=new_opt_state,
            rng=state.rng,
        )
        out = {"loss": loss.to(torch.float32),
               "accuracy": metrics.accuracy(logits, batch["label"])}
    return new_state, out


def make_train_step(model, optimizer: Optimizer, *,
                    loss_fn: LossFn = losses.softmax_cross_entropy,
                    remat: bool = False, remat_policy: str = "dots_no_batch",
                    augment: bool = False):
    """``step(state, batch, *, dropout_mask=None) -> (state, metrics)`` on
    an explicit batch (uint8 images and int32 labels on the state's
    device). Augmentation and dropout draw from ``state.rng``, in that
    order, unless a keep-mask is given."""
    resolve_remat_policy(remat_policy)  # refuse a bad name up front
    step_kw = dict(remat=remat, remat_policy=remat_policy, augment=augment)

    def step(state: TrainState, batch, *, dropout_mask=None):
        return _train_core(model, optimizer, loss_fn, state, batch,
                           dropout_mask=dropout_mask, **step_kw)

    return step


def make_fused_train_step(model, optimizer: Optimizer, device_dataset,
                          batch_size: int, *,
                          loss_fn: LossFn = losses.softmax_cross_entropy,
                          remat: bool = False,
                          remat_policy: str = "dots_no_batch",
                          augment: bool = False):
    """``step(state) -> (state, metrics)`` drawing its batch on the device
    from the resident dataset (`data.pipeline.DeviceDataset`): with-
    replacement sampling from ``state.rng``, then augmentation and dropout
    from the same generator. The host does no per-step data work."""
    resolve_remat_policy(remat_policy)
    step_kw = dict(remat=remat, remat_policy=remat_policy, augment=augment)

    def step(state: TrainState):
        batch = device_dataset.sample(state.rng, batch_size)
        return _train_core(model, optimizer, loss_fn, state, batch,
                           **step_kw)

    return step


def make_scanned_train_fn(model, optimizer: Optimizer, device_dataset,
                          batch_size: int, chunk: int, *,
                          loss_fn: LossFn = losses.softmax_cross_entropy,
                          **step_kw):
    """``run(state) -> (state, metrics)``: `chunk` fused steps (`step_kw`:
    remat, remat_policy, augment); the metrics are each one's mean over
    the chunk, computed on the device (the reference's `lax.scan` returns
    the same means)."""
    one_step = make_fused_train_step(model, optimizer, device_dataset,
                                     batch_size, loss_fn=loss_fn, **step_kw)

    def run(state: TrainState):
        outs = []
        for _ in range(chunk):
            state, out = one_step(state)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]).mean()
                       for k in outs[0]}

    return run


def make_eval_step(model):
    """``eval_step(state, batch) -> (sum_loss, correct_count, n)``:
    summable device scalars, so a whole test set streams in fixed-size
    batches. Padding rows carry label -1: they add 0 to the loss sum
    (one-hot of -1 is the zero row), never count as correct, and are not
    counted in n."""

    def eval_step(state: TrainState, batch):
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
             labels: np.ndarray, batch_size: int = 1000) -> dict:
    """Whole-split evaluation: pads the tail batch (label -1), keeps the
    partial sums on the device and fetches them once at the end."""
    device = state.step.device
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
        batch = {"image": torch.from_numpy(np.ascontiguousarray(img)).to(device),
                 "label": torch.from_numpy(
                     np.ascontiguousarray(lab, np.int32)).to(device)}
        part = eval_step(state, batch)
        totals = part if totals is None else tuple(
            t + p for t, p in zip(totals, part))
    total_loss, total_correct, total_n = (t.item() for t in totals)
    return {"loss": float(total_loss) / int(total_n),
            "accuracy": int(total_correct) / int(total_n),
            "n": int(total_n)}
