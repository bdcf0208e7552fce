"""The collectives of the data-, tensor- and sequence-parallel step (port
of the reference `parallel/collectives.py`).

In the reference, GSPMD inserts the gradient all-reduce, the FSDP
all-gather and reduce-scatter, and the batch-norm statistics' all-reduce
when the batch is sharded on the ``data`` axis, and the Megatron
reductions when weights are sharded on the ``model`` axis. Here the step
and the models write them out over the mesh's groups:

- `psum_mean`: the mean of a gradient tree over the ranks, one all-reduce
  of one flat f32 buffer (never one call per leaf);
- `gather_leaves` / `reduce_scatter_leaves`: the FSDP pair, each one call
  over a flat buffer laid out ``[ranks, chunk]``, rank r's chunk holding
  its slice of every sharded leaf; `all_gather_flat` and
  `reduce_scatter_flat` also issue asynchronously (``async_op=True``,
  counted at issue), which the bucketed schedule of `parallel/overlap.py`
  builds on;
- `all_reduce_sum`: an all-reduce that autograd differentiates (its
  backward all-reduces the cotangent), for synchronized batch norm;
- the Megatron operators over the ``model`` group, as autograd
  functions: `copy_to_model` (identity forward, all-reduce backward: the
  input of a column-parallel layer), `reduce_from_model` (all-reduce
  forward, identity backward: the output of a row-parallel layer),
  `scatter_to_model` (this rank's slice of a replicated tensor forward,
  all-gather backward: the input of a row-parallel layer fed by
  replicated math) and `gather_from_model` (all-gather on a dim forward;
  its backward takes this rank's slice of the cotangent, since
  everything downstream of the gather is replicated and every rank
  already holds the whole, equal cotangent: a reduce-scatter there would
  double every gradient).

Over any axis's group, as autograd functions (`axis=`):

- `ring_shift`: rank i sends its tensor to i+1 and receives i-1's (the
  reference's ``ppermute`` around the ring), the two sends posted
  together (`torch.distributed.batch_isend_irecv`) so no order of the
  ranks can deadlock; the backward is the reverse shift. Ring attention
  shifts K and V over ``seq``, the pipeline its activations over
  ``pipe`` (`parallel/pipeline.py`), the collective matmul its operands
  over any axis (`parallel/collective_matmul.py`);
- `all_to_all`: the tiled all-to-all (split one dim into chunks, chunk j
  to rank j, concatenate what arrives on another dim in rank order);
  the backward is the inverse all-to-all. The Ulysses reshard runs it
  over ``seq`` (`parallel/ulysses.py`), the MoE dispatch over ``model``
  (`parallel/moe.py`);
- `all_reduce_sum(t, mesh, axis)`: the sum over the ranks, whose
  backward sums the cotangent over them (the mean pool over ``seq``);
- `broadcast_from_last`: the last rank's tensor on every rank (the
  pipeline's last-stage-to-all hand-off, the reference's ``lax.psum``
  of a buffer only the last stage writes); its backward sums the
  cotangent over the ranks into the last one;
- `sum_over_axis`: the step's gradient sum over the seq or pipe ranks,
  one all-reduce of a flat f32 buffer.

The gradient mean (`psum_mean`) and the FSDP pair run over the ``data``
group only (``axis="data"``, the default); `gather_leaves` also takes
``axis="model"`` for gathering a tensor-parallel leaf whole. Every call
adds its payload bytes (the tensor this rank contributes) to
``mesh.stats`` (`collective_stats`), which the training CLI reports per
step: the ``model`` group's under keys that start with ``tp_``, the
``seq`` group's under ``sp_``, the ``pipe`` group's under ``pp_``, apart
from the data group's; expert parallelism's (`parallel/moe.py`, over the
``model`` and ``data`` groups) under ``ep_`` (``prefix=EP_PREFIX``).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from dist_mnist_tpu_torch.cluster.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
)
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, map_with_path


def collective_stats(mesh: Mesh) -> collections.Counter:
    """Bytes each collective moved on `mesh` so far (payload per rank:
    the tensor this rank contributes), and its call counts."""
    return mesh.stats


#: the stats key prefix of each axis's collectives
_PREFIX = {DATA_AXIS: "", MODEL_AXIS: "tp_", SEQ_AXIS: "sp_",
           PIPE_AXIS: "pp_"}
#: expert parallelism's collectives (over the model and data groups)
EP_PREFIX = "ep_"


def _count(mesh: Mesh, name: str, t: torch.Tensor,
           axis: str = DATA_AXIS, prefix: str | None = None) -> None:
    stats = collective_stats(mesh)
    key = (_PREFIX[axis] if prefix is None else prefix) + name
    stats[f"{key}_bytes"] += t.numel() * t.element_size()
    stats[f"{key}_calls"] += 1


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS, *,
                prefix: str | None = None) -> torch.Tensor:
    """Sum `t` over the ranks of `axis`, in place (no-op on one rank)."""
    if mesh.shape[axis] == 1:
        return t
    _count(mesh, "all_reduce", t, axis, prefix)
    dist.all_reduce(t, group=mesh.axis_group(axis))
    return t


def all_gather_flat(chunk: torch.Tensor, mesh: Mesh,
                    axis: str = DATA_AXIS, *,
                    prefix: str | None = None, async_op: bool = False):
    """``[ranks * n]``: every `axis` rank's 1-D `chunk` of n elements,
    index 0's first. With `async_op`, ``(out, work)``: the call is
    issued (and counted) now, and `out` holds the result once
    ``work.wait()`` returned (work None on an axis of one)."""
    n = mesh.shape[axis]
    if n == 1:
        return (chunk, None) if async_op else chunk
    _count(mesh, "all_gather", chunk, axis, prefix)
    out = chunk.new_empty(n * chunk.numel())
    work = dist.all_gather_into_tensor(out, chunk.contiguous(),
                                       group=mesh.axis_group(axis),
                                       async_op=async_op)
    return (out, work) if async_op else out


def reduce_scatter_flat(flat: torch.Tensor, mesh: Mesh, *,
                        async_op: bool = False):
    """This rank's n elements of the sum over the data ranks of `flat`
    (``[ranks * n]``). With `async_op`, ``(out, work)`` as
    `all_gather_flat` gives."""
    if mesh.size == 1:
        return (flat, None) if async_op else flat
    _count(mesh, "reduce_scatter", flat)
    out = flat.new_empty(flat.numel() // mesh.size)
    work = dist.reduce_scatter_tensor(out, flat.contiguous(),
                                      group=mesh.group, async_op=async_op)
    return (out, work) if async_op else out


def _divide(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t / n` as an IEEE division by a tensor on t's device (the
    reference divides; torch turns a division by a Python number into a
    multiply on CUDA)."""
    return t / torch.full((), float(n), dtype=t.dtype, device=t.device)


def psum_mean(tree, mesh: Mesh, extra: torch.Tensor | None = None):
    """The mean over the data ranks of every leaf of `tree` (and of the
    1-D `extra`, e.g. the step's metrics): one all-reduce of one flat f32
    buffer over the data group. Returns the tree (each leaf in its own
    dtype), or ``(tree, extra)`` when `extra` is given. The reference's
    ``lax.psum(g) / n``."""
    flat = flatten_with_path(tree)
    if mesh.size == 1:
        return tree if extra is None else (tree, extra)
    parts = [leaf.reshape(-1).to(torch.float32) for _, leaf in flat]
    if extra is not None:
        parts.append(extra.reshape(-1).to(torch.float32))
    buf = _divide(all_reduce_(torch.cat(parts), mesh), mesh.size)
    out, off = {}, 0
    for path, leaf in flat:
        n = leaf.numel()
        out[path] = buf[off:off + n].view(leaf.shape).to(leaf.dtype)
        off += n
    reduced = map_with_path(lambda path, _: out[path], tree)
    if extra is None:
        return reduced
    return reduced, buf[off:].to(extra.dtype)


def gather_leaves(shards: list[torch.Tensor], dims: list[int],
                  mesh: Mesh, axis: str = DATA_AXIS, *,
                  prefix: str | None = None) -> list[torch.Tensor]:
    """The full leaves of shards over `axis`: shard i holds this rank's
    slice of leaf i along dim ``dims[i]``. One all-gather of a flat
    buffer per dtype."""
    n_ranks = mesh.shape[axis]
    if n_ranks == 1 or not shards:
        return list(shards)
    out: list = [None] * len(shards)
    by_dtype: dict = {}
    for i, s in enumerate(shards):
        by_dtype.setdefault(s.dtype, []).append(i)
    for idx in by_dtype.values():
        moved = [shards[i].movedim(dims[i], 0) for i in idx]
        chunk = torch.cat([m.reshape(-1) for m in moved])
        full = all_gather_flat(chunk, mesh, axis, prefix=prefix).view(
            n_ranks, -1)
        off = 0
        for i, m in zip(idx, moved):
            n = m.numel()
            block = full[:, off:off + n].reshape(n_ranks * m.shape[0],
                                                 *m.shape[1:])
            out[i] = block.movedim(0, dims[i]).contiguous()
            off += n
    return out


def reduce_scatter_leaves(leaves: list[torch.Tensor], dims: list[int],
                          mesh: Mesh) -> list[torch.Tensor]:
    """This rank's slice (along ``dims[i]``) of the MEAN over ranks of
    each full leaf: one reduce-scatter of a flat f32 buffer laid out
    ``[ranks, chunk]``."""
    if mesh.size == 1 or not leaves:
        return list(leaves)
    n_ranks = mesh.size
    rows = [g.movedim(d, 0).reshape(n_ranks, -1).to(torch.float32)
            for g, d in zip(leaves, dims)]
    flat = torch.cat(rows, dim=1).reshape(-1)
    mine = _divide(reduce_scatter_flat(flat, mesh), n_ranks)
    out, off = [], 0
    for g, d, r in zip(leaves, dims, rows):
        n = r.shape[1]
        moved_shape = (g.shape[d] // n_ranks,
                       *[s for i, s in enumerate(g.shape) if i != d])
        out.append(mine[off:off + n].reshape(moved_shape).movedim(0, d)
                   .contiguous().to(g.dtype))
        off += n
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of an axis whose backward sums the cotangent over
    them: each rank's loss depends on every rank's contribution, so the
    gradient reaching a contribution is the sum of every rank's
    cotangent."""

    @staticmethod
    def forward(ctx, t, mesh, axis, prefix):
        ctx.mesh, ctx.axis, ctx.prefix = mesh, axis, prefix
        return all_reduce_(t.contiguous().clone(), mesh, axis, prefix=prefix)

    @staticmethod
    def backward(ctx, grad):
        return (all_reduce_(grad.contiguous().clone(), ctx.mesh, ctx.axis,
                            prefix=ctx.prefix), None, None, None)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS, *,
                   prefix: str | None = None) -> torch.Tensor:
    """Differentiable sum of `t` over the ranks of `axis` (`t` on one
    rank)."""
    if mesh.shape[axis] == 1:
        return t
    return _AllReduceSum.apply(t, mesh, axis, prefix)


def sum_over_axis(tree, mesh: Mesh, axis: str):
    """Every leaf of `tree` summed over the ranks of `axis` (each leaf in
    its own dtype): one all-reduce of one flat f32 buffer over its
    group."""
    if mesh.shape[axis] == 1:
        return tree
    flat = flatten_with_path(tree)
    buf = all_reduce_(torch.cat([leaf.reshape(-1).to(torch.float32)
                                 for _, leaf in flat]), mesh, axis)
    out, off = {}, 0
    for path, leaf in flat:
        n = leaf.numel()
        out[path] = buf[off:off + n].view(leaf.shape).to(leaf.dtype)
        off += n
    return map_with_path(lambda path, _: out[path], tree)


def _stage(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a point-to-point send of `t` goes through host memory:
    gloo's send and recv take CPU tensors only (module docstring of
    `cluster/coordination.py`)."""
    return mesh.backend == "gloo" and t.device.type != "cpu"


def _shift(x: torch.Tensor, mesh: Mesh, step: int, axis: str,
           prefix: str | None) -> torch.Tensor:
    """Rank i's `x` (its index on `axis`) sent to i + step, i - step's
    received (a new contiguous tensor on x's device)."""
    n, i, group = (mesh.shape[axis], mesh.axis_index(axis),
                   mesh.axis_group(axis))
    send = x.contiguous()
    _count(mesh, "ring_shift", send, axis, prefix)
    staged = _stage(mesh, send)
    if staged:
        send = send.cpu()
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (i - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


class _RingShift(torch.autograd.Function):
    """`x` one step around the axis's ring; the backward sends the
    cotangent one step back."""

    @staticmethod
    def forward(ctx, x, mesh, reverse, axis, prefix):
        ctx.mesh, ctx.step = mesh, -1 if reverse else 1
        ctx.axis, ctx.prefix = axis, prefix
        return _shift(x, mesh, ctx.step, axis, prefix)

    @staticmethod
    def backward(ctx, grad):
        return (_shift(grad, ctx.mesh, -ctx.step, ctx.axis, ctx.prefix),
                None, None, None, None)


def ring_shift(x: torch.Tensor, mesh: Mesh, *, axis: str = SEQ_AXIS,
               reverse: bool = False,
               prefix: str | None = None) -> torch.Tensor:
    """Rank i's `x` (its index on `axis`) moved to rank i+1 (i-1 with
    `reverse`), so each rank returns its predecessor's: the building
    block of ring attention, the pipeline's stage-to-stage hop and the
    collective matmul. `x` itself on an axis of one."""
    if mesh.shape[axis] == 1:
        return x
    return _RingShift.apply(x, mesh, reverse, axis, prefix)


def _all_to_all(x: torch.Tensor, mesh: Mesh, split_axis: int,
                concat_axis: int, axis: str,
                prefix: str | None) -> torch.Tensor:
    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} not divisible by {axis} axis "
                         f"{n}")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    _count(mesh, "all_to_all", send, axis, prefix)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    dist.all_to_all_single(recv, send, group=mesh.axis_group(axis))
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, split_axis, concat_axis, axis, prefix):
        ctx.mesh, ctx.dims = mesh, (split_axis, concat_axis)
        ctx.axis, ctx.prefix = axis, prefix
        return _all_to_all(x, mesh, split_axis, concat_axis, axis, prefix)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.dims
        return (_all_to_all(grad, ctx.mesh, concat_axis, split_axis,
                            ctx.axis, ctx.prefix),
                None, None, None, None, None)


def all_to_all(x: torch.Tensor, mesh: Mesh, *, axis: str, split_axis: int,
               concat_axis: int, prefix: str | None = None) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` over the group of `axis`: `x`
    split into chunks along `split_axis`, chunk j sent to rank j, and the
    chunks received concatenated along `concat_axis` in rank order. `x`
    itself on an axis of one."""
    if mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh, split_axis % x.ndim,
                           concat_axis % x.ndim, axis, prefix)


class _BroadcastFromLast(torch.autograd.Function):
    """The axis's last rank's tensor on every rank; the backward sums the
    cotangent over the ranks into the last one (every rank's loss reads
    the broadcast value) and gives the others none."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        group = mesh.axis_group(axis)
        buf = t.contiguous().clone()
        _count(mesh, "broadcast", buf, axis)
        dist.broadcast(buf, src=dist.get_global_rank(
            group, mesh.shape[axis] - 1), group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_(grad.contiguous().clone(), ctx.mesh, ctx.axis)
        last = ctx.mesh.axis_index(ctx.axis) == ctx.mesh.shape[ctx.axis] - 1
        return (total if last else torch.zeros_like(total)), None, None


def broadcast_from_last(t: torch.Tensor, mesh: Mesh,
                        axis: str = PIPE_AXIS) -> torch.Tensor:
    """The last `axis` rank's `t` on every rank of its group (`t` on an
    axis of one)."""
    if mesh.shape[axis] == 1:
        return t
    return _BroadcastFromLast.apply(t, mesh, axis)


def _model_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group (each rank's column-parallel slice saw the whole input)."""

    @staticmethod
    def forward(ctx, t, mesh, prefix):
        ctx.mesh, ctx.prefix = mesh, prefix
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh,
                           MODEL_AXIS, prefix=ctx.prefix), None, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (the row-parallel partial
    products); identity backward (the sum is replicated downstream)."""

    @staticmethod
    def forward(ctx, t, mesh, prefix):
        return all_reduce_(t.contiguous().clone(), mesh, MODEL_AXIS,
                           prefix=prefix)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's slices on `dim` of replicated tensors forward; the
    backward all-gathers the slices' cotangents (one call per dtype), so
    each replicated tensor's cotangent is whole, and equal, on every
    rank."""

    @staticmethod
    def forward(ctx, mesh, dim, prefix, *ts):
        ctx.mesh, ctx.dim, ctx.prefix = mesh, dim, prefix
        return tuple(_model_slice(t, dim % t.ndim, mesh).contiguous()
                     for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        dims = [ctx.dim % g.ndim for g in grads]
        return (None, None, None, *gather_leaves(
            [g.contiguous() for g in grads], dims, ctx.mesh, MODEL_AXIS,
            prefix=ctx.prefix))


class _GatherFromModel(torch.autograd.Function):
    """All-gather over the model group on `dim` forward; the backward
    keeps this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, t, mesh, dim, prefix):
        ctx.mesh, ctx.dim = mesh, dim
        return gather_leaves([t.contiguous()], [dim], mesh, MODEL_AXIS,
                             prefix=prefix)[0]

    @staticmethod
    def backward(ctx, grad):
        return (_model_slice(grad, ctx.dim, ctx.mesh).contiguous(), None,
                None, None)


def copy_to_model(t: torch.Tensor, mesh: Mesh | None, *,
                  prefix: str | None = None) -> torch.Tensor:
    """The input of a column-parallel layer, or a replicated leaf each
    rank uses in part (`t` without a model axis)."""
    if mesh is None or mesh.model == 1:
        return t
    return _CopyToModel.apply(t, mesh, prefix)


def reduce_from_model(t: torch.Tensor, mesh: Mesh | None, *,
                      prefix: str | None = None) -> torch.Tensor:
    """The sum over the model group of a row-parallel layer's partial
    products (`t` without a model axis)."""
    if mesh is None or mesh.model == 1:
        return t
    return _ReduceFromModel.apply(t, mesh, prefix)


def scatter_to_model(t: torch.Tensor, mesh: Mesh | None, dim: int, *,
                     prefix: str | None = None) -> torch.Tensor:
    """This rank's slice on `dim` of a replicated `t` (the input of a
    row-parallel layer; `t` without a model axis)."""
    if mesh is None or mesh.model == 1:
        return t
    return _ScatterToModel.apply(mesh, dim, prefix, t)[0]


def scatter_leaves_to_model(ts: list[torch.Tensor], mesh: Mesh | None,
                            dim: int, *,
                            prefix: str | None = None) -> list[torch.Tensor]:
    """`scatter_to_model` of several tensors on the same `dim`, their
    backward one all-gather per dtype."""
    if mesh is None or mesh.model == 1:
        return list(ts)
    return list(_ScatterToModel.apply(mesh, dim, prefix, *ts))


def gather_from_model(t: torch.Tensor, mesh: Mesh | None, dim: int, *,
                      prefix: str | None = None) -> torch.Tensor:
    """The model group's slices of `t` along `dim`, index 0's first (`t`
    without a model axis)."""
    if mesh is None or mesh.model == 1:
        return t
    return _GatherFromModel.apply(t, mesh, dim % t.ndim, prefix)


def make_explicit_dp_step(model, optimizer, mesh: Mesh, *, loss_fn=None):
    """The reference's hand-written shard_map DP step: each rank's
    forward and batch-norm statistics over its own slice (per-replica
    BN), the gradients mean-all-reduced before the update, the BN running
    statistics, loss and accuracy averaged over ranks after it. The main
    path (`train/step.make_train_step` under a mesh) is the GSPMD
    counterpart: its batch norm is synchronized. ``step(state, batch) ->
    (state, metrics)`` on this rank's slice of the batch."""
    from dist_mnist_tpu_torch.ops import losses, metrics
    from dist_mnist_tpu_torch.optim.base import apply_updates
    from dist_mnist_tpu_torch.train.state import TrainState
    from dist_mnist_tpu_torch.train.step import loss_and_grads

    loss_fn = loss_fn or losses.softmax_cross_entropy

    def step(state: TrainState, batch):
        loss, logits, new_ms, grads = loss_and_grads(
            model, loss_fn, state.params, state.model_state, batch,
            rng=state.rng, split=(mesh.rank, mesh.size))
        with torch.no_grad():
            acc = metrics.accuracy(logits, batch["label"])
            grads, means = psum_mean(
                grads, mesh, torch.stack([loss.to(torch.float32),
                                          acc.to(torch.float32)]))
            new_ms = psum_mean(new_ms, mesh)
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params)
            new_state = TrainState(
                step=state.step + 1,
                params=apply_updates(state.params, updates),
                model_state=new_ms, opt_state=new_opt, rng=state.rng,
                placement=state.placement)
        return new_state, {"loss": means[0], "accuracy": means[1]}

    return step
