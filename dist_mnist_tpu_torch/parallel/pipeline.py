"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
axis (port of the reference `parallel/pipeline.py`).

A stack of identically shaped stages is split over the ranks of the pipe
group (stage s on pipe rank s), a batch is split into M microbatches, and
activations flow stage to stage around the ring (`collectives.ring_shift`
over ``pipe``, staged through host memory under gloo). The schedule is
the reference's GPipe ladder: at tick t, stage s computes microbatch
t - s; the pipe drains after M + S - 1 ticks. Bubble fraction = (S-1) /
(M+S-1). The last stage's outputs reach every pipe rank through
`collectives.broadcast_from_last` (the reference's ``lax.psum`` of a
buffer only the last stage writes).

The CIRCULAR (interleaved) schedule (`circular_chunks=v`): each rank
holds v non-adjacent chunks of the stage stack (global stage g = c*S + s
lives on rank s as chunk c), so a microbatch laps the ring v times and
the fill/drain bubble costs S - 1 chunk-times instead of stage-times:
M*v + S - 1 ticks of one chunk. Every rank runs the same local program
delayed by its rank index (local time q = t - s selects microbatch
(q // (S*v))*S + q % S and chunk (q // S) mod v), and every transfer is
the same +1 hop, the wrap S-1 -> 0 included, where rank 0 swaps a
finished microbatch for the next group's fresh input.

The reference runs every rank's ticks inside one SPMD program; here
each pipe rank runs its own ticks eagerly, with its rank index a Python
int, and autograd differentiates through the schedule: the ring shift's
backward is the reverse shift, so the backward sweep needs no hand-
written send and receive. The schedule keeps the reference's dataflow
(stage 0 picks its input with a ``where``, the last stage writes its
output buffer with one), so every rank's graph has the same collectives
in the same order: a backward that reached a collective on one rank and
not on another would hang. For the same reason the first activation is
zeros that autograd ties to the stage's params (`_zeros_on_graph`):
without the tie, a rank whose first ticks only pass zeros along (the
last stage's fill ticks under `skip_bubble`) would hold shifts whose
backward leads to no param, and autograd would skip them there. The
last tick's shift, whose result no tick reads, is skipped (the reference
shifts it).

Gradient scale (`train/step.py`): every pipe rank computes the same loss
from the broadcast outputs. Each rank differentiates its loss divided by
the pipe size; the broadcast's backward sums the ranks' cotangents into
the last stage; each rank's stacked-stage leaves get the gradient of the
stages it ran (zeros elsewhere), rank 0's pre-pipeline leaves the whole
of theirs (the other ranks' inputs feed nothing), and every rank 1/S of
the post-pipeline leaves'; the step then sums every gradient over the
pipe ranks (`collectives.sum_over_axis`), which gives each leaf its
whole gradient on every pipe rank.

Entry points:
- `pipeline_apply_inner(fn, stage_params, x_mb, mesh)`: the GPipe ticks
  on this rank; x_mb ``[M, mb, ...]``, stage_params this rank's stage.
- `pipeline_apply_circular_inner(fn, chunk_params, x_mb, mesh,
  n_chunks=v)`: the circular ticks.
- `pipeline_apply(fn, stacked_params, x, num_microbatches, mesh,
  circular_chunks=v)`: the stage leaves ``[S*v, ...]`` whole on every
  rank; x this data rank's batch ``[B, ...]``.
- `stack_stage_params(params_list)`.

Where the reference threads a PRNG key per (data shard, microbatch,
global stage) into a stochastic stage (`rng=`), the port passes the
schedule position (``positions=True``: fn then takes ``(params, x, m,
g)``, the microbatch and the global stage), from which the caller picks
what it drew before the forward (the ViT's dropout keep-masks, the
port's rule for random numbers under remat, `train/step.py`). `skip_bubble`
skips the stage's compute on fill and drain ticks (the reference's
``lax.cond``); the outputs are the same either way.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.cluster.mesh import PIPE_AXIS, Mesh
from dist_mnist_tpu_torch.parallel.collectives import (
    broadcast_from_last,
    ring_shift,
)
from dist_mnist_tpu_torch.utils.tree import leaves, tree_map


def stack_stage_params(params_list):
    """Stack S isomorphic per-stage param trees into one tree whose leaves
    lead with S."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def _zeros_on_graph(like: torch.Tensor, params, x_mb: torch.Tensor):
    """Zeros shaped like `like` that autograd connects to the params and
    the input (zero times one element of each tensor that requires a
    gradient), so every shift of the schedule has a backward on every
    rank (module docstring)."""
    zeros = torch.zeros_like(like)
    if not torch.is_grad_enabled():
        return zeros
    terms = [t.reshape(-1)[0].to(zeros.dtype)
             for t in (*leaves(params), x_mb)
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if not terms:
        return zeros
    return zeros + 0 * torch.stack(terms).sum()


def _call(fn, params, x, m, g, positions: bool):
    return fn(params, x, m, g) if positions else fn(params, x)


def _shift_unless_last(y, t: int, n_ticks: int, mesh: Mesh):
    """The activation for tick t + 1: `y` one stage forward, except after
    the last tick, whose shift nothing reads."""
    return ring_shift(y, mesh, axis=PIPE_AXIS) if t < n_ticks - 1 else y


def pipeline_apply_inner(fn, stage_params, x_mb: torch.Tensor, mesh: Mesh, *,
                         positions: bool = False,
                         skip_bubble: bool = False) -> torch.Tensor:
    """The GPipe schedule on this pipe rank.

    fn: ``(params, x) -> y`` (one stage, y the shape and dtype of x);
      ``(params, x, m, g)`` with `positions` (m the microbatch, g the
      stage it works on; fill and drain ticks get a clipped m).
    stage_params: this rank's stage.
    x_mb: ``[M, mb, ...]`` microbatches, the same on every pipe rank.
    Returns ``[M, mb, ...]``, the same on every pipe rank."""
    s, n_stages = mesh.pipe_index, mesh.pipe
    n_mb = x_mb.shape[0]
    first = torch.tensor(s == 0, device=x_mb.device)
    last = s == n_stages - 1
    n_ticks = n_mb + n_stages - 1
    act = _zeros_on_graph(x_mb[0], stage_params, x_mb)
    out = [torch.zeros_like(x_mb[0]) for _ in range(n_mb)]
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (clipped on the drain ticks, where
        # the value is unused)
        act = torch.where(first, x_mb[min(t, n_mb - 1)], act)
        m = min(max(t - s, 0), n_mb - 1)
        if skip_bubble and not 0 <= t - s < n_mb:
            y = act
        else:
            y = _call(fn, stage_params, act, m, s, positions)
        # the last stage retires microbatch t - (S-1)
        idx = min(max(t - (n_stages - 1), 0), n_mb - 1)
        ready = torch.tensor(last and t >= n_stages - 1, device=y.device)
        out[idx] = torch.where(ready, y, out[idx])
        act = _shift_unless_last(y, t, n_ticks, mesh)
    return broadcast_from_last(torch.stack(out), mesh, PIPE_AXIS)


def pipeline_apply_circular_inner(fn, chunk_params, x_mb: torch.Tensor,
                                  mesh: Mesh, *, n_chunks: int = 1,
                                  positions: bool = False,
                                  skip_bubble: bool = False) -> torch.Tensor:
    """The circular schedule on this pipe rank (module docstring).

    chunk_params: this rank's v chunks, leaves ``[v, ...]``; chunk c holds
      global stage c*S + s. x_mb: ``[M, mb, ...]``, M % S == 0. With
      `positions`, fn takes ``(params, x, m, g)``, g the GLOBAL stage."""
    s, n_stages = mesh.pipe_index, mesh.pipe
    v = n_chunks
    n_mb = x_mb.shape[0]
    first = s == 0
    last = s == n_stages - 1
    n_ticks = n_mb * v + n_stages - 1
    act = _zeros_on_graph(x_mb[0], chunk_params, x_mb)
    out = [torch.zeros_like(x_mb[0]) for _ in range(n_mb)]
    for t in range(n_ticks):
        q = max(t - s, 0)  # local time; the fill ticks are masked below
        valid = t >= s
        j = q % n_stages
        c = (q // n_stages) % v
        m = min(max((q // (n_stages * v)) * n_stages + j, 0), n_mb - 1)
        # rank 0 on a chunk-0 tick ingests microbatch m (replacing the
        # finished activation that just wrapped around from the last rank)
        take = torch.tensor(first and c == 0, device=x_mb.device)
        act = torch.where(take, x_mb[m], act)
        if skip_bubble and not (valid and q < n_mb * v):
            y = act
        else:
            p_c = tree_map(lambda z, c=c: z[c], chunk_params)
            y = _call(fn, p_c, act, m, c * n_stages + s, positions)
        ready = torch.tensor(last and c == v - 1 and valid, device=y.device)
        out[m] = torch.where(ready, y, out[m])
        act = _shift_unless_last(y, t, n_ticks, mesh)
    return broadcast_from_last(torch.stack(out), mesh, PIPE_AXIS)


def pipeline_apply(fn, stacked_params, x: torch.Tensor,
                   num_microbatches: int, mesh: Mesh, *,
                   circular_chunks: int = 1, positions: bool = False,
                   skip_bubble: bool = False) -> torch.Tensor:
    """GPipe (default) or circular (`circular_chunks=v>1`) over `mesh`'s
    pipe axis, on this data rank's batch.

    stacked_params: leaves ``[S, ...]`` (`stack_stage_params`) for GPipe,
      or ``[S*v, ...]``, one entry per GLOBAL stage in stage order, for
      the circular schedule (stage c*S + s runs on rank s as chunk c);
      whole on every rank, each rank using its stages' entries.
    x: ``[B, ...]``; B % num_microbatches == 0.
    Returns ``[B, ...]``, the same on every pipe rank."""
    n_stages = mesh.pipe
    v = circular_chunks
    want = n_stages * v
    msg = (f"stacked_params leading dim must equal pipe axis size "
           f"{n_stages}" + (f" x circular_chunks {v} = {want}" if v > 1
                            else ""))
    for leaf in leaves(stacked_params):
        if leaf.shape[0] != want:
            raise ValueError(msg + f", got {leaf.shape[0]}")
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} % microbatches {num_microbatches} != 0")
    if v > 1 and num_microbatches % n_stages:
        raise ValueError(
            f"circular schedule needs microbatches {num_microbatches} % "
            f"pipe axis {n_stages} == 0 (microbatches enter in rank-width "
            "groups)")
    x_mb = x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))
    s = mesh.pipe_index
    if v > 1:
        # [S*v, ...] stage-major: rank s holds entries s, S + s, 2S + s...
        mine = tree_map(lambda a: a[s::n_stages], stacked_params)
        out = pipeline_apply_circular_inner(
            fn, mine, x_mb, mesh, n_chunks=v, positions=positions,
            skip_bubble=skip_bubble)
    else:
        mine = tree_map(lambda a: a[s], stacked_params)
        out = pipeline_apply_inner(fn, mine, x_mb, mesh,
                                   positions=positions,
                                   skip_bubble=skip_bubble)
    return out.reshape((b,) + tuple(out.shape[2:]))
