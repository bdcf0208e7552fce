"""Expert parallelism: the switch-style MoE FFN with an all-to-all dispatch
(port of the reference `parallel/moe.py`).

Design (top-1 "switch" routing by default, GShard-style top-k via
`top_k`; one expert per rank of the ``model`` axis), the reference's:

- gate: tokens ``[T, D]`` -> scores ``[T, E]`` in f32 (the reference's
  ``x @ gate_w`` promotes the bf16 tokens to the f32 gate's type); each
  token routes to its k best experts (k = 1: the raw softmax prob as its
  combine weight; k >= 2: the chosen probs renormalized to sum to 1). On
  a tie the lower expert index wins, as in ``jax.lax.top_k``: `argmax`
  (the first maximum) for k = 1, a stable descending sort for k >= 2
  (``torch.topk`` promises no order among equal values).
- capacity: C = ceil(T/E) * k * capacity_factor slots an expert;
  assignments beyond them are dropped (they contribute zero), and every
  entry point returns `stats` = {drop_fraction, expert_load[E]}
  (`moe_ffn_adaptive` adds ``ep_engaged``: 1.0 when dispatched over the
  expert axis, 0.0 on the dense fallback).
- dispatch: the ``[E, C, D]`` buffer of each expert's queued tokens (f32)
  -> tiled all-to-all over the model group, so each rank receives the
  tokens every rank routed to ITS expert -> the expert FFN (dense relu
  dense) -> the reverse all-to-all -> the weighted combine back to
  ``[T, D]``.
- aux: the load-balance loss E * sum_e f_e * p_e, f_e the fraction of
  assignments routed to e (over k), p_e the mean router prob for e.

The reference builds the dispatch and combine as one-hot ``[T, E, C]``
tensors contracted by einsums; the port moves the same rows by index
(each expert slot holds at most one token, each token at most k slots),
which gives the same values: every output of the one-hot einsums has one
nonzero term, or k of them in the combine.

Expert parallelism (`moe_ffn`): on a mesh whose ``model`` axis equals the
expert count, each model rank holds the whole batch (the blocks around
the MoE layer run replicated over model, the config's ``dp`` rules),
takes its contiguous 1/E of the layer's tokens (`scatter_to_model`,
whose backward all-gathers the tokens' cotangents), routes them with the
capacity of its shard (the reference's `moe_ffn_inner`: EP equals the
dense oracle over all tokens only when nothing is dropped), runs expert
`model_index` on what the all-to-all brings it, and gathers the outputs
back over model (`gather_from_model`). The router statistics f and p and
the health stats are averaged over the data and model ranks (one
all-reduce of a packed vector per axis), so aux is the global value on
every rank. Every model rank computes the same loss; its gradients must
be the whole model's (the tensor-parallel convention): the gate enters
through `copy_to_model` (its cotangent summed over the model ranks, each
of which routed a share of the tokens) and the expert stacks through
`scatter_leaves_to_model` (each rank runs its expert's slice; the
backward all-gathers the slices' cotangents), and the averaging of p
gives each model rank 1/E of its cotangent while summing it over the
data ranks (whose losses differ). Every collective here counts under
``ep_`` (`collectives.EP_PREFIX`), apart from tensor parallelism's
``tp_``.

Entry points: `init_moe`, `moe_ffn_dense` (all experts local: the oracle
and the fallback), `moe_ffn_inner` (this rank's tokens and expert),
`moe_ffn` (over the mesh's model axis) and `moe_ffn_adaptive` (EP when
the ambient mesh's model axis equals the expert count, else dense).
"""

from __future__ import annotations

import logging
import math
import typing

import torch

from dist_mnist_tpu_torch.cluster.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    ambient_mesh,
)
from dist_mnist_tpu_torch.ops.nn import fan_in_trunc_normal
from dist_mnist_tpu_torch.ops.quant import QuantizedArray, q_dot
from dist_mnist_tpu_torch.parallel.collectives import (
    EP_PREFIX,
    all_reduce_,
    all_to_all,
    copy_to_model,
    gather_from_model,
    scatter_leaves_to_model,
    scatter_to_model,
)

log = logging.getLogger(__name__)

#: the expert stacks, leading dim E
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")
#: (n_experts, model axis) pairs the dense fallback has warned about
_WARNED: set = set()


def init_moe(gen: torch.Generator, dim: int, hidden: int, n_experts: int):
    """Gate ``[D, E]`` and the per-expert FFN stacks ``[E, ...]``."""
    return {
        "gate": fan_in_trunc_normal(gen, (dim, n_experts)),
        "w1": fan_in_trunc_normal(gen, (n_experts, dim, hidden)),
        "b1": torch.zeros((n_experts, hidden)),
        "w2": fan_in_trunc_normal(gen, (n_experts, hidden, dim)),
        "b2": torch.zeros((n_experts, dim)),
    }


def capacity_of(tokens: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """Slots an expert: ceil(T/E) * k * capacity_factor, at least 1."""
    return max(1, int(-(-tokens // n_experts) * top_k * capacity_factor))


class Routing(typing.NamedTuple):
    """Where each of a token's k assignments goes: `dest` ``[T, K]`` the
    flat slot ``expert * C + position`` in its expert's queue (``E * C``
    where dropped), `weight` its combine weight (0 where dropped); the
    router statistics `f`, `p` ``[E]`` and the health `stats`."""

    weight: torch.Tensor
    dest: torch.Tensor
    f: torch.Tensor
    p: torch.Tensor
    stats: dict


def _divide(t: torch.Tensor, n) -> torch.Tensor:
    """`t / n` as an IEEE division by a tensor (torch turns a division by
    a Python number into a multiply on CUDA)."""
    return t / torch.full((), float(n), dtype=t.dtype, device=t.device)


def top_k_lower_index(probs: torch.Tensor, k: int) -> torch.Tensor:
    """``[T, k]`` indices of each row's k largest values, best first, the
    lower index first among equal values (``jax.lax.top_k``'s rule)."""
    if k == 1:
        return probs.argmax(dim=-1, keepdim=True)
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _route(gate_w, x: torch.Tensor, n_experts: int, capacity: int,
           top_k: int = 1) -> Routing:
    """The reference's `_route`: f and p are LOCAL means over the tokens
    seen here (the caller averages them over the ranks before forming
    aux, which is linear in neither)."""
    if not 1 <= top_k <= n_experts:
        raise ValueError(
            f"top_k={top_k} must be in [1, n_experts={n_experts}] "
            "(1 = Switch routing, >=2 = GShard-style top-k)")
    scores = x.to(torch.float32) @ gate_w.to(torch.float32)  # [T, E]
    probs = torch.softmax(scores, dim=-1)
    top_idx = top_k_lower_index(probs.detach(), top_k)  # [T, K]
    assigned = torch.zeros_like(probs).scatter_(1, top_idx, 1.0)
    weights = probs * assigned
    if top_k > 1:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    # position of each (token, expert) assignment in the expert's queue
    pos = torch.cumsum(assigned, dim=0) * assigned - assigned  # [T, E]
    in_cap = (pos < capacity).to(torch.float32) * assigned
    f = _divide(assigned.mean(dim=0), top_k)
    p = probs.mean(dim=0)
    n_assigned = assigned.sum()
    stats = {
        "drop_fraction": 1.0 - in_cap.sum() / torch.clamp(n_assigned,
                                                           min=1.0),
        "expert_load": _divide(in_cap.sum(dim=0), capacity),
    }
    kept = in_cap.gather(1, top_idx) > 0
    slot = pos.gather(1, top_idx).to(torch.int64)
    dest = torch.where(kept, top_idx * capacity + slot,
                       torch.full_like(slot, n_experts * capacity))
    weight = weights.gather(1, top_idx) * kept
    return Routing(weight, dest, f, p, stats)


def _dispatch(x: torch.Tensor, r: Routing, n_experts: int,
              capacity: int) -> torch.Tensor:
    """``[E, C, D]`` f32: slot (e, c) holds the token queued there, zeros
    where no token is."""
    t, k = r.dest.shape
    slots = n_experts * capacity
    token = torch.full((slots + 1,), t, dtype=torch.int64, device=x.device)
    ids = torch.arange(t, device=x.device).repeat_interleave(k)
    # dropped assignments all land on the extra slot, which is discarded
    token.scatter_(0, r.dest.reshape(-1), ids)
    padded = torch.cat([x.to(torch.float32),
                        x.new_zeros((1, x.shape[1]), dtype=torch.float32)])
    return padded[token[:slots]].reshape(n_experts, capacity, x.shape[1])


def _combine(expert_out: torch.Tensor, r: Routing) -> torch.Tensor:
    """``[T, D]``: each token's kept assignments' expert outputs, weighted
    and summed."""
    flat = expert_out.reshape(-1, expert_out.shape[-1])
    padded = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    return (padded[r.dest] * r.weight.unsqueeze(-1)).sum(dim=1)


def _take(leaf, i: int):
    """Expert i's slice of a stacked leaf (a tensor or an int8
    `QuantizedArray`)."""
    if isinstance(leaf, QuantizedArray):
        return QuantizedArray(leaf.q[i], leaf.scale[i], leaf.mode)
    return leaf[i]


def _expert_ffn(w1, b1, w2, b2, tokens: torch.Tensor) -> torch.Tensor:
    h = torch.relu(q_dot(tokens, w1) + b1.to(tokens.dtype))
    return q_dot(h, w2) + b2.to(tokens.dtype)


def moe_ffn_dense(params, x: torch.Tensor, capacity_factor: float = 1.25,
                  top_k: int = 1):
    """All experts local: the oracle, and the fallback on a mesh without
    an expert axis. Returns ``(out, aux, stats)``."""
    t = x.shape[0]
    e = params["gate"].shape[-1]
    capacity = capacity_of(t, e, top_k, capacity_factor)
    r = _route(params["gate"], x, e, capacity, top_k)
    aux = e * (r.f * r.p).sum()
    expert_in = _dispatch(x, r, e, capacity)
    expert_out = torch.stack([
        _expert_ffn(*(_take(params[k], i) for k in EXPERT_LEAVES),
                    expert_in[i]) for i in range(e)])
    return _combine(expert_out, r).to(x.dtype), aux, r.stats


class _RoutingMean(torch.autograd.Function):
    """The mean over the ranks of `axes` of a packed statistics vector.
    Backward: the cotangent summed over the axes whose ranks hold
    different losses (all but `expert_axis`, whose ranks compute the same
    loss), over the count of ranks averaged."""

    @staticmethod
    def forward(ctx, vec, mesh, axes, expert_axis):
        ctx.mesh, ctx.axes, ctx.expert_axis = mesh, axes, expert_axis
        ctx.n = math.prod(mesh.shape[a] for a in axes)
        out = vec.contiguous().clone()
        for axis in axes:
            all_reduce_(out, mesh, axis, prefix=EP_PREFIX)
        return _divide(out, ctx.n)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        for axis in ctx.axes:
            if axis != ctx.expert_axis:
                all_reduce_(g, ctx.mesh, axis, prefix=EP_PREFIX)
        return _divide(g, ctx.n), None, None, None


def _mean_stats(r: Routing, mesh: Mesh, axes: tuple):
    """(f, p, stats) averaged over the ranks of `axes`: one all-reduce of
    the packed ``[f, p, drop, load]`` vector per axis."""
    e = r.f.shape[0]
    packed = torch.cat([r.f, r.p, r.stats["drop_fraction"].reshape(1),
                        r.stats["expert_load"]])
    mean = _RoutingMean.apply(packed, mesh, axes, MODEL_AXIS)
    stats = {"drop_fraction": mean[2 * e].detach(),
             "expert_load": mean[2 * e + 1:].detach()}
    return mean[:e], mean[e:2 * e], stats


def moe_ffn_inner(params, x: torch.Tensor, mesh: Mesh,
                  capacity_factor: float = 1.25, aux_axes=None,
                  top_k: int = 1):
    """This rank's tokens ``[T_local, D]`` (tokens sharded over the model
    axis too) through the experts of the model group; `params`' expert
    leaves are this rank's (leading dim 1: one expert a rank). The router
    statistics and the health stats are averaged over `aux_axes`
    (default: the model axis), so aux is the dense oracle's global value;
    with equal token shards the drop fraction is the global one, and the
    expert load the mean of the shards' (each shard routes its T_local
    tokens with its own capacity C)."""
    n_experts = mesh.model
    t, d = x.shape
    capacity = capacity_of(t, n_experts, top_k, capacity_factor)
    r = _route(params["gate"], x, n_experts, capacity, top_k)
    axes = (MODEL_AXIS,) if aux_axes is None else tuple(aux_axes)
    f, p, stats = _mean_stats(r, mesh, axes)
    aux = n_experts * (f * p).sum()
    send = _dispatch(x, r, n_experts, capacity)  # row e: tokens for e
    # THE dispatch collective: rank m ends up with the C tokens every rank
    # routed to its expert, in rank order -> [1, E*C, D]
    recv = all_to_all(send, mesh, axis=MODEL_AXIS, split_axis=0,
                      concat_axis=1, prefix=EP_PREFIX)
    w1, b1, w2, b2 = (_take(params[k], 0) for k in EXPERT_LEAVES)
    out_tok = _expert_ffn(w1, b1, w2, b2, recv[0])  # [E*C, D]
    # the reverse: chunk s of out_tok goes back to rank s; what arrives
    # from rank e is expert e's outputs for this rank's tokens
    expert_out = all_to_all(out_tok.reshape(n_experts, capacity, d), mesh,
                            axis=MODEL_AXIS, split_axis=0, concat_axis=0,
                            prefix=EP_PREFIX)
    return _combine(expert_out, r).to(x.dtype), aux, stats


def _rank_experts(params, mesh: Mesh) -> dict:
    """`params` with the gate through `copy_to_model` and the expert
    stacks cut to this rank's expert (module docstring)."""
    stacks = [params[k] for k in EXPERT_LEAVES]
    if any(isinstance(s, QuantizedArray) for s in stacks):
        i = mesh.model_index
        mine = [QuantizedArray(s.q[i:i + 1], s.scale[i:i + 1], s.mode)
                if isinstance(s, QuantizedArray) else s[i:i + 1]
                for s in stacks]
    else:
        mine = scatter_leaves_to_model(stacks, mesh, 0, prefix=EP_PREFIX)
    return {"gate": copy_to_model(params["gate"], mesh, prefix=EP_PREFIX),
            **dict(zip(EXPERT_LEAVES, mine))}


def moe_ffn(params, x: torch.Tensor, mesh: Mesh,
            capacity_factor: float = 1.25, top_k: int = 1):
    """Expert-parallel switch FFN over `mesh`'s model axis, one expert a
    rank (E == the axis). `x` ``[T, D]``: this data rank's tokens, the
    same on every model rank (T % E == 0); the expert stacks whole on
    every rank. Returns ``(out [T, D], aux, stats)``, the same on every
    model rank."""
    e = mesh.model
    if params["gate"].shape[-1] != e:
        raise ValueError(
            f"n_experts {params['gate'].shape[-1]} != model axis {e}")
    if x.shape[0] % e:
        raise ValueError(f"{x.shape[0]} tokens % model axis {e} != 0: "
                         "expert parallelism shards the tokens")
    local = scatter_to_model(x, mesh, 0, prefix=EP_PREFIX)
    out, aux, stats = moe_ffn_inner(
        _rank_experts(params, mesh), local, mesh, capacity_factor,
        aux_axes=(DATA_AXIS, MODEL_AXIS), top_k=top_k)
    return gather_from_model(out, mesh, 0, prefix=EP_PREFIX), aux, stats


def moe_ffn_adaptive(params, x: torch.Tensor, capacity_factor: float = 1.25,
                     top_k: int = 1):
    """The entry models use: expert-parallel over the ambient mesh's model
    axis when it matches the expert count, else the dense oracle, so the
    same model runs on any mesh. A mismatch on a model axis wider than
    one falls back dense too, with the reference's warning (once per
    process and pair); ``ep_engaged`` in the stats says which ran."""
    mesh = ambient_mesh()
    e = params["gate"].shape[-1]
    axis = mesh.model if mesh is not None else 1
    if axis != e:
        if axis > 1 and (e, axis) not in _WARNED:
            _WARNED.add((e, axis))
            log.warning(
                "moe_ffn_adaptive: n_experts=%d != model axis %d — running "
                "DENSE (all experts local, no all_to_all dispatch); size "
                "the model axis to the expert count for expert parallelism",
                e, axis)
        out, aux, stats = moe_ffn_dense(params, x, capacity_factor, top_k)
        engaged = 0.0
    else:
        out, aux, stats = moe_ffn(params, x, mesh, capacity_factor, top_k)
        engaged = 1.0
    return out, aux, {**stats, "ep_engaged": torch.full(
        (), engaged, dtype=torch.float32, device=x.device)}
