"""Sync-replica semantics: gradient accumulation over microbatches (port
of the reference `optim/sync.py`).

The reference's SyncReplicasOptimizer aggregated `replicas_to_aggregate`
fresh gradients per update on the parameter servers. Under data
parallelism the aggregate-then-apply barrier is the step's all-reduce
over ranks (`parallel/collectives.psum_mean`); aggregating MORE than one
minibatch per update maps to this module: accumulate k microbatch
gradients, apply on the k-th. Dropping the slowest replicas' gradients
(backup replicas) has no counterpart in a lockstep step, as in the
reference.
"""

from __future__ import annotations

import torch

from dist_mnist_tpu_torch.optim.base import Optimizer, tree_device
from dist_mnist_tpu_torch.utils.tree import tree_map


def gradient_accumulation(inner: Optimizer, every: int) -> Optimizer:
    """Apply `inner` once per `every` calls, on the mean of the buffered
    gradients; between boundaries the updates are zeros (params stay).

    Branchless, as the reference: the inner update runs on every call on
    the running mean and its updates and state are kept only at a
    boundary (`torch.where` on a device flag), so no call waits on the
    device to decide."""
    if every < 1:
        raise ValueError("`every` must be >= 1")
    if every == 1:
        return inner

    def init(params):
        return {
            "acc": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params),
            "calls": torch.zeros((), dtype=torch.int32,
                                 device=tree_device(params)),
            "inner": inner.init(params),
        }

    def update(grads, state, params):
        calls = state["calls"] + 1
        boundary = (calls % every) == 0
        div = torch.full((), float(every), dtype=torch.float32,
                         device=calls.device)
        acc = tree_map(lambda a, g: a + g.to(torch.float32) / div,
                       state["acc"], grads)
        inner_updates, inner_state = inner.update(acc, state["inner"], params)
        updates = tree_map(
            lambda u: torch.where(boundary, u, torch.zeros_like(u)),
            inner_updates)
        new_inner = tree_map(lambda new, old: torch.where(boundary, new, old),
                             inner_state, state["inner"])
        new_acc = tree_map(
            lambda a: torch.where(boundary, torch.zeros_like(a), a), acc)
        return updates, {"acc": new_acc, "calls": calls, "inner": new_inner}

    return Optimizer(init, update)
