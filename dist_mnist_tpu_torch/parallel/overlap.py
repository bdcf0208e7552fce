"""Communication/compute overlap for the FSDP step (port of the reference
`parallel/overlap.py`).

Under FSDP (`parallel/sharding.py`) every big param leaf lives 1/data-th
on each rank: the step all-gathers it before the forward and
reduce-scatters its gradient after the backward. The plain step
(`train/step.py`) does each as one flat collective, all of it exposed.
This module makes the schedule explicit and bucketed:

- `build_param_gather` returns the step's gather, a `StepGather` a
  step: it groups the FSDP leaves into BUCKETS (`_plan`: traversal
  order, a bucket closed by the leaf whose FULL bytes bring the running
  sum to `bucket_mb`) and owns both directions of the step:

  - overlapped: at step start every bucket's all-gather is issued at
    once (``async_op=True``), in plan order. The forward reads its
    params through `StepGather.params()`, a mapping whose entry is
    built at its first read: the model reads a top-level entry, and only
    then are the handles of the buckets holding its leaves waited on and
    the leaves unpacked. In the backward a hook on each gathered leaf
    notes its gradient, and a bucket whose leaves all have theirs is
    reduce-scattered (``async_op=True``). gloo pairs calls by the order
    they are issued, so every rank issues the flushes in one fixed
    order: back to front, the order the backward completes the buckets
    (when a bucket completes, every complete bucket from the back down
    to the first incomplete one is issued). `StepGather.finish` waits on
    every handle before the optimizer reads a gradient.
  - ``serial=True``, the ablation twin: the same buckets through the
    same collectives, but every gather is waited on, in order, before
    the forward, and after the whole backward the flushes run back to
    front, each waited on before the next is issued.

  Both move the same buffers through the same collectives; only the
  points where the host waits differ, so serial and overlapped are bit
  for bit equal for any number of ranks. On two data ranks each element
  of a reduce-scatter is one addition, so both also equal the plain FSDP
  step bit for bit. ``chunk="ring"`` gathers each leaf with n - 1
  `collectives.ring_shift` hops over ``data`` (pure copies) at its
  bucket's wait: a point-to-point exchange blocks, so the ring's buckets
  are gathered just in time rather than in the background. Leaves with
  no FSDP axis, and the tensor-parallel slices, stay local and keep the
  step's `psum_mean`.

- `plan_stats`: the plan as numbers (`OverlapHook` publishes them as
  ``overlap/*``), pure metadata, no collective.

- `prefetched_layer_matmul`: a stacked layer matmul whose weights are
  ZeRO-sharded over ``data``, all-gathering layer l+1's shard
  asynchronously while layer l's matmul runs, bit for bit the serial
  gather-then-matmul loop (the reference's answer for stacked layouts;
  forward only: no config calls it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Mapping

import torch

from dist_mnist_tpu_torch.cluster.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
)
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.parallel.sharding import ShardingRules, path_str
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, map_with_path

#: gather decompositions: one all-gather a bucket (per dtype), or the
#: explicit ring (n - 1 `ring_shift` hops a leaf)
CHUNK_MODES = ("all_gather", "ring")


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Knobs of the explicit FSDP gather/flush schedule.

    `bucket_mb` trades latency for pipelining: a bucket's gather is one
    collective, so tiny buckets pay a call per layer while one huge
    bucket degenerates to gather-everything-up-front. `serial=True` is
    the ablation twin, never a production setting: it exists so that the
    overlap's win is measurable as a controlled pair. Every field is in
    the compile-cache key fields (`compilecache/key_fields.py`)."""

    bucket_mb: float = 4.0
    chunk: str = "all_gather"  # | "ring"
    serial: bool = False  # True = the ablation twin (comm exposed)

    def __post_init__(self):
        if self.chunk not in CHUNK_MODES:
            raise ValueError(
                f"unknown overlap chunk mode {self.chunk!r}; use one of "
                f"{CHUNK_MODES}"
            )
        if not self.bucket_mb > 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")


def _full_nbytes(leaf, spec, mesh: Mesh) -> int:
    """Bytes of the full leaf whose slice on this rank is `leaf`, placed
    by `spec` (each split dim times its axis's size)."""
    n = math.prod(leaf.shape) * leaf.element_size()
    for axis in (MODEL_AXIS, DATA_AXIS):
        if spec.dim(axis) is not None:
            n *= mesh.shape[axis]
    return n


def _plan(params, mesh: Mesh, rules: ShardingRules, cfg: OverlapConfig,
          specs=None):
    """(paths, dims, full_bytes, buckets) for `params` under `rules`.

    `params` are FULL leaves placed by `rules` (the reference's call),
    or, with `specs` (a placed state's param specs), this rank's slices.
    `dims[i]` is the dim of leaf i that the FSDP axis splits (None: the
    leaf is not FSDP-sharded and stays local). Buckets are index groups
    of sharded leaves in traversal order, closed when the running sum of
    their full bytes reaches `bucket_mb`: the leaf that crosses the
    threshold closes its bucket."""
    axis = rules.fsdp_axis
    flat = flatten_with_path(params)
    if specs is None:
        leaf_specs = [rules.leaf_spec(path_str(p), v, mesh) for p, v in flat]
        nbytes = [math.prod(v.shape) * v.element_size() for _, v in flat]
    else:
        by_path = dict(flatten_with_path(specs))
        leaf_specs = [by_path[p] for p, _ in flat]
        nbytes = [_full_nbytes(v, s, mesh)
                  for (_, v), s in zip(flat, leaf_specs)]
    dims = [s.dim(axis) for s in leaf_specs]
    limit = max(1, int(cfg.bucket_mb * 2**20))
    buckets, cur, cur_bytes = [], [], 0
    for i, d in enumerate(dims):
        if d is None:
            continue
        cur.append(i)
        cur_bytes += nbytes[i]
        if cur_bytes >= limit:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(tuple(cur))
    return [p for p, _ in flat], dims, nbytes, buckets


def plan_stats(params, mesh: Mesh, rules: ShardingRules,
               cfg: OverlapConfig, specs=None) -> dict:
    """The gather plan for `params` as numbers (`_plan`'s arguments):
    what `OverlapHook` publishes as ``overlap/*`` and the bench reports.
    ``gathered_bytes`` counts the full leaves. No collective."""
    _, dims, nbytes, buckets = _plan(params, mesh, rules, cfg, specs)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    return {
        "buckets": len(buckets),
        "sharded_leaves": len(sharded),
        "total_leaves": len(dims),
        "gathered_bytes": sum(nbytes[i] for i in sharded),
        "bucket_mb": cfg.bucket_mb,
        "serial": cfg.serial,
        "chunk": cfg.chunk,
    }


def _ring_gather(loc: torch.Tensor, mesh: Mesh, d: int) -> torch.Tensor:
    """The full leaf of this rank's slice `loc` (split on dim `d` over
    ``data``) through n - 1 `ring_shift` hops: after k hops this rank
    holds slice (i + k) % n, which lands in its block. Pure copies."""
    n, i0, m = mesh.size, mesh.rank, loc.shape[d]
    out = loc.new_empty(loc.shape[:d] + (n * m,) + loc.shape[d + 1:])
    buf = loc
    for k in range(n):
        out.narrow(d, ((i0 + k) % n) * m, m).copy_(buf)
        if k < n - 1:
            buf = collectives.ring_shift(buf, mesh, axis=DATA_AXIS,
                                         reverse=True)
    return out


class _Gathered:
    """One bucket's gather in flight: per dtype, the all-gather's output
    and handle (the ring gathers at `wait`)."""

    def __init__(self, idx, shards, dims, mesh: Mesh, chunk: str):
        self.idx, self.dims, self.mesh, self.chunk = idx, dims, mesh, chunk
        self.shards = shards
        self.groups = []
        if chunk == "ring":
            return
        by_dtype: dict = {}
        for j, s in enumerate(shards):
            by_dtype.setdefault(s.dtype, []).append(j)
        for js in by_dtype.values():
            moved = [shards[j].movedim(dims[j], 0) for j in js]
            flat = torch.cat([m.reshape(-1) for m in moved])
            out, work = collectives.all_gather_flat(flat, mesh,
                                                    async_op=True)
            self.groups.append((js, moved, out, work))

    def wait(self) -> list[torch.Tensor]:
        """The bucket's full leaves, in its order (waits first)."""
        if self.chunk == "ring":
            return [_ring_gather(s, self.mesh, d)
                    for s, d in zip(self.shards, self.dims)]
        n = self.mesh.size
        full: list = [None] * len(self.shards)
        for js, moved, out, work in self.groups:
            if work is not None:
                # before the first kernel that reads `out`, the unpacking
                # below included
                work.wait()
            rows = out.view(n, -1)
            off = 0
            for j, m in zip(js, moved):
                k = m.numel()
                block = rows[:, off:off + k].reshape(n * m.shape[0],
                                                     *m.shape[1:])
                full[j] = block.movedim(0, self.dims[j]).contiguous()
                off += k
        return full


class _Flushed:
    """One bucket's reduce-scatter in flight."""

    def __init__(self, grads, dims, mesh: Mesh):
        for axis in (SEQ_AXIS, PIPE_AXIS):
            # each rank's share is summed over the seq and pipe ranks
            # first (the step's rule, `train/step._reduce_grads`)
            grads = collectives.sum_over_axis(grads, mesh, axis)
        n = mesh.size
        self.grads, self.dims, self.mesh = grads, dims, mesh
        self.rows = [g.movedim(d, 0).reshape(n, -1).to(torch.float32)
                     for g, d in zip(grads, dims)]
        flat = torch.cat(self.rows, dim=1).reshape(-1)
        self.out, self.work = collectives.reduce_scatter_flat(
            flat, mesh, async_op=True)

    def wait(self) -> list[torch.Tensor]:
        """This rank's slice of the mean of each leaf's gradient over the
        data ranks (`collectives.reduce_scatter_leaves`' layout and
        division)."""
        if self.work is not None:
            self.work.wait()
        n = self.mesh.size
        mine = collectives._divide(self.out, n)
        out, off = [], 0
        for g, d, r in zip(self.grads, self.dims, self.rows):
            k = r.shape[1]
            moved_shape = (g.shape[d] // n,
                           *[s for i, s in enumerate(g.shape) if i != d])
            out.append(mine[off:off + k].reshape(moved_shape).movedim(0, d)
                       .contiguous().to(g.dtype))
            off += k
        return out


class _LazyParams(Mapping):
    """The params tree for the forward: its entry `key` is built at its
    first read, after the buckets holding its leaves are waited on."""

    def __init__(self, step: "StepGather"):
        self._step = step
        self._built: dict = {}

    def __getitem__(self, key):
        if key not in self._built:
            self._built[key] = self._step.subtree(key)
        return self._built[key]

    def __iter__(self):
        return iter(self._step.tree)

    def __len__(self):
        return len(self._step.tree)


class StepGather:
    """One step's gather and flush over this rank's `params` (slices
    placed by `specs`); see the module docstring. `params()` feeds the
    forward, `leaves()` gives the gathered leaves autograd differentiates
    (the hooks armed), `finish(grads)` the gradients in this rank's
    placement."""

    def __init__(self, params, specs, mesh: Mesh, rules: ShardingRules,
                 cfg: OverlapConfig):
        self.tree, self.mesh, self.cfg = params, mesh, cfg
        self.paths, self.dims, _, self.buckets = _plan(
            params, mesh, rules, cfg, specs)
        self._local = [leaf for _, leaf in flatten_with_path(params)]
        self._index = {p: i for i, p in enumerate(self.paths)}
        self._bucket_of = {i: b for b, idx in enumerate(self.buckets)
                           for i in idx}
        self._tracked: dict = {}
        self._pending: dict = {}
        self._grads: dict = {}
        self._left = [len(idx) for idx in self.buckets]
        self._flushes: dict = {}
        self._next_flush = len(self.buckets) - 1
        self._hooks = []
        with torch.no_grad():
            for b, idx in enumerate(self.buckets):
                self._pending[b] = _Gathered(
                    idx, [self._local[i] for i in idx],
                    [self.dims[i] for i in idx], mesh, cfg.chunk)
                if cfg.serial:
                    self._resolve(b)

    def _resolve(self, b: int) -> None:
        gathered = self._pending.pop(b, None)
        if gathered is None:
            return
        with torch.no_grad():
            full = gathered.wait()
        for i, leaf in zip(gathered.idx, full):
            self._tracked[i] = leaf.detach().requires_grad_()

    def _leaf(self, i: int) -> torch.Tensor:
        if i not in self._tracked:
            b = self._bucket_of.get(i)
            if b is None:  # no FSDP axis: this rank's leaf, as it is
                self._tracked[i] = self._local[i].detach().requires_grad_()
            else:
                self._resolve(b)
        return self._tracked[i]

    def subtree(self, key):
        """The params entry `key` with every leaf gathered (its buckets
        waited on here)."""
        return map_with_path(
            lambda path, _: self._leaf(self._index[(key, *path)]),
            self.tree[key])

    def params(self) -> _LazyParams:
        """The tree the forward reads (the models' params are dicts read
        by top-level key)."""
        return _LazyParams(self)

    def leaves(self) -> list[torch.Tensor]:
        """Every gathered leaf in traversal order (a leaf the forward
        never read gathered now); in the overlapped schedule each FSDP
        leaf's gradient hook is armed here, before the backward."""
        leaves = [self._leaf(i) for i in range(len(self.paths))]
        if not self.cfg.serial:
            for b, idx in enumerate(self.buckets):
                for i in idx:
                    self._hooks.append(leaves[i].register_hook(
                        lambda g, i=i, b=b: self._on_grad(i, b, g)))
        return leaves

    def _on_grad(self, i: int, b: int, g: torch.Tensor) -> None:
        if i not in self._grads:
            self._grads[i] = g
            self._left[b] -= 1
        # issue in the one fixed order (back to front) every complete
        # bucket down to the first incomplete one
        while self._next_flush >= 0 and self._left[self._next_flush] == 0:
            self._flush(self._next_flush)
            self._next_flush -= 1

    def _flush(self, b: int) -> None:
        idx = self.buckets[b]
        with torch.no_grad():
            self._flushes[b] = _Flushed([self._grads[i] for i in idx],
                                        [self.dims[i] for i in idx],
                                        self.mesh)

    def finish(self, grads: list[torch.Tensor]) -> dict:
        """``{path: gradient slice}`` of the FSDP leaves from the full
        gradients `grads` (traversal order): the flushes not yet issued
        are issued back to front (the serial twin waits on each before
        the next), then every handle is waited on."""
        for h in self._hooks:
            h.remove()
        for i, g in enumerate(grads):
            self._grads.setdefault(i, g)
        mine = {}
        for b in range(len(self.buckets) - 1, -1, -1):
            if b not in self._flushes:
                self._flush(b)
            if self.cfg.serial:
                mine[b] = self._flushes.pop(b).wait()
        with torch.no_grad():
            for b in sorted(self._flushes, reverse=True):
                mine[b] = self._flushes.pop(b).wait()
        return {self.paths[i]: g for b, idx in enumerate(self.buckets)
                for i, g in zip(idx, mine[b])}


def build_param_gather(mesh: Mesh | None, rules: ShardingRules,
                       cfg: OverlapConfig):
    """The explicit FSDP gather and flush schedule of a training step
    (module docstring): ``begin(params, specs, mesh) -> StepGather``,
    which issues (or, serial, runs) one step's gathers of `params`, this
    rank's slices placed by `specs`. Refuses rules without an FSDP axis,
    with the reference's message. `mesh` is the reference's argument;
    each step gathers on its state's mesh."""
    if rules.fsdp_axis is None:
        raise ValueError(
            "communication/compute overlap needs an fsdp strategy: the "
            f"active sharding rules {rules.rules or '(dp)'} have no "
            "fsdp_axis, so there are no parameter shards to prefetch. "
            "Use sharding_rules='fsdp' or 'fsdp_tp'."
        )
    return functools.partial(StepGather, rules=rules, cfg=cfg)


def prefetched_layer_matmul(x: torch.Tensor, ws: torch.Tensor, mesh: Mesh,
                            axis: str = DATA_AXIS,
                            activation=torch.tanh) -> torch.Tensor:
    """Layer-stack matmul with one-layer-ahead weight prefetch.

    x:  ``[B/n, D]``, this rank's rows.
    ws: ``[L, D/n, D]``, this rank's slice of every layer's input dim
        (the ZeRO layout: the reference's ``[L, D, D]`` with dim 1 split
        over `axis`).
    Applies ``h = activation(h @ W_l)`` for l = 0..L-1: layer l+1's
    slices are all-gathered asynchronously (issued before layer l's
    matmul, waited on after it). Returns ``[B/n, D]``, bit for bit the
    serial gather-then-matmul loop (gathers are pure copies)."""
    n = mesh.shape[axis]
    if ws.ndim != 3 or ws.shape[0] < 1:
        raise ValueError(f"ws must be a [L, D/n, D] layer stack, got "
                         f"{tuple(ws.shape)}")
    if ws.shape[1] * n != ws.shape[2]:
        raise ValueError(f"ws {tuple(ws.shape)}: dim 1 must be D/{axis}"
                         f"={ws.shape[2]}/{n}")

    def issue(w_shard):  # [D/n, D] -> gather in flight
        return collectives.all_gather_flat(w_shard.reshape(-1), mesh, axis,
                                           async_op=True)

    def full(pending):  # the gathered [D, D]
        out, work = pending
        if work is not None:
            work.wait()
        return out.view(ws.shape[2], ws.shape[2])

    h, w_cur = x, full(issue(ws[0]))
    for w_next_shard in ws[1:]:
        pending = issue(w_next_shard)  # prefetch: no dep on the matmul
        h = activation(h @ w_cur)
        w_cur = full(pending)
    return activation(h @ w_cur)
