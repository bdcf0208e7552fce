"""The inference engine: a (batch, height) grid of cells over one device
or a mesh of ranks (port of the reference `serve/engine.py
InferenceEngine`).

Why buckets: a continuous batcher produces a different batch size every
tick. Rounding up to a power of two caps the distinct shapes the device
sees at log2(max_batch)+1 while wasting at most 2x compute on padding —
and padding rows are sliced off before any result leaves the engine.
With a `serve/zoo.SeqGrid` the grid gains a height axis: a batch of
shorter images is padded up to its height bucket and served with a token
mask (the variant contract under `predict`).

There is no XLA executable to cache: PyTorch runs eagerly. What the
reference's AOT cache did for a first request — move the one-time cost
out of live traffic — `prewarm()` does here by running every cell once
(building or loading the CUDA kernels' libraries and initializing the
cuBLAS/cuDNN handles). `CompiledModelCache` is the cache of those warmed
cells: keyed as the reference's `_key` (model, cell shape, mesh, dtype
and quant mode, variant), it counts a cell's first run as a miss (its
wall clock is the reference's "compile" ms, journaled as
``compile_cache`` ``compile``) and every later run as a memory hit, in
the reference's `stats()` shape. In-process replicas of one model share
one cache (`cache=`), so a replica added later finds its cells warm and
pays no miss. `cache_stats()` keeps this engine's own runs per cell and
their host-clock seconds (`execute_secs`).

The serve memory budget keeps the reference's accounting: the weights
(`state_bytes_per_device`) are the floor, and a cell counts its
transient peak on the card — the rise of `torch.cuda.max_memory_allocated`
over its first run (0 on the CPU, the reference's rule for a backend
without a memory analysis). Weights over the budget refuse at
construction, a grid whose cells cannot all stay resident refuses at
`prewarm` (`ServeMemoryBudgetError`), and live traffic evicts the
least recently used cell. An eager engine holds no per-cell program, so
an eviction frees nothing on the card (the caching allocator keeps its
blocks, the kernel libraries stay loaded): it drops the cell from the
accounting, and the cell's next run counts as a miss again and is
measured again. The reference's disk tier is the process's persistent
cache of built kernel libraries (`compilecache.persistent_cache`, which
`cli.serve` and `cli.router` enter): a cell's first run builds or loads
its kernels through it, and a cache given its `store` reports that
store's counters in `stats()`.

`swap_weights` replaces the served weights in place: both trees checked
(structure and per-leaf shape), a float tree re-quantized for an int8
engine, every leaf copied to the device and the copy finished before the
pointers move. A batch already running keeps the old tensors; a failure
leaves the old weights serving.

On a mesh of ranks (`mesh`, one device per process) the weights are
resident-sharded by the serve rules (`parallel/sharding.py`: a TP leaf
keeps this rank's model slice, an FSDP leaf its data slice), the batch
rides the ``data`` axis as in training (a bucket of B runs B/data rows a
rank, so the smallest bucket is the least power of two at or above the
data axis), FSDP leaves are all-gathered over ``data`` before each
forward (`train/step.py` does the same), and the forward runs under
`activate(mesh)`, so the ViT's TP block and an MoE block's expert
parallelism run as in the step. Rank 0 (the chief) owns the server, the
batcher and the loadgen: for each cell it runs it broadcasts the cell's
host inputs (the padded images and the mask) to every rank, and every
other rank runs `follow()` until the chief's `close()`, so every
collective runs on every rank in the same order (the decode engine's
protocol, `serve/decode.py`). The chief sends a message and runs its
collectives under one lock, so a swap, an asynchronous prewarm and the
batcher never interleave their messages and collectives. The data
ranks' logits are all-gathered, and the chief returns them.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from dist_mnist_tpu_torch.cluster.mesh import DATA_AXIS, MODEL_AXIS, activate
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.ops.nn import normalize_images
from dist_mnist_tpu_torch.ops.quant import (
    QuantizedArray,
    is_quantized,
    quantize_tree,
)
from dist_mnist_tpu_torch.parallel.collectives import all_gather_flat
from dist_mnist_tpu_torch.parallel.sharding import (
    DP_RULES,
    derive_state_specs,
    gather_tree,
    shard_tree,
)
from dist_mnist_tpu_torch.utils.device import resolve_device
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, leaves, tree_map

log = logging.getLogger(__name__)


class ServeMemoryBudgetError(RuntimeError):
    """The serve-side memory budget cannot hold the requested working set:
    either the weights alone exceed it, or the prewarm grid's cells would
    evict each other (thrash) instead of all staying resident."""


class WarmCell:
    """One warmed cell of the grid, the port's cache entry in place of the
    reference's executable: the bytes its first run took on the card (the
    rise of the peak allocation over that run; 0 on the CPU)."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int = 0):
        self.nbytes = int(nbytes)

    @classmethod
    def measure(cls, fn, device: torch.device) -> "WarmCell":
        """Run `fn()` (a cell's first run) and record its transient peak.
        Concurrent runs on the same card count into the peak too, so under
        traffic the figure is an upper bound."""
        if device.type != "cuda":
            fn()
            return cls(0)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize(device)
        return cls(max(0, torch.cuda.max_memory_allocated(device) - before))


class CompiledModelCache:
    """key -> warmed cell, with hit/miss counters, per-key first-run
    ("compile") attribution and an optional MEMORY BUDGET (the
    reference's `CompiledModelCache`, over an eager engine's cells;
    module docstring).

    `get(key, build)` returns the entry for `key`: a memory hit, or a miss
    that calls `build()` under the lock (concurrent misses for one cell
    must not both run it) and records its wall ms as ``compile_ms``.
    `store` (the active persistent cache's kernel store) is reported in
    `stats()`.

    With a budget (`set_budget`), every insert that pushes `base_bytes`
    (served weights) + the cells' bytes past the cap evicts the COLDEST
    other entries (LRU by last touch) until it fits, and raises
    `ServeMemoryBudgetError` when even an empty cache could not hold the
    new entry. An evicted cell is a miss again on its next use;
    `evictions` counts them."""

    def __init__(self, store=None):
        self._lock = threading.Lock()
        self._cache: dict = {}
        self._store = store
        self.hits = 0
        self.misses = 0
        self.hits_memory = 0
        #: the reference's disk tier of executables: an eager engine has
        #: none, so this stays 0 (the store holds kernel libraries)
        self.hits_disk = 0
        self.evictions = 0
        self.budget_bytes: int | None = None
        self.base_bytes = 0  # served weights, counted against the budget
        self._tick = 0  # LRU clock: bumped on every touch
        #: key -> {"tier", "compile_ms", "load_ms", "hits", "nbytes",
        #:         "last_used"}
        self.per_key: dict = {}
        #: accumulated seconds: "compile" (first runs), "execute" and
        #: "execute_count" (every run, engine-recorded)
        self.times: dict = {}

    def set_budget(self, budget_bytes: int | None, *,
                   base_bytes: int = 0) -> None:
        """Arm (or disarm, None) the memory budget. `base_bytes` is the
        non-evictable floor — the served weights' per-device bytes (an
        int8 engine's floor is what lets a budget that refuses the float
        weights admit the int8 ones)."""
        with self._lock:
            if budget_bytes is not None and base_bytes > budget_bytes:
                raise ServeMemoryBudgetError(
                    f"served weights alone ({base_bytes} B/device) exceed "
                    f"the serve memory budget ({budget_bytes} B)")
            self.budget_bytes = budget_bytes
            self.base_bytes = base_bytes

    def _cells_bytes_locked(self) -> int:
        return sum(v.get("nbytes", 0) for k, v in self.per_key.items()
                   if k in self._cache)

    def _admit_locked(self, key, nbytes: int) -> None:
        """Evict the coldest entries (never `key`) until the budget
        holds."""
        if self.budget_bytes is None:
            return
        if self.base_bytes + nbytes > self.budget_bytes:
            self._cache.pop(key, None)
            raise ServeMemoryBudgetError(
                f"cell {key} ({nbytes} B) cannot fit the serve memory "
                f"budget ({self.budget_bytes} B) even alone next to the "
                f"weights ({self.base_bytes} B)")
        while self.base_bytes + self._cells_bytes_locked() \
                > self.budget_bytes:
            victim = min((k for k in self._cache if k != key),
                         key=lambda k: self.per_key[k].get("last_used", 0))
            del self._cache[victim]
            self.evictions += 1
            log.info("evicted %s (LRU) to hold the serve memory budget",
                     victim)
            events.emit("compile_cache", outcome="evict", key=str(victim))

    def get(self, key, build):
        """The entry for `key`: the memory tier, else `build()` (a miss,
        run under the lock)."""
        with self._lock:
            self._tick += 1
            if key in self._cache:
                self.hits += 1
                self.hits_memory += 1
                self.per_key[key]["hits"] += 1
                self.per_key[key]["last_used"] = self._tick
                return self._cache[key]
            self.misses += 1
            t0 = time.perf_counter()
            exe = build()
            dt = time.perf_counter() - t0
            self.times["compile"] = self.times.get("compile", 0.0) + dt
            compile_ms = dt * 1e3
            self.per_key[key] = {"tier": "fresh", "compile_ms": compile_ms,
                                 "load_ms": 0.0, "hits": 0,
                                 "nbytes": exe.nbytes,
                                 "last_used": self._tick}
            self._cache[key] = exe
            self._admit_locked(key, self.per_key[key]["nbytes"])
            log.info("warmed %s (miss #%d, %.0f ms)", key, self.misses,
                     compile_ms)
            events.emit("compile_cache", outcome="compile", key=str(key),
                        compile_ms=round(compile_ms, 3))
            return exe

    def touch(self, key) -> bool:
        """A memory hit on `key` when the cache holds it (True), without
        building anything (False): the prewarm/rewarm walk."""
        with self._lock:
            self._tick += 1
            if key not in self._cache:
                return False
            self.hits += 1
            self.hits_memory += 1
            self.per_key[key]["hits"] += 1
            self.per_key[key]["last_used"] = self._tick
            return True

    def record_execute(self, seconds: float) -> None:
        """One executed batch's host-clock seconds (every run)."""
        with self._lock:
            self.times["execute"] = self.times.get("execute", 0.0) + seconds
            self.times["execute_count"] = \
                self.times.get("execute_count", 0) + 1

    def stats(self) -> dict:
        with self._lock:
            cells = self._cells_bytes_locked()
            out = {
                "hits": self.hits,
                "misses": self.misses,
                "hits_memory": self.hits_memory,
                "hits_disk": self.hits_disk,
                "evictions": self.evictions,
                "entries": len(self._cache),
                "resident_bytes": self.base_bytes + cells,
                "resident_bytes_weights": self.base_bytes,
                "resident_bytes_executables": cells,
                "budget_bytes": self.budget_bytes,
                "compile_secs": self.times.get("compile", 0.0),
                "execute_secs": self.times.get("execute", 0.0),
                "execute_count": self.times.get("execute_count", 0),
                "per_key": {str(k): dict(v)
                            for k, v in self.per_key.items()},
            }
        if self._store is not None:
            out["store"] = self._store.stats()
        return out


def _check_like(old, new, what: str) -> None:
    """Raise unless `new` has `old`'s tree structure and every leaf its
    shape (an int8 leaf: its int8 payload's and its scales')."""
    a, b = flatten_with_path(old), flatten_with_path(new)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise ValueError(f"swap {what} tree mismatch: "
                         f"{[p for p, _ in a]} vs {[p for p, _ in b]}")
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, QuantizedArray) != isinstance(y, QuantizedArray):
            raise ValueError(f"swap {what} leaf {path}: quantized vs float")
        pairs = (((x.q, y.q), (x.scale, y.scale))
                 if isinstance(x, QuantizedArray) else ((x, y),))
        for u, v in pairs:
            if tuple(u.shape) != tuple(v.shape):
                raise ValueError(
                    f"swap shape mismatch at {what} {path}: "
                    f"{tuple(u.shape)} vs {tuple(v.shape)}")


def _to_cpu(leaf):
    return leaf.to("cpu")


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _nbytes(leaf) -> int:
    """Resident bytes of a leaf: int8 payload at 1 byte + its f32 scales."""
    tensors = ((leaf.q, leaf.scale) if isinstance(leaf, QuantizedArray)
               else (leaf,))
    return sum(t.numel() * t.element_size() for t in tensors)


class InferenceEngine:
    """Stateless-forward inference over a fixed (model, weights, device).

    `predict(images)` takes a host batch of raw uint8 images `[n, h, W, C]`
    and returns f32 logits `[n, classes]`; padding, placement and
    unpadding are internal. Normalization is the reference's (`x/255`,
    IEEE division: `ops.nn.normalize_images`). Without a `seq_grid` only
    the native height `image_shape[0]` is servable.
    """

    def __init__(
        self,
        model,
        params,
        model_state,
        *,
        device: str | torch.device | None = None,
        image_shape: tuple[int, ...],
        max_bucket: int = 256,
        seq_grid=None,
        quant: str | None = None,
        quant_report: dict | None = None,
        mesh=None,
        rules=None,
        specs=None,
        model_name: str = "model",
        cache: CompiledModelCache | None = None,
        store=None,
        memory_budget_bytes: int | None = None,
    ):
        """`mesh` (several ranks): serve sharded by `rules` (default DP).
        `params` and `model_state` are then this rank's shards as `specs`
        (a `parallel.sharding.StateSpecs`: `serve/loader.py` restores and
        shards them), or, without `specs`, full leaves this engine
        shards.

        `cache` lets N same-model replicas share one `CompiledModelCache`
        (a replica added later finds its cells warm); a given cache keeps
        ITS store, `store` only seeds a fresh one. `memory_budget_bytes`
        arms the cache's budget with this engine's weights as the floor
        (refused here when the weights alone exceed it)."""
        self.model = model
        self.model_name = model_name
        self.mesh = mesh if mesh is not None and mesh.ranks > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.image_shape = tuple(image_shape)
        #: serve/zoo.SeqGrid (or None): the height axis of the 2-D
        #: (batch, height) grid; None = the 1-D batch grid at the native
        #: image shape
        self.seq_grid = seq_grid
        if seq_grid is not None and (
                seq_grid.native_height != self.image_shape[0]
                or (seq_grid.width, seq_grid.channels)
                != tuple(self.image_shape[1:])):
            raise ValueError(
                f"seq_grid native shape ({seq_grid.native_height}, "
                f"{seq_grid.width}, {seq_grid.channels}) != engine image "
                f"shape {self.image_shape}")
        # weight-only quantized serving (ops/quant.py): an already-
        # quantized tree tags the engine; quant="int8" quantizes a float one
        if quant is None and is_quantized(params):
            quant = "int8"
        if quant is not None and quant != "int8":
            raise ValueError(f"unsupported quant mode {quant!r} "
                             "(supported: 'int8')")
        if quant and self.mesh is not None:
            raise ValueError(
                "--quant over more than one rank joins the port with ROADMAP "
                "§1 item 12's rest: a per-channel scale of a row-parallel "
                "slice is not the whole leaf's, so the sharded int8 forward "
                "would not be the one-rank one")
        if quant and not is_quantized(params):
            params = quantize_tree(params)
        self.quant = quant
        self.quant_report = quant_report
        self.cache = (cache if cache is not None
                      else CompiledModelCache(store=store))
        self.specs = None
        if self.mesh is not None:
            params, model_state = self._place(model, params, model_state,
                                              rules, specs)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.model_state = tree_map(lambda t: t.to(self.device), model_state)
        # buckets must divide over the data axis; the least power of two
        # at or above the axis always does
        self._data = 1 if self.mesh is None else self.mesh.size
        self.min_bucket = _pow2_at_least(self._data)
        if self.mesh is not None and self.min_bucket % self._data:
            raise ValueError(f"a data axis of {self._data} ranks divides no "
                             "power-of-two bucket")
        self.max_bucket = max(max_bucket, self.min_bucket)
        self._lock = threading.Lock()
        #: held by the chief of a sharded engine from a message to the end
        #: of the collectives it starts (`_run`, `swap_weights`, `close`):
        #: the followers take the messages in the order they arrive
        self._chief = threading.Lock()
        # (batch bucket, height bucket, "dense" | "masked") -> batches run
        self._runs: dict[tuple[int, int, str], int] = {}
        self._execute_secs = 0.0
        #: batches `predict` ran per height bucket (the benches' routing
        #: counts; prewarm's runs are not traffic)
        self.seq_bucket_counts: dict[int, int] = {}
        #: version tag of the weights served (a train step after a hot
        #: swap; 0 for the construction-time weights)
        self.weights_version = 0
        # an MoE model returns its routed drop fraction beside the logits
        # (never silent truncation); the last batch's is kept here for the
        # batcher to record
        self._moe = (isinstance(model_state, dict)
                     and "moe_drop_fraction_metric" in model_state)
        self.last_moe_drop_fraction: float | None = None
        self._closed = False
        # without a budget of its own the engine keeps a shared cache's
        # arming and still records the weights floor, so the stats'
        # weights-vs-cells split is live
        self.cache.set_budget(
            memory_budget_bytes if memory_budget_bytes is not None
            else self.cache.budget_bytes,
            base_bytes=self.state_bytes_per_device()["total_bytes"])

    def _place(self, model, params, model_state, rules, specs):
        """This rank's shards and their specs under `rules` on the mesh;
        refuses a placement the model's forward cannot run."""
        from types import SimpleNamespace

        mesh = self.mesh
        if mesh.seq > 1 or mesh.pipe > 1:
            raise ValueError(
                f"mesh {mesh.shape}: the zoo serves over the data and model "
                "axes (a seq or pipe axis shards a training step)")
        if specs is None:
            specs = derive_state_specs(SimpleNamespace(
                params=params, model_state=model_state, opt_state={}),
                mesh, rules if rules is not None else DP_RULES)
            params = shard_tree(params, specs.params, mesh)
            model_state = shard_tree(model_state, specs.model_state, mesh)
        self.specs = specs
        tp_placed = any(spec.dim(MODEL_AXIS) is not None
                        for spec in leaves(specs.params))
        tp_forward = getattr(model, "tensor_parallel", False)
        if mesh.model > 1 and tp_placed and not tp_forward:
            raise ValueError(
                f"{type(model).__name__} has no tensor-parallel forward; "
                "the port's TP rules serve ViT-Tiny (models/vit.py)")
        if mesh.model > 1 and tp_forward and not tp_placed:
            raise ValueError(
                f"{type(model).__name__} runs its TP block on a model axis "
                "of the mesh: serve it under TP rules (--serve_rules=tp or "
                "fsdp_tp)")
        return params, model_state

    @property
    def is_follower(self) -> bool:
        """A rank of a sharded engine other than the chief (rank 0)."""
        return self.mesh is not None and torch.distributed.get_rank() != 0

    def state_bytes_per_device(self) -> dict:
        """Resident bytes of the SERVED weights on this rank (its shards
        on a mesh; int8 leaves at 1 byte per element plus their f32
        scales)."""
        out = {
            "param_bytes": sum(_nbytes(x) for x in leaves(self.params)),
            "model_state_bytes": sum(_nbytes(x)
                                     for x in leaves(self.model_state)),
        }
        out["total_bytes"] = out["param_bytes"] + out["model_state_bytes"]
        return out

    # -- hot swap ------------------------------------------------------------
    def swap_weights(self, params, model_state, *,
                     version: int | None = None) -> None:
        """Replace the served weights in place; no cell runs again.

        An int8 engine re-quantizes an incoming float tree first (the
        rollout hands over full-width checkpoints). Both trees are checked
        (structure and per-leaf shape) and every leaf is copied to the
        device, the copy finished, BEFORE the pointers move, so a failure
        leaves the old weights serving. A batch already running keeps the
        tensors it read at its start; the swap shows from the next
        `predict`.

        On a sharded engine the chief takes full (unsharded) trees: each
        rank keeps its own slice under the construction's specs, as
        `_place` does, and the chief sends the trees to the followers
        through the `follow` protocol, so every rank swaps between the
        same two cells."""
        if self.is_follower:
            raise RuntimeError("a follower engine swaps only on the chief's "
                               "message (follow)")
        if self.quant and not is_quantized(params):
            params = quantize_tree(params)
        new_p, new_ms = self._stage_weights(params, model_state)
        if self.mesh is None:
            self._commit_weights(new_p, new_ms, version)
            return
        with self._chief:
            # the followers get the full trees (host copies) and stage
            # their own slices; the chief's own are staged already
            self._broadcast(("swap", tree_map(_to_cpu, params),
                             tree_map(_to_cpu, model_state), version))
            self._commit_weights(new_p, new_ms, version)

    def _stage_weights(self, params, model_state):
        """This rank's copies of the new trees on its device, checked
        against the served ones and finished copying."""
        if self.mesh is not None:
            params = shard_tree(params, self.specs.params, self.mesh)
            model_state = shard_tree(model_state, self.specs.model_state,
                                     self.mesh)
        _check_like(self.params, params, "params")
        _check_like(self.model_state, model_state, "model_state")
        new_p = tree_map(lambda t: t.to(self.device), params)
        new_ms = tree_map(lambda t: t.to(self.device), model_state)
        if self.device.type == "cuda":
            # fail HERE, not mid-predict: the copies are done before the
            # pointers move
            torch.cuda.synchronize(self.device)
        return new_p, new_ms

    def _commit_weights(self, new_p, new_ms, version) -> None:
        with self._lock:
            self.params = new_p
            self.model_state = new_ms
            if version is not None:
                self.weights_version = int(version)
        log.info("swapped weights (version=%s)", self.weights_version)

    # -- bucketing -----------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError("empty batch")
        b = max(_pow2_at_least(n), self.min_bucket)
        if b > self.max_bucket:
            raise ValueError(
                f"batch {n} needs bucket {b} > max_bucket {self.max_bucket}; "
                "raise max_bucket or split the batch upstream"
            )
        return b

    def seq_bucket_for(self, height: int) -> int:
        """Height bucket for one request height; without a seq grid only
        the native height is servable."""
        if self.seq_grid is None:
            if height != self.image_shape[0]:
                raise ValueError(
                    f"height {height} != native {self.image_shape[0]} and "
                    "this engine has no seq grid (serve/zoo.py)")
            return height
        return self.seq_grid.bucket_for(height)

    def buckets(self) -> list[int]:
        """Every batch bucket this engine can execute, smallest first."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return out

    def grid(self) -> list[tuple[int, int]]:
        """Every (batch bucket, height bucket) pair, smallest first; without
        a seq grid one native-height column."""
        heights = (list(self.seq_grid.heights) if self.seq_grid is not None
                   else [self.image_shape[0]])
        return [(b, h) for b in self.buckets() for h in heights]

    # -- execution -----------------------------------------------------------
    # Variant contract (the reference's): `mask=None` is the maskless
    # NATIVE program; every masked cell takes a token mask, the masked
    # native-shaped cell included — a real height between the largest
    # sub-native bucket and native rounds UP into the native bucket but
    # still needs its padding masked.

    def _run(self, images: np.ndarray, mask: np.ndarray | None) -> np.ndarray:
        """One padded cell through the model; on a mesh the chief first
        sends the cell to the followers."""
        if self.mesh is None:
            return self._execute(images, mask)
        if self.is_follower:
            raise RuntimeError("a follower engine runs only the chief's "
                               "cells (follow)")
        with self._chief:
            self._broadcast(("run", images, mask))
            return self._execute(images, mask)

    def _key(self, bucket: int, height: int, variant: str):
        """The cache key of a cell: the reference's `_key` (model, cell
        shape, mesh, dtype with the quant mode, variant; an MoE model's
        capacity factor), with the device, since a warmed cell is a
        device's."""
        mesh_key = (tuple(sorted(self.mesh.shape.items()))
                    if self.mesh is not None else ())
        dtype_key = ("uint8->float32" if not self.quant
                     else f"uint8->float32/w{self.quant}")
        key = (self.model_name, (bucket, height, *self.image_shape[1:]),
               mesh_key, dtype_key, variant, str(self.device))
        cap = getattr(self.model, "moe_capacity_factor", None)
        if self._moe and cap is not None:
            key = (*key, ("moe_capacity_factor", cap))
        return key

    def _execute(self, images: np.ndarray,
                 mask: np.ndarray | None) -> np.ndarray:
        """One padded cell on this rank through the cell cache: a miss
        runs it as the cell's first run (measured, under the cache's
        lock), a hit runs it plainly."""
        cell = (images.shape[0], images.shape[1],
                "dense" if mask is None else "masked")
        t0 = time.monotonic()
        box = []
        self.cache.get(self._key(*cell), lambda: WarmCell.measure(
            lambda: box.append(self._forward(images, mask)), self.device))
        out = box[0] if box else self._forward(images, mask)
        dt = time.monotonic() - t0
        self.cache.record_execute(dt)
        with self._lock:
            self._runs[cell] = self._runs.get(cell, 0) + 1
            self._execute_secs += dt
        return out

    def _forward(self, images: np.ndarray,
                 mask: np.ndarray | None) -> np.ndarray:
        """One padded cell on this rank (its data slice of the rows on a
        mesh). The execute clock stops on the `.cpu()` of the logits (and
        an MoE model's drop fraction, in the same copy), which waits for
        the device."""
        rows, rows_mask = images, mask
        if self._data > 1:
            per = images.shape[0] // self._data
            mine = slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)
            rows = images[mine]
            rows_mask = None if mask is None else mask[mine]
        x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint8))
        with torch.inference_mode(), activate(self.mesh):
            x = normalize_images(x.to(self.device))
            params = self._forward_params()
            if rows_mask is None:
                logits, state = self.model.apply(params, self.model_state, x)
            else:
                m = torch.from_numpy(np.ascontiguousarray(rows_mask)).to(
                    self.device)
                logits, state = self.model.apply(
                    params, self.model_state, x, mask=m)
            del params
            cols = [logits]
            if self._moe:
                drop = state["moe_drop_fraction_metric"].to(logits.dtype)
                cols.append(drop.reshape(1, 1).expand(logits.shape[0], 1))
            table = torch.cat(cols, dim=1)
            if self._data > 1:
                table = all_gather_flat(table.reshape(-1), self.mesh,
                                        DATA_AXIS).reshape(
                    images.shape[0], -1)
            flat = table.cpu().numpy()
        out = flat[:, :logits.shape[1]]
        if self._moe:
            # the mean of the data ranks' drop fractions
            self.last_moe_drop_fraction = float(
                np.mean(flat[::flat.shape[0] // self._data, -1]))
        return out

    def _forward_params(self):
        """The params a forward takes: FSDP slices gathered over
        ``data`` (the TP slices stay this rank's)."""
        if self.specs is None or self._data == 1:
            return self.params
        return gather_tree(self.params, self.specs.params, self.mesh,
                           axes=(DATA_AXIS,))

    # -- the follower protocol (a mesh of ranks) -----------------------------

    def _broadcast(self, msg=None):
        """The chief's `msg` on every rank (the host group: the images
        and mask are host arrays)."""
        from dist_mnist_tpu_torch.cluster import coordination

        box = [msg]
        torch.distributed.broadcast_object_list(
            box, src=0, group=coordination.context().host_group)
        return box[0]

    def follow(self) -> int:
        """Follower: run the chief's cells on this rank's shards until the
        chief's `close`; returns the cells run. An error propagates: this
        rank's exit fails the chief's next collective."""
        if not self.is_follower:
            raise RuntimeError("follow() runs on a rank of a sharded engine "
                               "other than the chief")
        calls = 0
        while True:
            op, *args = self._broadcast()
            if op == "stop":
                return calls
            if op == "swap":
                params, model_state, version = args
                self._commit_weights(
                    *self._stage_weights(params, model_state), version)
                continue
            if op != "run":
                raise RuntimeError(f"unknown follower call {op!r}")
            self._execute(*args)
            calls += 1

    def close(self) -> None:
        """Chief of a sharded engine: send the followers the stop message.
        No-op otherwise; idempotent."""
        if self.mesh is None or self.is_follower:
            return
        with self._chief:
            if self._closed:
                return
            self._closed = True
            self._broadcast(("stop",))

    def _warm(self, bucket: int, height: int | None) -> int:
        """Touch cell (bucket, height) in the cache: run it once on zero
        images unless the cache holds it (then a memory hit, nothing runs).
        `height=None` the dense native cell, else the masked one with every
        token real. Returns 1 when it ran as a miss."""
        h = self.image_shape[0] if height is None else height
        if self.cache.touch(
                self._key(bucket, h, "dense" if height is None else "masked")):
            return 0
        mask = None
        if height is not None:
            mask = np.ones((bucket, self.seq_grid.n_tokens(h)), dtype=bool)
        self._run(np.zeros((bucket, h, *self.image_shape[1:]), np.uint8),
                  mask)
        return 1

    def prewarm(self, buckets: list[int] | None = None,
                heights: list[int] | None = None) -> int:
        """Run each cell of the (batch, height) grid that the cache does
        not hold once (all of it by default) so live traffic never pays a
        first-run cost: per batch bucket the dense native cell, then —
        variable-length engines — the masked cell per height, the masked
        native-shaped one included. A cell the cache holds is a memory hit
        (a rewarm after a swap, a replica on a shared cache). Returns how
        many ran. Under a memory budget this REFUSES
        (`ServeMemoryBudgetError`) a grid whose cells evicted each other
        while warming: a grid that cannot stay resident would turn live
        requests into first runs."""
        ev0 = self.cache.evictions
        variable = self.seq_grid is not None and not self.seq_grid.native_only
        if heights is None:
            heights = list(self.seq_grid.heights) if variable else []
        n = 0
        for b in buckets if buckets is not None else self.buckets():
            bb = self.bucket_for(b)
            n += self._warm(bb, None)
            for h in heights:
                n += self._warm(bb, self.seq_bucket_for(h))
        if self.cache.evictions > ev0:
            raise ServeMemoryBudgetError(
                f"prewarm grid does not fit the serve memory budget "
                f"({self.cache.budget_bytes} B): "
                f"{self.cache.evictions - ev0} eviction(s) during warmup — "
                "the grid would thrash under live traffic; shrink it or "
                "raise --serve_memory_budget_mb")
        return n

    def predict(self, images: np.ndarray,
                heights: np.ndarray | None = None) -> np.ndarray:
        """Logits for `images` [n, h, W, C]; pads to the (batch, height)
        cell, runs, unpads. `h` may be any servable height when the engine
        has a seq grid (the batcher groups requests by shape first);
        `heights` optionally carries each row's REAL height when rows were
        already padded to a common `h`."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[2:] != self.image_shape[1:]:
            raise ValueError(
                f"image shape {images.shape[1:]} != engine's {self.image_shape}"
            )
        n, h = images.shape[0], images.shape[1]
        bucket = self.bucket_for(n)
        h_bucket = self.seq_bucket_for(h)
        real_h = (np.full((n,), h) if heights is None
                  else np.asarray(heights))
        # the native cell runs the maskless program only when no row is
        # short; short rows rounded into the native bucket take the masked
        # native-shaped cell
        masked = h_bucket != self.image_shape[0] or bool(
            np.any(real_h < self.image_shape[0]))
        if masked and self.seq_grid is None:
            raise ValueError(
                "variable-length rows need a seq grid (serve/zoo.py)")
        images = images.astype(np.uint8)
        if h < h_bucket:
            pad = np.zeros((n, h_bucket - h, *self.image_shape[1:]),
                           dtype=np.uint8)
            images = np.concatenate([images, pad], axis=1)
        if n < bucket:
            pad = np.zeros((bucket - n, h_bucket, *self.image_shape[1:]),
                           dtype=np.uint8)
            images = np.concatenate([images, pad])
        mask = None
        if masked:
            mask = np.zeros((bucket, self.seq_grid.n_tokens(h_bucket)),
                            dtype=bool)
            mask[:n] = self.seq_grid.mask(real_h, h_bucket)
        with self._lock:
            self.seq_bucket_counts[h_bucket] = \
                self.seq_bucket_counts.get(h_bucket, 0) + 1
        return self._run(images, mask)[:n]

    @property
    def misses(self) -> int:
        """Cells run for the first time in this engine's cache so far (the
        reference's `engine.cache.misses`; a shared cache counts every
        replica's): a miss during traffic after a full prewarm is a
        first-run cost on the hot path."""
        return self.cache.misses

    def cache_stats(self) -> dict:
        """Per-cell first runs (misses) and later runs (hits), the runs per
        batch bucket, and the host-clock seconds of every run, prewarm
        included. A seq-grid engine also reports the runs per cell,
        ``"<bucket>x<height>/<dense|masked>"``."""
        with self._lock:
            runs = dict(self._runs)
            execute_secs = self._execute_secs
        per_bucket: dict[int, int] = {}
        for (b, _, _), r in runs.items():
            per_bucket[b] = per_bucket.get(b, 0) + r
        out = {
            "hits": sum(runs.values()) - len(runs),
            "misses": len(runs),
            "per_bucket": {str(b): per_bucket[b] for b in sorted(per_bucket)},
            "execute_secs": execute_secs,
            "execute_count": sum(runs.values()),
        }
        if self.seq_grid is not None:
            out["per_cell"] = self.runs_per_cell()
        return out

    def runs_per_cell(self) -> dict:
        """Runs per cell, ``"<bucket>x<height>/<dense|masked>"``, prewarm
        included (on a follower: the chief's cells it ran)."""
        with self._lock:
            runs = dict(self._runs)
        return {f"{b}x{h}/{v}": runs[(b, h, v)] for b, h, v in sorted(runs)}
