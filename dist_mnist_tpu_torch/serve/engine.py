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

There is no XLA compile cache to port: PyTorch runs eagerly. What the
reference's AOT cache did for a first request — move the one-time cost
out of live traffic — `prewarm()` does here by running every cell once
(building the CUDA kernels and initializing the cuBLAS/cuDNN handles).
`cache_stats()` counts, per cell, that first run as a miss and every
later run as a hit, so the serve summary keeps the reference's shape,
and sums the runs' host-clock seconds as the reference's `execute_secs`.
A cell's first run is journaled as the reference's fresh compile
(``compile_cache`` with ``outcome="compile"`` and its ``compile_ms``);
the cell cache holds no memory budget, so it never evicts (the serve
memory budget joins with ROADMAP §1 item 15).

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
protocol, `serve/decode.py`). The data ranks' logits are all-gathered,
and the chief returns them.
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
from dist_mnist_tpu_torch.utils.tree import leaves, tree_map

log = logging.getLogger(__name__)


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
    ):
        """`mesh` (several ranks): serve sharded by `rules` (default DP).
        `params` and `model_state` are then this rank's shards as `specs`
        (a `parallel.sharding.StateSpecs`: `serve/loader.py` restores and
        shards them), or, without `specs`, full leaves this engine
        shards."""
        self.model = model
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
        # (batch bucket, height bucket, "dense" | "masked") -> batches run
        self._runs: dict[tuple[int, int, str], int] = {}
        self._execute_secs = 0.0
        #: batches `predict` ran per height bucket (the benches' routing
        #: counts; prewarm's runs are not traffic)
        self.seq_bucket_counts: dict[int, int] = {}
        # an MoE model returns its routed drop fraction beside the logits
        # (never silent truncation); the last batch's is kept here for the
        # batcher to record
        self._moe = (isinstance(model_state, dict)
                     and "moe_drop_fraction_metric" in model_state)
        self.last_moe_drop_fraction: float | None = None
        self._closed = False

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
        if self.mesh is not None:
            if self.is_follower:
                raise RuntimeError("a follower engine runs only the chief's "
                                   "cells (follow)")
            self._broadcast(("run", images, mask))
        return self._execute(images, mask)

    def _execute(self, images: np.ndarray,
                 mask: np.ndarray | None) -> np.ndarray:
        """One padded cell on this rank (its data slice of the rows on a
        mesh). The execute clock stops on the `.cpu()` of the logits (and
        an MoE model's drop fraction, in the same copy), which waits for
        the device."""
        t0 = time.monotonic()
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
        dt = time.monotonic() - t0
        cell = (images.shape[0], images.shape[1],
                "dense" if mask is None else "masked")
        with self._lock:
            first = cell not in self._runs
            self._runs[cell] = self._runs.get(cell, 0) + 1
            self._execute_secs += dt
        if first:
            events.emit("compile_cache", outcome="compile", key=str(cell),
                        compile_ms=round(dt * 1e3, 3))
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
            if op != "run":
                raise RuntimeError(f"unknown follower call {op!r}")
            self._execute(*args)
            calls += 1

    def close(self) -> None:
        """Chief of a sharded engine: send the followers the stop message.
        No-op otherwise; idempotent."""
        if self.mesh is None or self.is_follower or self._closed:
            return
        self._closed = True
        self._broadcast(("stop",))

    def _warm(self, bucket: int, height: int | None) -> int:
        """Run cell (bucket, height) once on zero images if it never ran:
        `height=None` the dense native cell, else the masked one with every
        token real. Returns 1 when it ran."""
        h = self.image_shape[0] if height is None else height
        if (bucket, h, "dense" if height is None else "masked") in self._runs:
            return 0
        mask = None
        if height is not None:
            mask = np.ones((bucket, self.seq_grid.n_tokens(h)), dtype=bool)
        self._run(np.zeros((bucket, h, *self.image_shape[1:]), np.uint8),
                  mask)
        return 1

    def prewarm(self, buckets: list[int] | None = None,
                heights: list[int] | None = None) -> int:
        """Run each not-yet-run cell of the (batch, height) grid once (all
        of it by default) so live traffic never pays a first-run cost:
        per batch bucket the dense native cell, then — variable-length
        engines — the masked cell per height, the masked native-shaped
        one included. Returns how many ran."""
        variable = self.seq_grid is not None and not self.seq_grid.native_only
        if heights is None:
            heights = list(self.seq_grid.heights) if variable else []
        n = 0
        for b in buckets if buckets is not None else self.buckets():
            bb = self.bucket_for(b)
            n += self._warm(bb, None)
            for h in heights:
                n += self._warm(bb, self.seq_bucket_for(h))
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
        """Cells run for the first time so far (the reference's
        `engine.cache.misses`): a miss during traffic after a full prewarm
        is a first-run cost on the hot path."""
        with self._lock:
            return len(self._runs)

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
