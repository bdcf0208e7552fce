"""The inference engine: power-of-two batch buckets over one device (port
of the reference `serve/engine.py InferenceEngine`).

Why buckets: a continuous batcher produces a different batch size every
tick. Rounding up to a power of two caps the distinct shapes the device
sees at log2(max_batch)+1 while wasting at most 2x compute on padding —
and padding rows are sliced off before any result leaves the engine.

There is no XLA compile cache to port: PyTorch runs eagerly. What the
reference's AOT cache did for a first request — move the one-time cost
out of live traffic — `prewarm()` does here by running every bucket once
(building the CUDA kernels and initializing the cuBLAS/cuDNN handles).
`cache_stats()` counts, per bucket, that first run as a miss and every
later run as a hit, so the serve summary keeps the reference's shape,
and sums the runs' host-clock seconds as the reference's `execute_secs`.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from dist_mnist_tpu_torch.ops.quant import (
    QuantizedArray,
    is_quantized,
    quantize_tree,
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

    `predict(images)` takes a host batch of raw uint8 images `[n, H, W, C]`
    and returns f32 logits `[n, classes]`; padding, placement and
    unpadding are internal. Normalization is the reference's (`x/255`).
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
        quant: str | None = None,
        quant_report: dict | None = None,
    ):
        self.model = model
        self.device = resolve_device(device)
        self.image_shape = tuple(image_shape)
        # weight-only quantized serving (ops/quant.py): an already-
        # quantized tree tags the engine; quant="int8" quantizes a float one
        if quant is None and is_quantized(params):
            quant = "int8"
        if quant is not None and quant != "int8":
            raise ValueError(f"unsupported quant mode {quant!r} "
                             "(supported: 'int8')")
        if quant and not is_quantized(params):
            params = quantize_tree(params)
        self.quant = quant
        self.quant_report = quant_report
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.model_state = tree_map(lambda t: t.to(self.device), model_state)
        self.max_bucket = max(max_bucket, 1)
        self._lock = threading.Lock()
        self._runs: dict[int, int] = {}  # bucket -> executed batches
        self._execute_secs = 0.0

    def state_bytes_per_device(self) -> dict:
        """Resident bytes of the SERVED weights (int8 leaves at 1 byte per
        element plus their f32 scales)."""
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
        b = _pow2_at_least(n)
        if b > self.max_bucket:
            raise ValueError(
                f"batch {n} needs bucket {b} > max_bucket {self.max_bucket}; "
                "raise max_bucket or split the batch upstream"
            )
        return b

    def buckets(self) -> list[int]:
        """Every batch bucket this engine can execute, smallest first."""
        out, b = [], 1
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return out

    # -- execution -----------------------------------------------------------
    def _run(self, images: np.ndarray) -> np.ndarray:
        """One padded bucket through the model. The execute clock stops on
        the `.cpu()` of the logits, which waits for the device."""
        t0 = time.monotonic()
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8))
        with torch.inference_mode():
            x = x.to(self.device).to(torch.float32) / 255.0
            logits, _ = self.model.apply(self.params, self.model_state, x)
            out = logits.cpu().numpy()
        dt = time.monotonic() - t0
        with self._lock:
            self._runs[len(images)] = self._runs.get(len(images), 0) + 1
            self._execute_secs += dt
        return out

    def prewarm(self, buckets: list[int] | None = None) -> int:
        """Run each not-yet-run bucket once (all of them by default) so
        live traffic never pays a first-run cost. Returns how many ran."""
        n = 0
        for b in buckets if buckets is not None else self.buckets():
            bb = self.bucket_for(b)
            if bb not in self._runs:
                self._run(np.zeros((bb, *self.image_shape), np.uint8))
                n += 1
        return n

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Logits for `images` [n, H, W, C]; pads to the bucket, runs,
        unpads."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[1:] != self.image_shape:
            raise ValueError(
                f"image shape {images.shape[1:]} != engine's {self.image_shape}"
            )
        n = images.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *self.image_shape), dtype=np.uint8)
            images = np.concatenate([images.astype(np.uint8), pad])
        return self._run(images)[:n]

    def cache_stats(self) -> dict:
        """Per-bucket first runs (misses) and later runs (hits), and the
        host-clock seconds of every run, prewarm included."""
        with self._lock:
            runs = dict(self._runs)
            execute_secs = self._execute_secs
        return {
            "hits": sum(runs.values()) - len(runs),
            "misses": len(runs),
            "per_bucket": {str(b): runs[b] for b in sorted(runs)},
            "execute_secs": execute_secs,
            "execute_count": sum(runs.values()),
        }
