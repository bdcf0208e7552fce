"""ctypes wrapper over the native prefetching loader (port of the
reference `data/native/batcher.py`)."""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path

import numpy as np
import torch

from dist_mnist_tpu_torch.utils.native_build import build_shared_lib, load_lib

log = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "loader.cc"


def build_library(force: bool = False) -> Path:
    """Compile loader.cc (`utils/native_build.py`); the library's path."""
    return build_shared_lib(_SRC, force=force)


def _get_lib():
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    return load_lib(_SRC, {
        "loader_create": ([u8p, i32p, i64, i64, i64, ctypes.c_uint64,
                           ctypes.c_int, i64, i64, i64], ctypes.c_void_p),
        "loader_next": ([ctypes.c_void_p, u8p, i32p], i64),
        "loader_close": ([ctypes.c_void_p], None),
        "loader_destroy": ([ctypes.c_void_p], None),
    })


class NativeBatcher:
    """Deterministic shuffled epochs, assembled and prefetched in C++.

    Every rank sees the same permutation (the library's seeded shuffle)
    and takes its slice of each global batch: the rows ``[d * local, (d +
    1) * local)`` of it, ``d`` the rank's DATA coordinate
    (`cluster/mesh.local_batch_slice`), so the ranks of one model, seq or
    pipe group get the same rows. `host_batches()` yields the numpy rows
    (what `data/prefetch.DevicePrefetcher` pulls); iterating yields them on
    the mesh's device through a `DevicePrefetcher` of depth 1.
    """

    def __init__(self, dataset, global_batch: int, mesh, *, seed: int = 0,
                 prefetch_depth: int = 4, start_step: int = 0):
        from dist_mnist_tpu_torch.cluster.mesh import local_batch_slice

        self._ctor_args = (dataset, global_batch, mesh)
        self._ctor_kwargs = dict(seed=seed, prefetch_depth=prefetch_depth)
        n = dataset.train_images.shape[0]
        if global_batch > n:
            raise ValueError(f"global batch {global_batch} > dataset {n}")
        if mesh is None:
            self.local, data_index = global_batch, 0
            self.device = torch.device("cpu")
        else:
            self.local, _ = local_batch_slice(global_batch, mesh)
            data_index = mesh.rank
            self.device = mesh.device
        self.mesh = mesh
        # keep references so the C++ side's borrowed pointers stay alive
        self._images = np.ascontiguousarray(dataset.train_images)
        self._labels = np.ascontiguousarray(dataset.train_labels, np.int32)
        self._row_bytes = int(self._images[0].nbytes)
        self._img_shape = self._images.shape[1:]
        lib = _get_lib()
        self._lib = lib
        self._h = lib.loader_create(
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, self._row_bytes, global_batch, seed, prefetch_depth,
            data_index * self.local, self.local, start_step,
        )
        if not self._h:
            raise RuntimeError("loader_create failed (bad batch/depth)")

    def next_local(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(images uint8 [local, ...], labels int32 [local], step), on
        the host."""
        img = np.empty((self.local, *self._img_shape), np.uint8)
        lab = np.empty((self.local,), np.int32)
        step = self._lib.loader_next(
            self._h,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if step < 0:
            raise StopIteration
        return img, lab, int(step)

    def host_batches(self):
        """The host half of the stream: ``{"image", "label"}`` numpy
        dicts, the split `ShardedBatcher.host_batches` makes."""
        while True:
            try:
                img, lab, _ = self.next_local()
            except StopIteration:
                return
            yield {"image": img, "label": lab}

    def __iter__(self):
        from dist_mnist_tpu_torch.data.prefetch import DevicePrefetcher

        yield from DevicePrefetcher(self, depth=1)

    def at_step(self, step: int) -> "NativeBatcher":
        """A fresh batcher positioned at `step` (TrainLoop recovery
        re-seek); this one keeps streaming until closed or collected."""
        return NativeBatcher(*self._ctor_args, **self._ctor_kwargs,
                             start_step=step)

    def close(self):
        """End the stream: a waiting `next_local` returns."""
        if getattr(self, "_h", None):
            self._lib.loader_close(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.loader_destroy(self._h)
                self._h = None
        except Exception:
            pass
