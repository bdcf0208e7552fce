"""ctypes bindings for the C++ parameter server (port of the reference
`parallel/ps_demo/bindings.py`; ps_server.cc is a byte copy of the
reference's).

The library is built on demand with g++ into `build/torch_native/`
(`utils/native_build.py`), named by a digest of its source. All
blocking entry points (token dequeue, chief take_grad) release the GIL —
ctypes foreign calls always do — so Python threads act as genuinely
concurrent PS clients, like the reference's per-worker processes.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path

import numpy as np

from dist_mnist_tpu_torch.utils.native_build import build_shared_lib, load_lib

log = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "ps_server.cc"


def build_library(force: bool = False) -> Path:
    """Compile ps_server.cc (cached by the source's digest); the
    library's path."""
    return build_shared_lib(_SRC, force=force)


def _signatures():
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    return {
        "ps_create": ([ctypes.POINTER(i64), ctypes.c_int, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double, ctypes.c_double,
                       ctypes.c_int, i64], ctypes.c_void_p),
        "ps_destroy": ([ctypes.c_void_p], None),
        "ps_total_size": ([ctypes.c_void_p], i64),
        "ps_init": ([ctypes.c_void_p, f32p], None),
        "ps_pull": ([ctypes.c_void_p, f32p], i64),
        "ps_push_async": ([ctypes.c_void_p, f32p, i64], ctypes.c_int),
        "ps_push_sync": ([ctypes.c_void_p, f32p, i64], ctypes.c_int),
        "ps_chief_sync_once": ([ctypes.c_void_p, ctypes.c_int], i64),
        "ps_dequeue_token": ([ctypes.c_void_p], i64),
        "ps_step": ([ctypes.c_void_p], i64),
        "ps_dropped": ([ctypes.c_void_p], i64),
        "ps_close": ([ctypes.c_void_p], None),
    }


def _get_lib():
    return load_lib(_SRC, _signatures())


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ParameterServer:
    """Python handle over the native PS. Parameters travel as ONE flat f32
    vector (the wire format — like RecvTensor moved whole tensors)."""

    def __init__(self, sizes, *, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 replicas_to_aggregate=0, staleness_bound=-1):
        lib = _get_lib()
        arr = (ctypes.c_int64 * len(sizes))(*sizes)
        self._h = lib.ps_create(arr, len(sizes), lr, b1, b2, eps,
                                replicas_to_aggregate, staleness_bound)
        self._lib = lib
        self.total = int(lib.ps_total_size(self._h))
        self.sizes = list(sizes)

    def init(self, flat: np.ndarray) -> None:
        flat = np.ascontiguousarray(flat, np.float32)
        assert flat.size == self.total
        self._lib.ps_init(self._h, _fptr(flat))

    def pull(self) -> tuple[np.ndarray, int]:
        out = np.empty(self.total, np.float32)
        step = self._lib.ps_pull(self._h, _fptr(out))
        return out, int(step)

    def push_async(self, grads: np.ndarray, local_step: int) -> bool:
        grads = np.ascontiguousarray(grads, np.float32)
        return bool(self._lib.ps_push_async(self._h, _fptr(grads), local_step))

    def push_sync(self, grads: np.ndarray, local_step: int) -> bool:
        grads = np.ascontiguousarray(grads, np.float32)
        rc = self._lib.ps_push_sync(self._h, _fptr(grads), local_step)
        if rc < 0:
            raise RuntimeError(
                "push_sync on a PS created without replicas_to_aggregate "
                "(async mode has no accumulator)"
            )
        return bool(rc)

    def chief_sync_once(self, tokens_per_step: int) -> int:
        return int(self._lib.ps_chief_sync_once(self._h, tokens_per_step))

    def dequeue_token(self) -> int:
        return int(self._lib.ps_dequeue_token(self._h))

    @property
    def step(self) -> int:
        return int(self._lib.ps_step(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.ps_dropped(self._h))

    def close(self) -> None:
        self._lib.ps_close(self._h)

    def __del__(self):
        try:
            self._lib.ps_destroy(self._h)
        except Exception:
            pass
