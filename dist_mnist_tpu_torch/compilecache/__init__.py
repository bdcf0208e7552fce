"""Warm-start engine: durable built libraries + startup attribution (port
of the reference `compilecache/`).

- `enable_persistent_cache` points the kernel builders
  (`ops/kernels/build.py`, `utils/native_build.py`) at two
  `ExecutableStore`s under one directory: what a cold process builds with
  `nvcc` or `g++`, a warm one loads, and a corrupt entry is quarantined
  and rebuilt, never a crash (`compilecache/store.py`).
- `StartupClock` / `StartupHook` attribute process wall time to import,
  init, restore, compile (the builds or the store loads) and the first
  step, published as `startup/*` and `compile_cache/*` metrics, so
  `bench --coldstart` and the supervisor's restart generations show where
  cold-start time went and what a warm start saved.

`compile_cache_key_fields` (`key_fields.py`) is the reference's key
builder, copied.
"""

from dist_mnist_tpu_torch.compilecache.store import (
    ExecutableStore,
    cache_key,
    enable_persistent_cache,
)
from dist_mnist_tpu_torch.compilecache.startup import StartupClock, StartupHook

__all__ = [
    "ExecutableStore",
    "StartupClock",
    "StartupHook",
    "cache_key",
    "enable_persistent_cache",
]
