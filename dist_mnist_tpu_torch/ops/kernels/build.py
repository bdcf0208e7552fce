"""Build the CUDA sources under `csrc/` with `nvcc` and load them by ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
a build takes seconds) and compiles into its own shared library under
`build/torch_kernels/` of the checkout, for `sm_90a` (Hopper). The file
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused across processes; the hash also
covers the shared headers (`csrc/*.cuh`), which a source may include. `build_all`
starts one `nvcc` per source at once and waits for all of them.

With a persistent cache enabled (`compilecache.enable_persistent_cache`,
the CLIs' `--compile_cache_dir`) the libraries go through its kernels'
`ExecutableStore` instead, keyed by `cache_key` over the same digest and
nvcc's version line: a warm process loads what a cold one built, and a
truncated or foreign entry is quarantined and rebuilt. Without one the
paths and file names above stay as they are. Either way the seconds this
process spent building or loading libraries add up in a record the
training step drains (`consume_build_s`), which the loop charges to its
goodput compile bucket.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.RLock()
_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc's output (incl. ptxas register/smem usage) per source built by
#: this process
build_logs: dict[str, str] = {}
#: seconds this process spent building or loading libraries, not yet
#: drained by `consume_build_s`
_spent_s = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                       "kernels build from source on the machine with the card")


def _digest(name: str) -> str:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)[:12]}.so"


def _store():
    """The enabled cache's kernels store, or None."""
    from dist_mnist_tpu_torch.compilecache import store

    cache = store.active()
    return None if cache is None else cache.kernels


def store_key(name: str) -> str:
    """`csrc/<name>.cu`'s key in a store: its digest (the source, the
    shared headers, the flags) and nvcc's version line."""
    from dist_mnist_tpu_torch.compilecache.store import cache_key

    return cache_key({"kind": "cuda_kernel", "name": name,
                      "digest": _digest(name)}, compiler=_nvcc())


def _compile(jobs: dict[str, Path]) -> None:
    """`nvcc` each ``{name: output}``, all started together; raises with
    the compiler's output on a failed build."""
    procs = {}
    for name, out in jobs.items():
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    failed = []
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            out.unlink(missing_ok=True)
            failed.append(f"{name}.cu (rc={proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all(names) -> dict[str, Path]:
    """Compile every missing library, one `nvcc` per source, all started
    together; their paths. Raises with the compiler's output on a failed
    build. With a store enabled, each library is loaded or built through
    it instead (one at a time), and its paths are the store's."""
    store = _store()
    if store is not None:
        with _lock:
            for name in names:
                _load_locked(name)
        return {n: store.path(store_key(n)) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    tmps = {n: out.with_name(f"{out.name}.{os.getpid()}.tmp")
            for n, out in paths.items() if not out.exists()}
    _compile(tmps)
    for name, tmp in tmps.items():
        os.replace(tmp, paths[name])  # atomic: a concurrent process sees all or none
    return paths


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    global _spent_s
    t0 = time.perf_counter()
    store = _store()
    if store is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
    else:
        from dist_mnist_tpu_torch.compilecache.store import open_library

        lib, _ = open_library(store, store_key(name),
                              lambda out: _compile({name: out}), ctypes.CDLL)
    _loaded[name] = lib
    _spent_s += time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        return _load_locked(name)


def consume_build_s() -> float:
    """The seconds spent building or loading libraries since the last
    call (and reset): what a training step that loaded them charges to
    the goodput compile bucket."""
    global _spent_s
    with _lock:
        spent, _spent_s = _spent_s, 0.0
    return spent
