"""Build and load the framework-free C++ components (port of the
reference `utils/native_build.py`): one g++ invocation (``-O2 -std=c++17
-shared -fPIC -pthread``) into a ctypes CDLL, used by `data/native` and
`parallel/ps_demo`.

Libraries go to `build/torch_native/` of the checkout, never beside their
source, each named by a digest of its source and the flags
(``lib<stem>-<digest>.so``), so an edited source rebuilds and an unchanged
one is reused across processes. A build writes a name of its own and
`os.replace`s it onto the final one, so the ranks `cli.launch` starts,
which all build at the same moment, each see a whole library or none.

With a persistent cache enabled (`compilecache.enable_persistent_cache`,
the CLIs' `--compile_cache_dir`) the libraries go through its native
`ExecutableStore` instead, keyed by `cache_key` over the same digest and
g++'s version line; a truncated or foreign entry is quarantined and
rebuilt. Either way the seconds spent building or loading add up in a
record the training step drains (`consume_build_s`).

A missing g++ raises: nothing falls back to a Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

log = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.RLock()
_loaded: dict[Path, ctypes.CDLL] = {}
#: seconds this process spent building or loading libraries, not yet
#: drained by `consume_build_s`
_spent_s = 0.0


def _digest(src: Path) -> str:
    return hashlib.sha256(Path(src).read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()


def library_path(src: Path) -> Path:
    """Where `src` builds: its stem and a digest of its bytes and the
    flags."""
    return BUILD_DIR / f"lib{Path(src).stem}-{_digest(src)[:12]}.so"


def _store():
    """The enabled cache's native store, or None."""
    from dist_mnist_tpu_torch.compilecache import store

    cache = store.active()
    return None if cache is None else cache.native


def store_key(src: Path) -> str:
    """`src`'s key in a store: its digest (bytes and flags) and g++'s
    version line."""
    from dist_mnist_tpu_torch.compilecache.store import cache_key

    return cache_key({"kind": "native", "stem": Path(src).stem,
                      "digest": _digest(src)}, compiler="g++")


def _compile(src: Path, out: Path) -> None:
    """g++ `src` into `out`; raises with the compiler's output."""
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(out)]
    log.info("building native library: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not available for native components") from e
    except subprocess.CalledProcessError as e:
        out.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed:\n{e.stderr}") from e


def _open(src: Path, *, force: bool = False) -> tuple[ctypes.CDLL | None,
                                                      Path]:
    """(handle or None, path) of `src`'s library: through the store when
    one is enabled (its handle opened there), else built into `build/`
    unless it exists (or `force`) and not opened."""
    store = _store()
    if store is not None:
        from dist_mnist_tpu_torch.compilecache.store import open_library

        return open_library(store, store_key(src),
                            lambda out: _compile(src, out), ctypes.CDLL,
                            force=force)
    out = library_path(src)
    if out.exists() and not force:
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    _compile(Path(src), tmp)
    os.replace(tmp, out)  # atomic across processes
    return None, out


def build_shared_lib(src: Path, *, force: bool = False) -> Path:
    """Compile `src` with g++ unless its library exists (or `force`);
    the library's path (the store's entry when a store is enabled)."""
    with _lock:
        return _open(src, force=force)[1]


def load_lib(src: Path, signatures: dict) -> ctypes.CDLL:
    """Build (if needed), load and type `src`'s library; cached per
    source.

    `signatures`: name -> (argtypes, restype)."""
    global _spent_s
    src = Path(src).resolve()
    with _lock:
        lib = _loaded.get(src)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        lib, out = _open(src)
        if lib is None:
            lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[src] = lib
        _spent_s += time.perf_counter() - t0
        return lib


def consume_build_s() -> float:
    """The seconds spent building or loading libraries since the last
    call (and reset)."""
    global _spent_s
    with _lock:
        spent, _spent_s = _spent_s, 0.0
    return spent
