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

A missing g++ raises: nothing falls back to a Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def library_path(src: Path) -> Path:
    """Where `src` builds: its stem and a digest of its bytes and the
    flags."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_shared_lib(src: Path, *, force: bool = False) -> Path:
    """Compile `src` with g++ unless its library exists (or `force`);
    the library's path."""
    out = library_path(src)
    with _lock:
        if out.exists() and not force:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        log.info("building native library: %s", " ".join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not available for native components") \
                from e
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed:\n{e.stderr}") from e
        os.replace(tmp, out)  # atomic across processes
        return out


def load_lib(src: Path, signatures: dict) -> ctypes.CDLL:
    """Build (if needed), load and type `src`'s library; cached per path.

    `signatures`: name -> (argtypes, restype)."""
    out = build_shared_lib(src)
    with _lock:
        lib = _loaded.get(out)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[out] = lib
        return lib
