"""The store of built kernel libraries, and the switch that points the
builders at it (the port's counterpart of the reference
`compilecache/store.py`).

An eager PyTorch step compiles nothing; the port's compiled programs are
its shared libraries: `nvcc`'s output of `csrc/<name>.cu`
(`ops/kernels/build.py`) and `g++`'s of the native `.cc` sources
(`utils/native_build.py`). Without a store they build into the
checkout's `build/` and are reused there. `enable_persistent_cache(dir)`
sends them through two `ExecutableStore`s instead, ``<dir>/kernels`` and
``<dir>/native``, keyed by `cache_key` over the source's digest, the
flags and everything that makes a library another one: torch's version,
its CUDA version, the card's compute capability and the compiler's
version line.

The store is dumb durable storage, as the reference's is: one file per
key, written under a temp name and moved into place with `os.replace`,
so a reader sees the old entry or the new one, never a torn write. Every
read that fails is a MISS: a missing entry, a truncated or foreign file,
a digest that does not match, or a `dlopen` that raises `OSError`. A bad
entry is quarantined (renamed to ``*.corrupt``), the caller rebuilds and
overwrites it, and each outcome is a ``compile_cache`` journal event with
the reference's outcome names (``miss``, ``corrupt``, ``hit``,
``save``). A failed save is logged and the run goes on uncached; a failed
BUILD still raises with the compiler's output.

Entry format, ``<key>.so``: the library's bytes, then a trailer: the
metadata as JSON (the library's length and sha256, the build ms, torch's
version), its length as 8 little-endian bytes, and `MAGIC`. The dynamic
loader maps the library's segments and never reads the trailer, so the
entry itself is what `dlopen` opens; a read checks the trailer and the
digest first, so a truncated or foreign file never reaches `dlopen`.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

from dist_mnist_tpu_torch.obs import events

log = logging.getLogger(__name__)

#: suffix of store entries (one library each)
ENTRY_SUFFIX = ".so"
#: suffix a quarantined entry is renamed to
CORRUPT_SUFFIX = ".corrupt"
#: prefix of in-flight temp files (builds and atomic writes)
TMP_PREFIX = ".tmp-"
#: the trailer's last bytes
MAGIC = b"DMTLIB01"
#: temp files being written now, for the test suite's leak check: a
#: non-empty set after a test means some path skipped its cleanup
_PENDING_TMP: set = set()


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """The first line of ``<compiler> --version`` (read once per process
    and compiler), or ``"unavailable"`` when it does not run."""
    try:
        out = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    # nvcc prints a banner first; its release line is the one that says
    return next((ln for ln in lines if "release" in ln),
                lines[0] if lines else "unavailable")


def _runtime_identity() -> dict:
    import torch

    capability = None
    if torch.cuda.is_available():
        capability = list(torch.cuda.get_device_capability())
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "capability": capability}


def cache_key(fields: dict, *, compiler: str | None = None) -> str:
    """Stable hex key over `fields` and the runtime's identity.

    `fields` names the library (its source's digest, the flags). torch's
    version, its CUDA version and the card's compute capability are
    merged in, and with `compiler` that compiler's version line, so a
    library built by another toolchain never loads; a field of `fields`
    with one of those names overrides it (tests pin invalidation so)."""
    full = {**_runtime_identity(),
            "compiler": (compiler_version(compiler) if compiler else None),
            **fields}
    blob = json.dumps(full, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _read_entry(data: bytes) -> tuple[bytes, dict]:
    """(library bytes, metadata) of an entry's bytes; ValueError when the
    trailer or the digest is wrong."""
    if len(data) < 16 or data[-8:] != MAGIC:
        raise ValueError("no store trailer (truncated or foreign file)")
    n_meta = int.from_bytes(data[-16:-8], "little")
    if n_meta > len(data) - 16:
        raise ValueError("trailer length past the file's start")
    lib = data[:len(data) - 16 - n_meta]
    meta = json.loads(data[len(lib):len(data) - 16])
    if meta.get("bytes") != len(lib) \
            or meta.get("sha256") != hashlib.sha256(lib).hexdigest():
        raise ValueError("library digest does not match its trailer")
    return lib, meta


class ExecutableStore:
    """key -> built library on disk, with hit/miss/corrupt/build counters
    and the build ms each hit saved (module docstring).

    Thread-safe; failure-soft on both sides: `get` returns None on any
    problem (the caller builds and `put` overwrites), `put` logs and
    returns None instead of raising."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._stats = {
            "hits": 0,
            "misses": 0,
            # entries quarantined: truncated, foreign, bad digest, or a
            # dlopen that raised
            "corrupt": 0,
            "builds": 0,
            # the build wall ms the misses paid
            "build_ms": 0.0,
            "bytes_read": 0,
            "bytes_written": 0,
            "load_ms": 0.0,
            "save_ms": 0.0,
            # build ms the hits avoided, as recorded by whoever saved the
            # entry (its metadata's build_ms)
            "compile_ms_saved": 0.0,
        }

    def path(self, key: str) -> Path:
        return self.dir / f"{key}{ENTRY_SUFFIX}"

    def scratch(self, key: str, tag: str = "build") -> Path:
        """A temp path in the store's directory for a build's output,
        registered for the leak check until `release`."""
        tmp = self.dir / (f"{TMP_PREFIX}{tag}-{key}-{os.getpid()}-"
                          f"{threading.get_ident()}{ENTRY_SUFFIX}")
        _PENDING_TMP.add(tmp)
        return tmp

    @staticmethod
    def release(tmp: Path) -> None:
        """Remove a `scratch` file (it may be open: a mapped library
        outlives its name)."""
        tmp.unlink(missing_ok=True)
        _PENDING_TMP.discard(tmp)

    def _count(self, **delta) -> None:
        with self._lock:
            for k, v in delta.items():
                self._stats[k] += v

    def get(self, key: str) -> Path | None:
        """The entry's path when it holds a whole library (its trailer and
        digest checked), else None: a missing entry is a miss, a bad one
        is quarantined first."""
        path = self.path(key)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as fh:
                inode = os.fstat(fh.fileno()).st_ino
                data = fh.read()
        except OSError:
            self._count(misses=1)
            events.emit("compile_cache", outcome="miss", key=key)
            return None
        try:
            _, meta = _read_entry(data)
        except ValueError as err:
            self.quarantine(key, str(err), inode=inode)
            return None
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._count(hits=1, bytes_read=len(data), load_ms=dt_ms,
                    compile_ms_saved=float(meta.get("build_ms", 0.0)))
        events.emit("compile_cache", outcome="hit", key=key,
                    load_ms=round(dt_ms, 3))
        return path

    def quarantine(self, key: str, reason: str, *,
                   inode: int | None = None) -> None:
        """Rename the entry to ``*.corrupt`` and count a corrupt miss.
        Another process may have replaced the entry since it was judged:
        the rename happens only while the file is still the one judged
        (`inode`)."""
        path = self.path(key)
        log.warning("compile-cache entry %s unusable (%s); quarantined, "
                    "rebuilding", path.name, reason)
        try:
            if inode is None or os.stat(path).st_ino == inode:
                os.replace(path, path.with_name(path.name + CORRUPT_SUFFIX))
        except OSError:
            pass
        self._count(corrupt=1, misses=1)
        events.emit("compile_cache", outcome="corrupt", key=key,
                    reason=reason)

    def note_build(self, build_ms: float) -> None:
        """Count one build of `build_ms` wall ms (a miss's price)."""
        self._count(builds=1, build_ms=float(build_ms))

    def put(self, key: str, library: Path, meta: dict | None = None
            ) -> Path | None:
        """Write the built `library` under `key` (atomic replace); the
        entry's path, or None when the write failed."""
        import torch

        t0 = time.perf_counter()
        tmp = self.scratch(key, "put")
        try:
            lib = Path(library).read_bytes()
            trailer = json.dumps({
                "bytes": len(lib),
                "sha256": hashlib.sha256(lib).hexdigest(),
                "torch_version": torch.__version__,
                **(meta or {})}, sort_keys=True).encode()
            blob = lib + trailer + len(trailer).to_bytes(8, "little") + MAGIC
            tmp.write_bytes(blob)
            os.replace(tmp, self.path(key))
        except Exception as e:  # noqa: BLE001 — warm-start aid, never fatal
            log.warning("compile-cache save %s failed (%s: %s); continuing "
                        "uncached", key, type(e).__name__, e)
            return None
        finally:
            self.release(tmp)
        self._count(bytes_written=len(blob),
                    save_ms=(time.perf_counter() - t0) * 1e3)
        events.emit("compile_cache", outcome="save", key=key,
                    bytes=len(blob))
        return self.path(key)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["entries"] = sum(
            1 for p in self.dir.glob(f"*{ENTRY_SUFFIX}")
            if not p.name.startswith(TMP_PREFIX))
        return out


def open_library(store: ExecutableStore, key: str, build, opener, *,
                 force: bool = False):
    """``(handle, path)``: `opener` (e.g. `ctypes.CDLL`) on the store's
    entry for `key`, built first on a miss. `build(out)` compiles into
    `out` and raises with the compiler's output on failure. A `dlopen`
    that raises `OSError` on a whole-looking entry quarantines it and
    builds again; `force` builds without reading the entry."""
    path = None if force else store.get(key)
    if path is not None:
        try:
            inode = os.stat(path).st_ino
            return opener(str(path)), path
        except OSError as err:
            store.quarantine(key, f"dlopen: {err}", inode=inode)
    tmp = store.scratch(key)
    try:
        t0 = time.perf_counter()
        build(tmp)
        build_ms = (time.perf_counter() - t0) * 1e3
        store.note_build(build_ms)
        entry = store.put(key, tmp, {"build_ms": build_ms})
        target = entry if entry is not None else tmp
        return opener(str(target)), target
    finally:
        store.release(tmp)


class PersistentCache:
    """The two stores `enable_persistent_cache` installs: the CUDA
    kernels' (``<root>/kernels``) and the native libraries'
    (``<root>/native``)."""

    def __init__(self, root):
        self.root = Path(root)
        self.kernels = ExecutableStore(self.root / "kernels")
        self.native = ExecutableStore(self.root / "native")

    def stats(self) -> dict:
        """Both stores' counters summed."""
        a, b = self.kernels.stats(), self.native.stats()
        return {k: a[k] + b[k] for k in a}


_ACTIVE: PersistentCache | None = None


def active() -> PersistentCache | None:
    """The cache the builders go through, or None (the checkout's
    `build/`)."""
    return _ACTIVE


def set_active(cache: PersistentCache | None) -> PersistentCache | None:
    """Install `cache` (None: back to `build/`); returns the previous."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, cache
    return prev


@contextlib.contextmanager
def persistent_cache(directory):
    """`enable_persistent_cache(directory)` for the block (no store when
    `directory` is None), the previous setting restored after; yields
    the cache or None."""
    prev = active()
    try:
        yield enable_persistent_cache(directory) if directory else None
    finally:
        set_active(prev)


def enable_persistent_cache(directory) -> PersistentCache:
    """Point `ops/kernels/build.py` at ``<directory>/kernels`` and
    `utils/native_build.py` at ``<directory>/native`` (the counterpart of
    the XLA persistent cache: every library this process builds or loads
    from then on goes through the stores). Returns the installed cache."""
    cache = PersistentCache(directory)
    set_active(cache)
    return cache
