"""IDX file codec — the MNIST on-disk format (a copy of the reference's
`data/idx.py`, which imports no JAX).

The original trainer consumed this format through
`input_data.read_data_sets(FLAGS.data_dir, one_hot=True)` (SURVEY.md §0.1
step 1; the module is removed from TF 2.x). This is a clean-room codec for
the same files: magic = two zero bytes, a dtype code, a rank byte, then
big-endian uint32 dims, then row-major data. Transparent .gz support because
the canonical distribution ships gzipped.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES: dict[int, np.dtype] = {
    0x08: np.dtype(">u1"),
    0x09: np.dtype(">i1"),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
_CODES = {v.newbyteorder("="): k for k, v in _DTYPES.items()}


def _open(path: str | Path, mode: str):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def read_idx(path: str | Path) -> np.ndarray:
    """Parse one IDX file (optionally .gz) into a native-endian ndarray."""
    with _open(path, "rb") as f:
        header = f.read(4)
        if len(header) != 4 or header[0] != 0 or header[1] != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic {header!r})")
        code, ndim = header[2], header[3]
        if code not in _DTYPES:
            raise ValueError(f"{path}: unknown IDX dtype code 0x{code:02x}")
        dims_raw = f.read(4 * ndim)
        if len(dims_raw) != 4 * ndim:
            raise ValueError(f"{path}: truncated IDX header")
        dims = struct.unpack(f">{ndim}I", dims_raw)
        dtype = _DTYPES[code]
        count = int(np.prod(dims, dtype=np.int64)) if ndim else 1
        raw = f.read(count * dtype.itemsize)
        if len(raw) != count * dtype.itemsize:
            raise ValueError(
                f"{path}: truncated payload ({len(raw)} bytes, "
                f"expected {count * dtype.itemsize})"
            )
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
        return arr.astype(dtype.newbyteorder("="))


def write_idx(path: str | Path, arr: np.ndarray) -> None:
    """Write an ndarray as IDX (gzipped when path ends in .gz)."""
    arr = np.ascontiguousarray(arr)
    key = np.dtype(arr.dtype).newbyteorder("=")
    if key not in _CODES:
        raise ValueError(f"dtype {arr.dtype} not representable in IDX")
    if arr.ndim > 255:
        raise ValueError("IDX rank limit is 255")
    with _open(path, "wb") as f:
        f.write(bytes([0, 0, _CODES[key], arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(_DTYPES[_CODES[key]]).tobytes())
