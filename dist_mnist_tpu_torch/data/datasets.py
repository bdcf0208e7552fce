"""Named dataset registry: disk first, then the synthetic twin (port of
the reference `data/datasets.py`, pure numpy).

Given a data directory it loads the canonical 4-IDX-file layout (MNIST,
and Fashion-MNIST under a ``fashion_mnist.`` prefix), or CIFAR-10's
``cifar-10-batches-py`` (python pickles, also unpacked from
``cifar-10-python.tar.gz``); when the files are absent it synthesizes the
deterministic procedural twin (`data/synthetic.py`) and caches it there
in the reference's format (IDX, or ``cifar10_synth.npz``), with the same
``.<name>.synthetic-twin`` marker, so this package and the reference
share one directory. Nothing is downloaded. Labels stay integer; one-hot
happens in the loss.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import tarfile
import tempfile
from pathlib import Path

import numpy as np

from dist_mnist_tpu_torch.data import synthetic
from dist_mnist_tpu_torch.data.idx import read_idx, write_idx

log = logging.getLogger(__name__)

DATASETS = {
    "mnist": dict(image_shape=(28, 28, 1), num_classes=10),
    "fashion_mnist": dict(image_shape=(28, 28, 1), num_classes=10),
    "cifar10": dict(image_shape=(32, 32, 3), num_classes=10),
}

_MNIST_FILES = {
    "train_x": "train-images-idx3-ubyte",
    "train_y": "train-labels-idx1-ubyte",
    "test_x": "t10k-images-idx3-ubyte",
    "test_y": "t10k-labels-idx1-ubyte",
}


def default_data_dir() -> Path:
    """``<temp dir>/mnist-data``: the reference's ``/tmp/mnist-data``
    unless TMPDIR points elsewhere."""
    return Path(tempfile.gettempdir()) / "mnist-data"


@dataclasses.dataclass
class Dataset:
    """In-memory dataset. Images uint8 NHWC; labels int32 [N]."""

    name: str
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int = 10
    synthetic: bool = False

    @property
    def image_shape(self) -> tuple[int, ...]:
        return self.train_images.shape[1:]


def _paths(data_dir: Path, name: str) -> dict[str, Path]:
    prefix = "" if name == "mnist" else f"{name}."
    return {k: data_dir / f"{prefix}{v}" for k, v in _MNIST_FILES.items()}


def _synth_marker(data_dir: Path, name: str) -> Path:
    return data_dir / f".{name}.synthetic-twin"


def _load_idx(data_dir: Path, name: str) -> dict[str, np.ndarray] | None:
    """The IDX quad (plain or .gz), or None when a file is missing."""
    found = {}
    for key, path in _paths(data_dir, name).items():
        gz = path.with_name(path.name + ".gz")
        if path.exists():
            found[key] = path
        elif gz.exists():
            found[key] = gz
        else:
            return None
    out = {k: read_idx(p) for k, p in found.items()}
    out["train_x"] = out["train_x"][..., None]  # HW -> HWC
    out["test_x"] = out["test_x"][..., None]
    return out


def _load_cifar10_dir(data_dir: Path) -> dict[str, np.ndarray] | None:
    """CIFAR-10's python batches (unpacking the tarball first if that is
    what the directory holds), or None when absent."""
    batch_dir = data_dir / "cifar-10-batches-py"
    if not batch_dir.exists():
        tars = list(data_dir.glob("cifar-10-python.tar.gz"))
        if not tars:
            return None
        with tarfile.open(tars[0]) as tf:
            tf.extractall(data_dir, filter="data")
        if not batch_dir.exists():
            return None

    def load_batch(p: Path):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(d[b"labels"], np.int32)

    train = [load_batch(batch_dir / f"data_batch_{i}") for i in range(1, 6)]
    test_x, test_y = load_batch(batch_dir / "test_batch")
    return {
        "train_x": np.concatenate([t[0] for t in train]),
        "train_y": np.concatenate([t[1] for t in train]),
        "test_x": test_x,
        "test_y": test_y,
    }


def _load_cifar10(data_dir: Path) -> dict[str, np.ndarray] | None:
    """The reference's synthetic-twin cache (``cifar10_synth.npz``) first,
    then the real batches."""
    npz = data_dir / "cifar10_synth.npz"
    if npz.exists():
        with np.load(npz) as z:
            return {k: z[k] for k in ("train_x", "train_y", "test_x",
                                      "test_y")}
    return _load_cifar10_dir(data_dir)


def _synth(name: str, n_train: int, n_test: int, seed: int):
    gen = {"mnist": synthetic.synthetic_mnist,
           "fashion_mnist": synthetic.synthetic_fashion_mnist,
           "cifar10": synthetic.synthetic_cifar10}[name]
    tx, ty = gen(n_train, seed=seed, split=0)
    vx, vy = gen(n_test, seed=seed, split=7)
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def _write_synth_cache(data_dir: Path, name: str, raw: dict) -> None:
    """Persist the synthesized twin in the reference's format (IDX files,
    or one npz for CIFAR-10; atomic tmp + rename, so a concurrent or
    interrupted run never leaves a torn file), then the marker that says
    these files are procedural."""
    data_dir.mkdir(parents=True, exist_ok=True)

    def atomic(path: Path, write) -> None:
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        try:
            write(tmp)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)

    if name == "cifar10":
        def write_npz(p: Path) -> None:
            with p.open("wb") as f:
                np.savez(f, **raw)

        atomic(data_dir / "cifar10_synth.npz", write_npz)
    else:
        paths = _paths(data_dir, name)
        for key, arr in (("train_x", raw["train_x"][..., 0]),
                         ("train_y", raw["train_y"].astype(np.uint8)),
                         ("test_x", raw["test_x"][..., 0]),
                         ("test_y", raw["test_y"].astype(np.uint8))):
            atomic(paths[key], lambda p, arr=arr: write_idx(p, arr))
    _synth_marker(data_dir, name).touch()


def load_dataset(
    name: str,
    data_dir: str | Path | None = None,
    *,
    seed: int = 0,
    synthetic_sizes: tuple[int, int] = (60_000, 10_000),
    cache_synthetic: bool = True,
) -> Dataset:
    """Load `name` from `data_dir` (default `default_data_dir()`), else
    synthesize its procedural twin and, at the full sizes, cache it there
    in the canonical on-disk format."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    data_dir = Path(data_dir) if data_dir is not None else default_data_dir()
    raw = None
    if data_dir.exists():
        try:
            raw = (_load_cifar10(data_dir) if name == "cifar10"
                   else _load_idx(data_dir, name))
        except (ValueError, OSError) as e:
            # torn or corrupt files must not stop training: resynthesize
            log.warning("unreadable %s under %s (%s); falling back to "
                        "synthesis", name, data_dir, e)
            raw = None
    # files written by _write_synth_cache are procedural: the marker keeps
    # the flag true on cache reloads
    is_synth = raw is None or _synth_marker(data_dir, name).exists()
    if raw is None:
        log.warning("%s not found under %s — using synthetic twin", name,
                    data_dir)
        raw = _synth(name, *synthetic_sizes, seed)
        if cache_synthetic and synthetic_sizes == (60_000, 10_000):
            try:
                _write_synth_cache(data_dir, name, raw)
            except OSError as e:  # a read-only data_dir is fine
                log.info("could not cache synthetic %s: %s", name, e)
    return Dataset(
        name=name,
        train_images=np.ascontiguousarray(raw["train_x"]),
        train_labels=raw["train_y"].astype(np.int32),
        test_images=np.ascontiguousarray(raw["test_x"]),
        test_labels=raw["test_y"].astype(np.int32),
        synthetic=is_synth,
    )
