"""Batching and device placement (port of the reference
`data/pipeline.py`). Two paths:

- `ShardedBatcher`: host-side deterministic shuffled epochs; the shuffle
  order is a Philox(key=[seed, epoch]) permutation (`epoch_batches`, the
  reference's own), so both packages draw the same rows for every step,
  and a batcher positioned at a step (`at_step`) resumes exactly there.
  On a mesh each process loads only its slice of every global batch,
  ``idx[rank * local : (rank + 1) * local]`` of the same permutation.
- `DeviceDataset`: the whole training split lives on the device: images
  as flat uint8 rows ``[N, H*W*C]`` (47.0 MB for MNIST) and labels as
  int32 ``[N]``. A step draws a with-replacement batch of indices from a
  generator on that device, gathers, and reshapes to NHWC, so feeding a
  step costs the host nothing but the launches. On a mesh every rank
  holds the whole split and draws the GLOBAL batch's indices, keeping its
  slice; with ``shard=True`` each rank holds 1/N of the rows (after one
  seeded global shuffle) and draws its slice from its own rows, the
  reference's `_sample_sharded`.

On a ``data x model`` mesh "rank" above is the rank's index on the
``data`` axis and N the data axis's size: the ranks of one model group
(the tensor-parallel shares of one replica) load, hold and draw the same
rows.

Images stay uint8 until the step normalizes them. One device per process:
a batch split over several devices of one process is refused (a stated
departure of the port).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from dist_mnist_tpu_torch.cluster.mesh import Mesh, device_count
from dist_mnist_tpu_torch.data.datasets import Dataset


def epoch_batches(
    n: int, batch_size: int, *, seed: int, epoch: int, drop_remainder: bool = True
) -> Iterator[np.ndarray]:
    """Deterministic shuffled index batches for one epoch (a copy of the
    reference's)."""
    rng = np.random.Generator(np.random.Philox(key=[seed, epoch]))
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        yield perm[i : i + batch_size]


@dataclasses.dataclass
class ShardedBatcher:
    """Infinite deterministic iterator of train batches.

    `host_batches()` yields the reference's numpy rows for each step
    (this rank's slice on a `mesh`); `__iter__` moves each batch to
    `device`. Normalization (uint8 -> [0,1] float32) happens in the step,
    not here."""

    dataset: Dataset
    global_batch: int
    device: torch.device | str = "cuda"
    seed: int = 0
    start_step: int = 0
    mesh: Mesh | None = None

    def __post_init__(self):
        if isinstance(self.device, (list, tuple)):
            raise NotImplementedError(
                f"a batch over {len(self.device)} devices of one process: "
                "the port runs one device per process (ROADMAP §1 item 12's "
                "stated departure); split the batch over ranks with a mesh")
        self.device = torch.device(self.device)
        if self.mesh is None and device_count() > 1:
            raise ValueError(
                f"{device_count()} ranks and no mesh: pass the mesh, so "
                "each rank loads its slice of the global batch")

    def at_step(self, step: int) -> "ShardedBatcher":
        """A batcher positioned at `step` (TrainLoop recovery re-seek)."""
        return dataclasses.replace(self, start_step=step)

    def host_batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Host-side half of the stream: this rank's numpy slice of each
        step's global batch, BEFORE device placement (`DevicePrefetcher`
        pulls these in its worker)."""
        n = self.dataset.train_images.shape[0]
        ranks = 1 if self.mesh is None else self.mesh.size
        rank = 0 if self.mesh is None else self.mesh.rank
        if self.global_batch < 1:
            raise ValueError(f"global batch must be >= 1, got "
                             f"{self.global_batch}")
        if self.global_batch % ranks:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"divide evenly across {ranks} ranks")
        local = self.global_batch // ranks
        if self.global_batch > n:
            raise ValueError(
                f"global batch {self.global_batch} exceeds dataset size {n}: "
                "an epoch yields zero batches"
            )
        # position is a pure function of step, so a restart is a seek
        steps_per_epoch = n // self.global_batch
        epoch = self.start_step // steps_per_epoch
        skip = self.start_step % steps_per_epoch
        while True:
            for b, idx in enumerate(epoch_batches(
                n, self.global_batch, seed=self.seed, epoch=epoch
            )):
                if b < skip:
                    continue
                mine = idx[rank * local:(rank + 1) * local]
                yield {
                    "image": self.dataset.train_images[mine],
                    "label": self.dataset.train_labels[mine],
                }
            skip = 0
            epoch += 1

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        for batch in self.host_batches():
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in batch.items()}


class DeviceDataset:
    """The training split resident on the device (see the module
    docstring); `mesh` splits each drawn batch over ranks, and `shard`
    keeps 1/N of the rows on each rank (shuffled once by `seed`)."""

    def __init__(self, dataset: Dataset, device: torch.device | str, *,
                 mesh: Mesh | None = None, shard: bool = False,
                 seed: int = 0):
        self.device = torch.device(device)
        self.mesh = mesh
        self.sharded = shard
        self.ranks = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.n = int(dataset.train_images.shape[0])
        self.image_shape = tuple(dataset.train_images.shape[1:])
        images = dataset.train_images.reshape(self.n, -1)
        labels = dataset.train_labels
        if shard:
            # one seeded global shuffle, so that class order in the file
            # cannot skew a shard; equal shards
            perm = np.random.Generator(
                np.random.Philox(key=[seed, 0xD5])).permutation(self.n)
            per = self.n // self.ranks
            mine = perm[self.rank * per:(self.rank + 1) * per]
            images, labels = images[mine], labels[mine]
            self.n = per * self.ranks
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self.labels = torch.from_numpy(
            np.ascontiguousarray(labels, np.int32)).to(self.device)

    def nbytes(self) -> int:
        """Device bytes the resident rows take on this rank."""
        return (self.images.numel() * self.images.element_size()
                + self.labels.numel() * self.labels.element_size())

    def sample(self, gen: torch.Generator, batch: int) -> dict:
        """This rank's slice of a with-replacement global batch of `batch`
        rows drawn from `gen` (a generator on this dataset's device):
        ``{"image": uint8 [B/N, H, W, C], "label": int32 [B/N]}``. Every
        rank draws the same global indices and keeps its rows; sharded,
        the draw is ``[N, B/N]`` indices into each rank's own rows and the
        rank keeps its row of it."""
        if batch % self.ranks:
            raise ValueError(f"batch {batch} % {self.ranks} ranks != 0")
        local = batch // self.ranks
        if self.sharded:
            idx = torch.randint(0, self.images.shape[0], (self.ranks, local),
                                generator=gen, device=self.device)[self.rank]
        else:
            idx = torch.randint(0, self.n, (batch,), generator=gen,
                                device=self.device)
            idx = idx[self.rank * local:(self.rank + 1) * local]
        return self.gather(idx)

    def gather(self, idx: torch.Tensor) -> dict:
        """The resident rows at `idx` (a test feeds the reference's
        indices)."""
        idx = idx.to(self.device)
        images = torch.index_select(self.images, 0, idx)
        return {"image": images.reshape(-1, *self.image_shape),
                "label": torch.index_select(self.labels, 0, idx)}
