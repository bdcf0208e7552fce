"""Batching and device placement (port of the reference
`data/pipeline.py`, one device). Two paths:

- `ShardedBatcher`: host-side deterministic shuffled epochs; the shuffle
  order is a Philox(key=[seed, epoch]) permutation (`epoch_batches`, the
  reference's own), so both packages draw the same rows for every step,
  and a batcher positioned at a step (`at_step`) resumes exactly there.
- `DeviceDataset`: the whole training split lives on the device: images
  as flat uint8 rows ``[N, H*W*C]`` (47.0 MB for MNIST) and labels as
  int32 ``[N]``. A step draws a with-replacement batch of indices from a
  generator on that device, gathers, and reshapes to NHWC, so feeding a
  step costs the host nothing but the launches.

Images stay uint8 until the step normalizes them. More than one process
or device (the reference's mesh-sharded batches and sharded residency)
joins with ROADMAP §1 item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

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
    """Infinite deterministic iterator of train batches on one device.

    `host_batches()` yields the reference's numpy rows for each step;
    `__iter__` moves each batch to `device`. Normalization (uint8 ->
    [0,1] float32) happens in the step, not here."""

    dataset: Dataset
    global_batch: int
    device: torch.device | str = "cuda"
    seed: int = 0
    start_step: int = 0

    def __post_init__(self):
        if isinstance(self.device, (list, tuple)):
            raise NotImplementedError(
                f"a batch sharded over {len(self.device)} devices joins the "
                "port with ROADMAP §1 item 12 (data and tensor parallelism)")
        self.device = torch.device(self.device)
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "a batch split over processes joins the port with ROADMAP "
                "§1 item 12 (data and tensor parallelism)")

    def at_step(self, step: int) -> "ShardedBatcher":
        """A batcher positioned at `step` (TrainLoop recovery re-seek)."""
        return dataclasses.replace(self, start_step=step)

    def host_batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Host-side half of the stream: each step's numpy batch, BEFORE
        device placement (`DevicePrefetcher` pulls these in its worker)."""
        n = self.dataset.train_images.shape[0]
        if self.global_batch < 1:
            raise ValueError(f"global batch must be >= 1, got "
                             f"{self.global_batch}")
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
                yield {
                    "image": self.dataset.train_images[idx],
                    "label": self.dataset.train_labels[idx],
                }
            skip = 0
            epoch += 1

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        for batch in self.host_batches():
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in batch.items()}


class DeviceDataset:
    def __init__(self, dataset: Dataset, device: torch.device | str):
        self.device = torch.device(device)
        self.n = int(dataset.train_images.shape[0])
        self.image_shape = tuple(dataset.train_images.shape[1:])
        flat = np.ascontiguousarray(dataset.train_images).reshape(self.n, -1)
        self.images = torch.from_numpy(flat).to(self.device)
        self.labels = torch.from_numpy(
            np.ascontiguousarray(dataset.train_labels, np.int32)).to(
                self.device)

    def nbytes(self) -> int:
        """Device bytes the resident split takes."""
        return (self.images.numel() * self.images.element_size()
                + self.labels.numel() * self.labels.element_size())

    def sample(self, gen: torch.Generator, batch: int) -> dict:
        """A with-replacement batch drawn from `gen` (a generator on this
        dataset's device): ``{"image": uint8 [B, H, W, C], "label": int32
        [B]}``."""
        idx = torch.randint(0, self.n, (batch,), generator=gen,
                            device=self.device)
        return self.gather(idx)

    def gather(self, idx: torch.Tensor) -> dict:
        """The rows at `idx` (a test feeds the reference's indices)."""
        idx = idx.to(self.device)
        images = torch.index_select(self.images, 0, idx)
        return {"image": images.reshape(-1, *self.image_shape),
                "label": torch.index_select(self.labels, 0, idx)}
