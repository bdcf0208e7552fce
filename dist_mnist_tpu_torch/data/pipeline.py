"""The device-resident dataset (port of the reference `data/pipeline.py
DeviceDataset`, one device).

The whole training split lives on the device: images as flat uint8 rows
``[N, H*W*C]`` (47.0 MB for MNIST) and labels as int32 ``[N]``. A step
draws a with-replacement batch of indices from a generator on that
device, gathers, and reshapes to NHWC, so feeding a step costs the host
nothing but the launches. Images stay uint8 until the step normalizes
them. The sharded residency and `ShardedBatcher` join with the
data-parallel slice.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_mnist_tpu_torch.data.datasets import Dataset


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
