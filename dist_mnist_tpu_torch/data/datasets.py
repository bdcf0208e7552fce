"""Dataset shape table (copy of the reference `data/datasets.py DATASETS`).

Serving needs only the image shape and class count of a config's
dataset; loaders and synthetic twins join with the training slice.
"""

from __future__ import annotations

DATASETS = {
    "mnist": dict(image_shape=(28, 28, 1), num_classes=10),
    "fashion_mnist": dict(image_shape=(28, 28, 1), num_classes=10),
    "cifar10": dict(image_shape=(32, 32, 3), num_classes=10),
}
