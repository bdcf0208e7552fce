"""The benchmark-ladder configs, copied from the reference `configs.py`.

Only the entries whose model the port serves are here (`mlp_mnist`,
`lenet5_mnist`); the others join with their slices. A test pins each
entry field for field against the reference ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    model: str
    dataset: str
    batch_size: int  # global
    train_steps: int
    learning_rate: float
    optimizer: str = "adam"  # adam | sgd | momentum
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: MeshSpec = MeshSpec()  # data = all devices by default
    ladder_devices: int = 1
    loss: str = "stable"  # "clipped" = reference parity loss
    lr_schedule: str = "constant"  # constant | cosine
    warmup_steps: int = 0
    replicas_to_aggregate: int = 1
    sharding_rules: str = "dp"
    overlap: bool = False
    overlap_bucket_mb: float = 4.0
    overlap_chunk: str = "all_gather"
    grad_clip_norm: float | None = None
    weight_decay: float = 0.0
    prng_impl: str = "threefry2x32"
    remat: bool = False
    remat_policy: str = "dots_no_batch"
    augment: bool = False
    eval_every: int = 1000
    log_every: int = 100
    checkpoint_every_secs: float = 600.0
    elastic_batch_policy: str = "keep_global"
    seed: int = 42


CONFIGS = {
    # 1) the original dist_mnist.py defaults, single chip
    "mlp_mnist": Config(
        name="mlp_mnist",
        model="mlp",
        dataset="mnist",
        batch_size=64,
        train_steps=2000,
        learning_rate=0.01,
        loss="clipped",
        model_kwargs={"hidden_units": 100},
        eval_every=500,
    ),
    # 2) "original dist config": LeNet-5, 2 workers x batch 100
    "lenet5_mnist": Config(
        name="lenet5_mnist",
        model="lenet5",
        dataset="mnist",
        batch_size=200,
        train_steps=2000,
        learning_rate=1e-3,
        eval_every=500,
    ),
}


def get_config(name: str, **overrides) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
