"""The benchmark-ladder configs, copied from the reference `configs.py`.

Every entry of the reference ladder is here (`mlp_mnist`,
`lenet5_mnist`, `lenet5_fashion`, `resnet20_cifar`, `resnet20_cifar_fsdp`,
`vit_tiny_cifar`, `vit_tiny_cifar_flash`, `vit_tiny_cifar_ulysses`,
`vit_tiny_cifar_ulysses_flash`, `vit_tiny_cifar_ring`,
`vit_tiny_cifar_ring_flash`, `vit_tiny_cifar_moe`, `vit_tiny_cifar_tp`,
`vit_tiny_cifar_pp`, `vit_tiny_cifar_fsdp_tp`). A test pins each entry
field for field against the reference ladder.
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
    # 3) LeNet-5 / Fashion-MNIST / 4-way DP
    "lenet5_fashion": Config(
        name="lenet5_fashion",
        model="lenet5",
        dataset="fashion_mnist",
        batch_size=512,
        train_steps=3000,
        learning_rate=1e-3,
        mesh=MeshSpec(data=4),
        ladder_devices=4,
    ),
    # 4) ResNet-20 / CIFAR-10 / 8-way DP
    "resnet20_cifar": Config(
        name="resnet20_cifar",
        model="resnet20",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=2e-3,
        lr_schedule="cosine",
        warmup_steps=200,
        grad_clip_norm=1.0,
        augment=True,  # pad-crop-flip: standard CIFAR recipe, on device
        mesh=MeshSpec(data=8),
        ladder_devices=8,
    ),
    # 4b) config 4 under ZeRO/FSDP: same model, data and trajectory as
    # resnet20_cifar, params + Adam slots 1/8th per rank
    "resnet20_cifar_fsdp": Config(
        name="resnet20_cifar_fsdp",
        model="resnet20",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=2e-3,
        lr_schedule="cosine",
        warmup_steps=200,
        grad_clip_norm=1.0,
        augment=True,
        sharding_rules="fsdp",
        mesh=MeshSpec(data=8),
        ladder_devices=8,
    ),
    # 5) ViT-Tiny / CIFAR-10 / pod slice (stretch; attention path)
    "vit_tiny_cifar": Config(
        name="vit_tiny_cifar",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,  # depth-12 attention stack: recompute, don't hold
        augment=True,
        model_kwargs={"scan_blocks": True},
        mesh=MeshSpec(data=-1),
        ladder_devices=16,
    ),
    # 5g) config 5 with the flash-attention kernels (forward and backward)
    "vit_tiny_cifar_flash": Config(
        name="vit_tiny_cifar_flash",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"attention_impl": "flash", "scan_blocks": True},
        mesh=MeshSpec(data=-1),
        ladder_devices=16,
    ),
    # 5b) config 5 with Ulysses sequence parallelism: the all-to-all SP
    # alternative to ring attention. heads=4 (not ViT-Ti's 3) so heads %
    # seq == 0, and mean pooling keeps the token count divisible by the
    # seq axis.
    "vit_tiny_cifar_ulysses": Config(
        name="vit_tiny_cifar_ulysses",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"attention_impl": "ulysses", "pool": "mean",
                      "heads": 4, "scan_blocks": True},
        mesh=MeshSpec(data=-1, seq=2),
        ladder_devices=16,
    ),
    # 5g) Ulysses with the flash kernels as the local engine: after the
    # head reshard each rank attends over the whole sequence
    "vit_tiny_cifar_ulysses_flash": Config(
        name="vit_tiny_cifar_ulysses_flash",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"attention_impl": "ulysses_flash", "pool": "mean",
                      "heads": 4, "scan_blocks": True},
        mesh=MeshSpec(data=-1, seq=2),
        ladder_devices=16,
    ),
    # 5f) config 5 with ring attention over a 2-way `seq` axis (blockwise
    # K/V rotation around the ring: parallel/ring_attention.py)
    "vit_tiny_cifar_ring": Config(
        name="vit_tiny_cifar_ring",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"attention_impl": "ring", "pool": "mean",
                      "scan_blocks": True},
        mesh=MeshSpec(data=-1, seq=2),
        ladder_devices=16,
    ),
    # 5f') config 5f with the flash kernels as the ring's local block
    # engine (flash_attention_lse's (out, lse) pair feeding the blockwise
    # log-sum-exp merge)
    "vit_tiny_cifar_ring_flash": Config(
        name="vit_tiny_cifar_ring_flash",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"attention_impl": "ring_flash", "pool": "mean",
                      "scan_blocks": True},
        mesh=MeshSpec(data=-1, seq=2),
        ladder_devices=16,
    ),
    # 5c) config 5 with switch-MoE FFN blocks, expert-parallel over a
    # 4-way `model` axis (one expert per rank — parallel/moe.py); the
    # load-balance aux loss joins the objective via model_state.
    "vit_tiny_cifar_moe": Config(
        name="vit_tiny_cifar_moe",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"mlp_impl": "moe", "n_experts": 4, "pool": "mean",
                      "scan_blocks": True},
        mesh=MeshSpec(data=-1, model=4),
        ladder_devices=16,
    ),
    # 5e) config 5 tensor-parallel: qkv/mlp matmuls Megatron-sharded over a
    # 2-way `model` axis (TP_RULES column/row pattern); grads for the
    # sharded params stay sharded — the step's collectives run over the
    # model group (models/vit.py).
    "vit_tiny_cifar_tp": Config(
        name="vit_tiny_cifar_tp",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"scan_blocks": True},
        sharding_rules="tp",
        mesh=MeshSpec(data=-1, model=2),
        ladder_devices=16,
    ),
    # 5d) config 5 with the block stack GPipe'd over a 4-stage `pipe` axis
    # (3 blocks per stage, microbatched activations around the ring —
    # parallel/pipeline.py). Trains with the default dropout 0.1 like its
    # siblings.
    "vit_tiny_cifar_pp": Config(
        name="vit_tiny_cifar_pp",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"scan_blocks": True, "block_pipeline": 4},
        mesh=MeshSpec(data=-1, pipe=4),
        ladder_devices=16,
    ),
    # 5e') config 5e with FSDP composed on top of TP: the `model` axis
    # takes the Megatron column/row split first, the FSDP shape rule then
    # shards each leaf's largest remaining free dim over `data` — params +
    # slots are 1/(data*model)-th per chip where both apply.
    "vit_tiny_cifar_fsdp_tp": Config(
        name="vit_tiny_cifar_fsdp_tp",
        model="vit_tiny",
        dataset="cifar10",
        batch_size=1024,
        train_steps=5000,
        learning_rate=1e-3,
        lr_schedule="cosine",
        warmup_steps=500,
        grad_clip_norm=1.0,
        weight_decay=0.05,
        remat=True,
        augment=True,
        model_kwargs={"scan_blocks": True},
        sharding_rules="fsdp_tp",
        mesh=MeshSpec(data=-1, model=2),
        ladder_devices=16,
    ),
}


def get_config(name: str, **overrides) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
