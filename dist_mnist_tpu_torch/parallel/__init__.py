"""Parallelism (port of the reference `parallel/`): the collectives and
sharding rules of data, tensor and sequence parallelism, ring and
Ulysses attention, the flash kernels' sharded entry, and model
parallelism: switch-MoE expert parallelism (`moe.py`), the GPipe block
pipeline (`pipeline.py`) and the collective matmul
(`collective_matmul.py`)."""
