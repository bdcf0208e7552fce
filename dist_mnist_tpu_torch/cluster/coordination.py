"""Process-group bootstrap and chief election (port of the reference
`cluster/coordination.py`).

`initialize_distributed` joins this process to a `torch.distributed`
process group over a TCP store (``tcp://<coordinator_address>``, the
address, world size and rank taken from the flags or, when those are
absent, from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``). It is a no-op for a single process. The backend follows one
stated rule, printed on the startup line, and is never a fallback after a
failure:

- ``--platform=cpu``: gloo, every rank on the CPU;
- each rank has a card of its own (as many cards as ranks): NCCL, rank r
  on ``cuda:r``;
- ranks share a card (fewer cards than ranks): gloo over CUDA tensors,
  rank r on ``cuda:(r % cards)``, since NCCL refuses two ranks on one
  GPU. This torch build's gloo takes CUDA tensors for every collective
  the steps run (all_reduce, broadcast, all_gather_into_tensor,
  reduce_scatter_tensor, barrier and all_to_all_single:
  `scripts/torch_gloo_cuda_probe.py` on the H100 machine, torch 2.11 +
  CUDA 12.8), so none is staged through host memory by hand; gloo copies
  through the host itself. Its point-to-point sends (isend and irecv,
  which the ring shift of sequence parallelism posts) refuse CUDA
  tensors there (the transport's ``writev`` fails with "Bad address"),
  so `parallel/collectives.ring_shift` copies them to host memory and
  back itself under gloo.

Besides the group, every rank of a multi-process run gets a gloo group
over the host for the decisions ranks must agree on (a checkpoint save,
a barrier): with NCCL that is a second group, with gloo the same one.

A ``data x model x seq x pipe`` mesh (`cluster/mesh.py`) adds a
subgroup per line of its rank grid along each axis (row-major, or the
hybrid multislice layout), each with a host group of its own by the same
rule (`mesh_groups`).
`torch.distributed.new_group` is collective over the whole group, so
every rank creates every subgroup, in the same order (the data groups by
model, seq and pipe index, then the model groups, the seq groups and the
pipe groups, each by the other axes' indices), and keeps those it
belongs to.

Chief is rank 0: it owns the host-side side effects (checkpoint writes,
summary files). Params are initialized identically on every rank from
the same seed, so nothing waits on the chief to start.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any

import torch

log = logging.getLogger(__name__)

#: seconds a collective may wait for its peers before it fails
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistContext:
    """This process's place in the group, and the rule that chose its
    backend."""

    rank: int
    world: int
    backend: str
    device: torch.device
    rule: str
    host_group: Any = None


_CONTEXT: DistContext | None = None
#: (rank grid's shape and ranks) -> the axes' (group, host group) pairs
#: of this rank
_MESH_GROUPS: dict = {}


def context() -> DistContext | None:
    """The context `initialize_distributed` set up, or None (one process,
    or not initialized)."""
    return _CONTEXT


def backend_rule(platform: str | None, world: int,
                 cards: int) -> tuple[str, str]:
    """(backend, the rule's name) for `world` ranks on one host with
    `cards` CUDA devices."""
    if platform == "cpu":
        return "gloo", "cpu platform"
    if cards < 1:
        raise RuntimeError(
            "no CUDA device: the distributed port runs on NVIDIA GPUs; pass "
            "--platform=cpu to run its ranks on the CPU")
    if cards >= world:
        return "nccl", "one card per rank"
    return "gloo", "ranks share a card"


def _from_env(name: str) -> str | None:
    value = os.environ.get(name)
    return value if value else None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    platform: str | None = None,
    init_method: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> DistContext | None:
    """Join the process group (no-op single-process; returns None then).

    `init_method` replaces the TCP store (a test passes a ``file://``
    store in its own temp dir). Rank r's device is ``cuda:(r % cards)``,
    or the CPU under ``platform="cpu"``."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    if num_processes is None and _from_env("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and _from_env("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and _from_env("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes or 1
    if world <= 1:
        log.info("single-process run; no process group")
        return None
    rank = process_id or 0
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    if init_method is None:
        if not coordinator_address:
            raise ValueError(f"{world} processes need --coordinator_address "
                             "(host:port of process 0)")
        init_method = f"tcp://{coordinator_address}"
    cards = 0 if platform == "cpu" else torch.cuda.device_count()
    backend, rule = backend_rule(platform, world, cards)
    if platform == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    torch.distributed.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=timeout)
    host_group = (torch.distributed.new_group(backend="gloo", timeout=timeout)
                  if backend != "gloo" else torch.distributed.group.WORLD)
    _CONTEXT = DistContext(rank=rank, world=world, backend=backend,
                           device=device, rule=rule, host_group=host_group)
    log.info("distributed init: %s", startup_line(_CONTEXT))
    return _CONTEXT


def mesh_groups(grid) -> dict:
    """``{"data": (group, host_group), "model": ..., "seq": ..., "pipe":
    ...}`` of this rank for `grid`, the ``data x model x seq x pipe``
    array of the process group's ranks (`Mesh.grid`: row-major, rank
    ``((d * model + m) * seq + s) * pipe + p``, or the hybrid multislice
    layout): each axis's groups are the grid's lines along it, the ranks
    that share the other three coordinates. None where an axis is one
    rank wide; an axis as wide as the world is the world group. Created
    once per grid, by every rank in the same order (module docstring)."""
    import numpy as np

    grid = np.asarray(grid)
    shape = grid.shape
    key = (shape, grid.tobytes())
    if key in _MESH_GROUPS:
        return _MESH_GROUPS[key]
    ctx = _CONTEXT
    if ctx is None:
        raise RuntimeError("mesh_groups needs initialize_distributed first")
    if grid.size != ctx.world:
        raise ValueError(f"mesh grid {shape} != {ctx.world} ranks")
    world = torch.distributed.group.WORLD
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    axes = ("data", "model", "seq", "pipe")

    def lines(axis: str) -> list:
        # the other axes in order, the last varying fastest
        i = axes.index(axis)
        return np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist()

    out = {}
    for axis in axes:
        mine = (None, None)
        for ranks in lines(axis):
            if ranks != sorted(ranks):
                # torch orders a group's ranks by global rank; the
                # collectives take a rank's group index for its axis index
                raise ValueError(
                    f"{axis} line {ranks} of the rank grid is not "
                    "ascending: a group's ranks must be in axis order")
            if len(ranks) == 1:
                continue
            if len(ranks) == ctx.world:
                group, host = world, ctx.host_group
            else:
                group = torch.distributed.new_group(ranks, timeout=timeout)
                host = (torch.distributed.new_group(
                    ranks, backend="gloo", timeout=timeout)
                    if ctx.backend != "gloo" else group)
            if ctx.rank in ranks:
                mine = (group, host)
        out[axis] = mine
    _MESH_GROUPS[key] = out
    return out


def startup_line(ctx: DistContext | None) -> str:
    """``process K/N, 1 local / N global devices`` plus the backend and
    the rule that chose it."""
    if ctx is None:
        return "process 0/1, 1 local / 1 global devices, backend none"
    return (f"process {ctx.rank}/{ctx.world}, 1 local / {ctx.world} global "
            f"devices, backend {ctx.backend} ({ctx.rule}), device "
            f"{ctx.device}")


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _CONTEXT
    if _CONTEXT is None:
        return
    _CONTEXT = None
    _MESH_GROUPS.clear()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def is_chief() -> bool:
    """Rank 0 is chief: it owns checkpoint writes and summary files."""
    return _CONTEXT is None or _CONTEXT.rank == 0


def barrier() -> None:
    """Every rank waits here for every other (no-op single-process)."""
    if _CONTEXT is not None:
        torch.distributed.barrier(group=_CONTEXT.host_group)


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (one all-reduce of
    one integer over the host group; `flag` itself single-process): a
    decision one rank may reach alone (a preemption notice, a timer) that
    every rank must act on at the same step."""
    if _CONTEXT is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=_CONTEXT.host_group)
    return bool(t.item())


def agree(value):
    """The chief's `value` on every rank (a picklable object; returned as
    is single-process): what ranks must decide together, e.g. whether a
    checkpoint save happens, is decided once."""
    if _CONTEXT is None:
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0,
                                            group=_CONTEXT.host_group)
    return box[0]
