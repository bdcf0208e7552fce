"""The rank mesh (port of the reference `cluster/mesh.py`).

In the reference a device of the mesh is one chip of an SPMD program.
Here a device is one RANK of a `torch.distributed` process group, with one
device per process (rank r drives ``cuda:(r % cards)``, or the CPU). A
`Mesh` is that group seen from one rank: the axis sizes, this rank's
index on the ``data``, ``model`` and ``seq`` axes, its device, and the
groups the collectives run over (None where an axis is one rank wide).

The ranks form a ``data x model x seq x pipe`` grid in the row-major
order of `AXES`, as the reference lays its devices out: rank ``r = ((d *
model + m) * seq + s) * pipe + p``. The ranks of one model group (same
d, s and p) hold one replica of the model and see the same batch, each
with its share of the tensor-parallel leaves, or under expert
parallelism (`parallel/moe.py`) its expert and its share of every MoE
layer's tokens; the ranks of one seq group (same d, m and p) see the
same batch too, each holding its contiguous share of every sequence's
tokens (sequence parallelism: `parallel/ring_attention.py`,
`parallel/ulysses.py`); the ranks of one pipe group (same d, m and s)
see the same batch, each running its stages of the block stack
(`parallel/pipeline.py`); the ranks of one data group (same m, s and p)
split the batch. A ``seq`` axis beside a ``model`` axis, and a ``pipe``
axis beside either, both wider than one, refuse: no reference config
combines them. The reference's multislice layout (`hybrid_mesh_shapes`,
`with_fake_slices`, which puts the slice factor on ``data`` when it can
and otherwise on ``pipe``: with the pipe axis here, the port can now
place slices there too) and `compat_shard_map` have no counterpart
yet.

`activate(mesh)` makes a mesh ambient for the forward pass: synchronized
batch norm (`ops/nn.batch_norm`) reads it with `ambient_mesh()`, as the
reference's layers discover the mesh `jax.set_mesh` installs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS)

#: the axis pairs no reference config combines, which the port refuses
#: under the label of the slice that brought them
_UNCOMBINED = "ROADMAP §1 item 11 (no reference config combines them)"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data=-1`` means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        fixed = self.model * self.seq * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"model*seq*pipe={fixed}"
                )
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.model}x{self.seq}x{self.pipe} != "
                f"{n_devices} devices"
            )
        return (data, self.model, self.seq, self.pipe)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """The whole-cluster topology: processes x one device each. Every
    process runs the same program; process 0 is chief only for host-side
    side effects (logging, checkpoint writes)."""

    mesh: MeshSpec = MeshSpec()
    coordinator_address: str | None = None  # host:port of process 0
    num_processes: int = 1
    process_id: int = 0

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the mesh. `rank` is this rank's index on the
    ``data`` axis and `group` the data group (the ranks with this rank's
    model and seq indices: the batch splits over them); `model_index` and
    `model_group` are the same for the ``model`` axis (the ranks with
    this rank's data and seq indices: the tensor-parallel leaves split
    over them), `seq_index` and `seq_group` for the ``seq`` axis (the
    ranks with this rank's data and model indices: the tokens split over
    them). A group is None where its axis is one rank wide. `host_groups` holds
    a gloo group per axis for host-side messages (the decode follower
    protocol), `backend` the collectives' backend; `stats` counts what
    the collectives moved."""

    shape: dict
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    backend: str = "none"
    #: bytes and calls of each collective on this mesh
    #: (`parallel.collectives.collective_stats`)
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    model_index: int = 0
    model_group: Any = None
    host_groups: dict = dataclasses.field(default_factory=dict)
    seq_index: int = 0
    seq_group: Any = None
    pipe_index: int = 0
    pipe_group: Any = None

    @property
    def size(self) -> int:
        """Ranks on the ``data`` axis."""
        return self.shape[DATA_AXIS]

    @property
    def model(self) -> int:
        """Ranks on the ``model`` axis."""
        return self.shape[MODEL_AXIS]

    @property
    def seq(self) -> int:
        """Ranks on the ``seq`` axis."""
        return self.shape[SEQ_AXIS]

    @property
    def pipe(self) -> int:
        """Ranks on the ``pipe`` axis."""
        return self.shape[PIPE_AXIS]

    @property
    def ranks(self) -> int:
        """Every rank of the mesh."""
        return self.size * self.model * self.seq * self.pipe

    @property
    def model_chief(self) -> int:
        """The process-group rank of this model group's first rank (the
        one that drives a tensor-parallel decode engine)."""
        return ((self.rank * self.model * self.seq + self.seq_index)
                * self.pipe + self.pipe_index)

    def axis_index(self, axis: str) -> int:
        return {MODEL_AXIS: self.model_index, SEQ_AXIS: self.seq_index,
                PIPE_AXIS: self.pipe_index}.get(axis, self.rank)

    def axis_group(self, axis: str):
        return {MODEL_AXIS: self.model_group, SEQ_AXIS: self.seq_group,
                PIPE_AXIS: self.pipe_group}.get(axis, self.group)


def device_count() -> int:
    """Devices of the cluster: one per rank of the default process group,
    1 without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def check_axes(spec: MeshSpec) -> None:
    """Refuse a ``seq`` axis beside a ``model`` axis, and a ``pipe`` axis
    beside either, both wider than one: no reference config combines
    them."""
    wide = [axis for axis in (MODEL_AXIS, SEQ_AXIS, PIPE_AXIS)
            if getattr(spec, axis) > 1]
    if len(wide) > 1:
        pairs = " beside ".join(f"a {axis} axis of {getattr(spec, axis)}"
                                for axis in wide)
        raise NotImplementedError(
            f"{pairs}: {_UNCOMBINED}; the port runs tensor, expert, "
            "sequence or pipeline parallelism one at a time beside data "
            "parallelism")


def make_mesh(spec: MeshSpec | None = None, *,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh `spec` names over the ranks of the default process group
    (one rank when there is none). Every rank of the group calls it with
    the same spec: the first call for a shape creates the axes' subgroups
    (`coordination.mesh_groups`).

    Raises `ValueError` when the spec wants more ranks than exist (a
    caller may fall back to ``MeshSpec(data=-1)``, as `bench.run_config`
    does) or fewer: every rank of the group is on the mesh.
    `NotImplementedError` for what `check_axes` refuses.
    `device` defaults to the device `initialize_distributed` gave this
    rank."""
    from dist_mnist_tpu_torch.cluster import coordination

    spec = spec or MeshSpec()
    check_axes(spec)
    n = device_count()
    if spec.data != -1:
        want = spec.data * spec.model * spec.seq * spec.pipe
        if want > n:
            raise ValueError(f"mesh needs {want} devices, only {n} visible")
        if want < n:
            raise ValueError(
                f"mesh of {want} devices on a group of {n} ranks: every "
                "rank of the group is on the port's mesh")
    shape = dict(zip(AXES, spec.resolve(n)))
    ctx = coordination.context()
    if device is None:
        device = ctx.device if ctx is not None else torch.device("cpu")
    if n == 1:
        return Mesh(shape=shape, device=torch.device(device))
    data, model, seq, pipe = (shape[axis] for axis in AXES)
    groups = coordination.mesh_groups(data, model, seq, pipe)
    rank = torch.distributed.get_rank()
    return Mesh(shape=shape, rank=rank // (model * seq * pipe),
                model_index=rank // (seq * pipe) % model,
                seq_index=rank // pipe % seq, pipe_index=rank % pipe,
                device=torch.device(device),
                group=groups[DATA_AXIS][0], model_group=groups[MODEL_AXIS][0],
                seq_group=groups[SEQ_AXIS][0],
                pipe_group=groups[PIPE_AXIS][0],
                host_groups={axis: g[1] for axis, g in groups.items()},
                backend=ctx.backend if ctx is not None
                else torch.distributed.get_backend())


def local_batch_slice(global_batch: int, mesh: Mesh) -> tuple[int, int]:
    """(per-process batch, per-device batch) for a global batch: the
    same number, one device per process. The batch splits over the
    ``data`` axis only: the ranks of one model, seq or pipe group get the
    same rows."""
    if global_batch % mesh.size != 0:
        raise ValueError(f"global batch {global_batch} % data axis "
                         f"{mesh.size} != 0")
    per = global_batch // mesh.size
    return per, per


def validate_mesh(mesh: Mesh) -> None:
    """Refuse a mesh whose ranks do not match its groups."""
    for axis in AXES:
        n, group = mesh.shape[axis], mesh.axis_group(axis)
        if n > 1 and (group is None
                      or n != torch.distributed.get_world_size(group)):
            raise ValueError(f"{axis} axis of {n} ranks does not match its "
                             "process group")
        if not 0 <= mesh.axis_index(axis) < n:
            raise ValueError(f"{axis} index {mesh.axis_index(axis)} outside "
                             f"an axis of {n}")


_AMBIENT = threading.local()


@contextlib.contextmanager
def activate(mesh: Mesh | None):
    """Make `mesh` the ambient mesh of this thread inside the block."""
    prev = getattr(_AMBIENT, "mesh", None)
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev


def ambient_mesh() -> Mesh | None:
    """The mesh `activate` installed on this thread, or None."""
    return getattr(_AMBIENT, "mesh", None)
