"""The rank mesh (port of the reference `cluster/mesh.py`).

In the reference a device of the mesh is one chip of an SPMD program.
Here a device is one RANK of a `torch.distributed` process group, with one
device per process (rank r drives ``cuda:(r % cards)``, or the CPU). A
`Mesh` is that group seen from one rank: the axis sizes, this rank's
index on the ``data``, ``model`` and ``seq`` axes, its device, and the
groups the collectives run over (None where an axis is one rank wide).

The ranks form a ``data x model x seq x pipe`` grid (`Mesh.grid`), by
default in the row-major order of `AXES`, as the reference lays its
devices out on one slice: rank ``r = ((d * model + m) * seq + s) * pipe +
p``. The ranks of one model group (same
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
combines them.

Multislice (the reference's hybrid ICI x DCN layout): the ranks fall
into slices, by default one per host (a rank's slice is the index of its
hostname among the group's distinct hostnames, in rank order: a node's
NVLink domain plays a TPU slice's ICI domain). With more than one slice,
`hybrid_mesh_shapes` (the reference's, copied) puts the slice factor on
``data`` when it divides it, else on ``pipe``, else splits it over both,
and the grid is the one `mesh_utils.create_hybrid_device_mesh` builds:
the DCN shape's blocks of slices, each an ICI-shaped row-major block of
its slice's ranks, so ``model`` and ``seq`` groups stay inside a slice.
That grid differs from row-major: data 2 x pipe 4 over 4 slices of 2
ranks puts slice k on pipe k (rank ``p * 2 + d``, not ``d * 4 + p``).
`with_fake_slices(range(world), n)` tags contiguous rank blocks as slices
(the reference's tests and dry run do the same with its devices). A slice
count no axis can absorb, or a layout that fails (slices of unequal
size), warns and takes row-major order. `compat_shard_map` has no
counterpart: the collectives are written out.

`activate(mesh)` makes a mesh ambient for the forward pass: synchronized
batch norm (`ops/nn.batch_norm`) reads it with `ambient_mesh()`, as the
reference's layers discover the mesh `jax.set_mesh` installs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import math
import socket
import threading
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

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
    them). A group is None where its axis is one rank wide. `grid` holds
    the process-group rank at each ``(d, m, s, p)`` (row-major, or the
    hybrid multislice layout). `host_groups` holds a gloo group per axis
    for host-side messages (the follower protocols), `backend` the
    collectives' backend; `stats` counts what the collectives moved."""

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
    grid: Any = None

    def __post_init__(self):
        if self.grid is None:
            shape = tuple(self.shape[axis] for axis in AXES)
            object.__setattr__(self, "grid",
                               np.arange(math.prod(shape)).reshape(shape))

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
        return int(self.grid[self.rank, 0, self.seq_index, self.pipe_index])

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


class SliceTag(NamedTuple):
    """A rank and the slice it belongs to (the reference's device with a
    ``slice_index``)."""

    rank: int
    slice_index: int


def with_fake_slices(ranks: Sequence[int], n_slices: int) -> list[SliceTag]:
    """Tag `ranks` with synthetic slice indices, contiguous blocks, so
    `make_mesh` takes the hybrid layout without a second host (the
    reference's helper over devices)."""
    ranks = list(ranks)
    if n_slices < 1 or len(ranks) % n_slices:
        raise ValueError(
            f"{len(ranks)} ranks not divisible into {n_slices} slices")
    per = len(ranks) // n_slices
    return [SliceTag(int(r), i // per) for i, r in enumerate(ranks)]


def slice_count(slices: Sequence[SliceTag]) -> int:
    """Number of distinct slices among `slices`."""
    return max(len({t.slice_index for t in slices}), 1)


def hybrid_mesh_shapes(
    shape: tuple[int, int, int, int], num_slices: int
) -> tuple[tuple[int, int, int, int], tuple[int, int, int, int]] | None:
    """Factor a resolved (data, model, seq, pipe) shape into per-slice ICI
    and cross-slice DCN shapes for `mesh_utils.create_hybrid_device_mesh`.

    The DCN factor goes on the DATA axis when it divides it (gradient
    all-reduce tolerates DCN latency — hierarchical psum: reduce-scatter
    inside each slice over ICI, all-reduce partials across slices over DCN,
    all-gather back over ICI), else on the PIPE axis (GPipe activation
    point-to-point is likewise DCN-tolerant). model/seq collectives are
    latency-critical and always stay inside a slice. Returns None when
    neither axis can absorb the slice count — caller decides the fallback.
    """
    data, model, seq, pipe = shape
    if data % num_slices == 0:
        return (data // num_slices, model, seq, pipe), (num_slices, 1, 1, 1)
    if pipe % num_slices == 0:
        return (data, model, seq, pipe // num_slices), (1, 1, 1, num_slices)
    # split the slice factor across BOTH DCN-tolerant axes (e.g. 4 slices
    # over data=2, pipe=2)
    d = math.gcd(data, num_slices)
    rest = num_slices // d
    if d > 1 and pipe % rest == 0:
        return (data // d, model, seq, pipe // rest), (d, 1, 1, rest)
    return None


def hybrid_rank_grid(ici_shape, dcn_shape,
                     slices: Sequence[SliceTag]) -> np.ndarray:
    """The rank grid `mesh_utils.create_hybrid_device_mesh` builds from
    devices, built from ranks: slices sorted by index, each slice's ranks
    (in the order given) reshaped row-major to `ici_shape`, the slices
    laid out as `dcn_shape` blocks. Raises `ValueError` when the slice
    count is not the DCN shape's product or a slice does not hold an ICI
    block's ranks."""
    by_slice: dict = collections.defaultdict(list)
    for tag in slices:
        by_slice[tag.slice_index].append(tag.rank)
    granules = [by_slice[k] for k in sorted(by_slice)]
    if math.prod(dcn_shape) != len(granules):
        raise ValueError(f"number of slices {len(granules)} must equal the "
                         f"product of dcn_mesh_shape {tuple(dcn_shape)}")
    per = math.prod(ici_shape)
    if any(len(g) != per for g in granules):
        raise ValueError(
            f"slices of {[len(g) for g in granules]} ranks: each must hold "
            f"the product of the ICI shape {tuple(ici_shape)}")
    blocks = [np.asarray(g, dtype=np.int64).reshape(ici_shape)
              for g in granules]
    order = np.arange(len(granules)).reshape(dcn_shape)
    return np.block(np.vectorize(lambda i: blocks[i], otypes=[object])(
        order).tolist())


def rank_grid(shape: tuple[int, int, int, int],
              slices: Sequence[SliceTag]) -> np.ndarray:
    """The ``(data, model, seq, pipe)`` grid of ranks for `slices` (every
    rank of the group, tagged): the hybrid layout over more than one
    slice, row-major otherwise. Warns, as the reference does, when no
    DCN-tolerant axis can place the slice count and when the hybrid
    layout fails (it then takes row-major order)."""
    ranks = [t.rank for t in slices]
    if sorted(ranks) != list(range(math.prod(shape))):
        raise ValueError(f"slices tag ranks {ranks}; the mesh needs each of "
                         f"0..{math.prod(shape) - 1} once")
    row_major = np.arange(math.prod(shape)).reshape(shape)
    n_slices = slice_count(slices)
    hybrid = hybrid_mesh_shapes(shape, n_slices) if n_slices > 1 else None
    if n_slices > 1 and hybrid is None:
        # neither DCN-tolerant axis (data, pipe) can absorb the slice
        # count: the mesh is still legal, but model/seq collectives will
        # cross slices — build it, loudly
        log.warning(
            "mesh %s cannot place the %d-slice DCN factor on the data or "
            "pipe axis; latency-critical collectives may cross DCN",
            dict(zip(AXES, shape)), n_slices)
    if hybrid is None:
        return row_major
    try:
        return hybrid_rank_grid(*hybrid, slices)
    except ValueError as exc:
        # never silent: the row-major fallback may put model/seq groups
        # across slices
        log.warning(
            "topology-aware mesh layout failed (%s); falling back to "
            "enumeration order — MULTISLICE topology: per-step collectives "
            "may cross DCN", exc)
        return row_major


def host_slices() -> list[SliceTag]:
    """Every rank of the default group tagged with its host's slice: the
    index of its hostname among the group's distinct hostnames, in rank
    order (one all-gather of the names over the host group)."""
    from dist_mnist_tpu_torch.cluster import coordination

    world = device_count()
    if world == 1:
        return [SliceTag(0, 0)]
    ctx = coordination.context()
    names: list = [None] * world
    torch.distributed.all_gather_object(
        names, socket.gethostname(),
        group=ctx.host_group if ctx is not None else None)
    index: dict = {}
    for name in names:
        index.setdefault(name, len(index))
    return [SliceTag(r, index[name]) for r, name in enumerate(names)]


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
              device: torch.device | str | None = None,
              slices: Sequence[SliceTag] | None = None) -> Mesh:
    """The mesh `spec` names over the ranks of the default process group
    (one rank when there is none). Every rank of the group calls it with
    the same spec and `slices`: the first call for a grid creates the
    axes' subgroups (`coordination.mesh_groups`). `slices` tags every rank
    with its slice (`with_fake_slices`); by default each host is a slice
    (`host_slices`). More than one slice lays the ranks out as the
    reference's hybrid mesh (module docstring).

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
    resolved = spec.resolve(n)
    shape = dict(zip(AXES, resolved))
    ctx = coordination.context()
    if device is None:
        device = ctx.device if ctx is not None else torch.device("cpu")
    if slices is not None and len(slices) != n:
        raise ValueError(f"{len(slices)} slice tags for a group of {n} "
                         "ranks: tag every rank")
    grid = rank_grid(resolved, host_slices() if slices is None else slices)
    if n == 1:
        return Mesh(shape=shape, device=torch.device(device), grid=grid)
    groups = coordination.mesh_groups(grid)
    d, m, s, p = (int(i) for i in np.argwhere(
        grid == torch.distributed.get_rank())[0])
    return Mesh(shape=shape, rank=d, model_index=m, seq_index=s,
                pipe_index=p, device=torch.device(device), grid=grid,
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
    """Refuse a mesh whose ranks do not match its groups or grid."""
    if sorted(np.asarray(mesh.grid).reshape(-1).tolist()) != list(
            range(mesh.ranks)):
        raise ValueError("mesh grid does not hold every rank once")
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
