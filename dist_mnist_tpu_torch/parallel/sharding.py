"""Placement rules: data parallelism, FSDP, Megatron tensor parallelism
and FSDP composed with it (port of the reference `parallel/sharding.py`).

A placement is a `P` per leaf: ``P()`` replicated on every rank,
``P(None, "data")`` split along dim 1 over the ``data`` axis,
``P(None, "data", "model")`` split along dim 1 over ``data`` and dim 2
over ``model``. Under DP every leaf is replicated. Under FSDP (ZeRO)
every float param leaf is split along its largest dim that the number of
ranks divides (`_fsdp_compose`, the reference's rule, picking the same
dim since the port keeps the reference's HWIO and ``[in, out]``
layouts). `TP_RULES` are the reference's regexes letter for letter: the
column-parallel kernels and biases (``qkv``, ``mlp_in``, ``fc1``) split
their output dim over ``model``, the row-parallel kernels (``attn/out``,
``mlp_out``, ``fc2``) their input dim, right-aligned on stacked
``[depth, ...]`` leaves; `FSDP_TP_RULES` put ``model`` first and then
``data`` on the largest remaining free dim. Each optimizer slot inherits
its param's placement (`derive_state_specs`), through `chain` and
gradient accumulation.

A sharded leaf keeps only its local slice on each rank (1/model of a
tensor-parallel dim, then 1/data of an FSDP dim): `shard_train_state`
narrows a full state, and the state carries a `Placement` saying which
leaves are slices and along which dims, for the step (all-gather over
``data`` before the forward, reduce-scatter of the gradients; the
``model`` slices stay local, the model's Megatron operators handle
them), the checkpoint manager (gathers over both axes before the chief
writes) and `reshard_state`.

No rule names the ``seq`` axis: on a mesh with one (sequence
parallelism) every leaf is replicated over it, so each seq rank holds
the same params and optimizer state, and the step sums their gradients
over seq (`train/step.py`).
"""

from __future__ import annotations

import dataclasses
import re

import torch

from dist_mnist_tpu_torch.cluster.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from dist_mnist_tpu_torch.parallel import collectives
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, map_with_path

#: the axes a leaf may be split over, in the order a slice is taken
#: (model first, then data) and undone in reverse
_AXES = (MODEL_AXIS, DATA_AXIS)


class P:
    """A leaf's placement: one entry per dim, an axis name or None
    (`jax.sharding.PartitionSpec`'s meaning; ``tuple(p)`` lists them)."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"

    def dim(self, axis: str = DATA_AXIS) -> int | None:
        """The dim split over `axis`, or None."""
        return self.axes.index(axis) if axis in self.axes else None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (regex, axes) rules, first match wins, default replicated;
    `fsdp_axis` adds the FSDP shape rule on top (see the module
    docstring)."""

    rules: tuple[tuple[str, tuple], ...] = ()
    fsdp_axis: str | None = None

    def spec_for(self, path: str, ndim: int) -> P:
        for pattern, axes in self.rules:
            if re.search(pattern, path):
                if len(axes) > ndim:  # rule doesn't fit (e.g. bias)
                    axes = axes[-ndim:] if ndim else ()
                pad = (None,) * (ndim - len(axes))
                return P(*(pad + tuple(axes)))
        return P()

    def leaf_spec(self, path: str, leaf, mesh: Mesh) -> P:
        """Full per-leaf placement: regex spec, then the FSDP shape rule."""
        spec = self.spec_for(path, getattr(leaf, "ndim", 0))
        if self.fsdp_axis:
            spec = _fsdp_compose(spec, leaf, mesh.shape[self.fsdp_axis],
                                 self.fsdp_axis)
        return spec

    def match_count(self, tree, mesh: Mesh | None = None) -> int:
        """How many leaves of `tree` this strategy places (0 on an empty
        rule set); the FSDP shape rule needs the `mesh`."""
        n = 0
        for path, leaf in _paths(tree):
            base = self.spec_for(path, getattr(leaf, "ndim", 0))
            if any(re.search(pattern, path) for pattern, _ in self.rules):
                n += 1
            elif (self.fsdp_axis and mesh is not None
                  and _fsdp_compose(base, leaf, mesh.shape[self.fsdp_axis],
                                    self.fsdp_axis) != base):
                n += 1
        return n


def _fsdp_compose(spec: P, leaf, axis_size: int, axis_name: str) -> P:
    """`spec` with `axis_name` on the largest free dim of `leaf` that
    `axis_size` divides (ties: the first), or `spec` unchanged when none
    does. Float leaves only: integer counters are never split."""
    shape = tuple(getattr(leaf, "shape", ()))
    dtype = getattr(leaf, "dtype", None)
    if not shape or not isinstance(dtype, torch.dtype) \
            or not dtype.is_floating_point:
        return spec
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    if axis_name in entries:
        return spec
    best = -1
    for i, (dim, taken) in enumerate(zip(shape, entries)):
        if taken is None and dim % axis_size == 0 and dim > 1:
            if best < 0 or dim > shape[best]:
                best = i
    if best < 0:
        return spec
    return P(*(entries[:best] + (axis_name,) + entries[best + 1:]))


#: pure data parallelism: every leaf replicated
DP_RULES = ShardingRules()
#: Megatron TP (the reference's regexes): column-parallel qkv / mlp_in /
#: fc1 (output dim over `model`, their biases too), row-parallel
#: attn/out / mlp_out / fc2 (input dim over `model`; their biases stay
#: replicated, added after the reduce)
TP_RULES = ShardingRules(
    rules=(
        (r"(qkv|mlp_in|fc1)/w$", (None, MODEL_AXIS)),
        (r"(qkv|mlp_in|fc1)/b$", (MODEL_AXIS,)),
        (r"(attn/out|mlp_out|fc2)/w$", (MODEL_AXIS, None)),
    )
)
#: ZeRO/FSDP: params and optimizer slots sharded over `data`
FSDP_RULES = ShardingRules(fsdp_axis=DATA_AXIS)
#: FSDP composed with Megatron TP: `model` from the regexes first, then
#: `data` on the largest remaining free dim
FSDP_TP_RULES = ShardingRules(rules=TP_RULES.rules, fsdp_axis=DATA_AXIS)


def resolve_rules(name: str) -> ShardingRules:
    """Config string -> rules (`Config.sharding_rules`)."""
    table = {"dp": DP_RULES, "tp": TP_RULES, "fsdp": FSDP_RULES,
             "fsdp_tp": FSDP_TP_RULES}
    if name not in table:
        raise ValueError(f"unknown sharding_rules {name!r}; use 'dp' | "
                         "'tp' | 'fsdp' | 'fsdp_tp'")
    return table[name]


def rules_name(rules: ShardingRules) -> str:
    """The config string of a rule set (`resolve_rules`'s inverse)."""
    for name in ("dp", "tp", "fsdp", "fsdp_tp"):
        if resolve_rules(name) == rules:
            return name
    return "custom"


def _seg(k) -> str:
    return f"[{k}]" if isinstance(k, int) else str(k)


def path_str(path: tuple) -> str:
    """The reference's path string for a key path: dict keys joined by
    ``/``, container positions as ``[i]``."""
    return "/".join(_seg(k) for k in path)


def _paths(tree) -> list[tuple[str, object]]:
    return [(path_str(p), leaf) for p, leaf in flatten_with_path(tree)]


@dataclasses.dataclass
class StateSpecs:
    """A `P` tree per part of a `TrainState` (the reference returns a
    TrainState of specs)."""

    step: P
    params: object
    model_state: object
    opt_state: object
    rng: P


def derive_state_specs(state, mesh: Mesh, rules: ShardingRules) -> StateSpecs:
    """Placement of every leaf of a full (unsharded) `state`: params by
    `rules`; each optimizer leaf inherits the spec of the param it
    mirrors, matched by path suffix and shape (Adam's m/v, chained
    states, the accumulation buffer), else the regex rules; model state,
    step and generator by the regex rules alone (the FSDP shape rule never
    touches BN statistics)."""
    params = _paths(state.params)
    by_len = sorted(params, key=lambda kv: -len(kv[0]))
    param_specs = {p: rules.leaf_spec(p, v, mesh) for p, v in params}

    def inherited(path: str, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        for ppath, pleaf in by_len:
            if (path.endswith("/" + ppath)
                    and tuple(getattr(pleaf, "shape", ())) == shape):
                return param_specs[ppath]
        return None

    def opt_spec(path, leaf):
        full = "opt_state/" + path_str(path)
        spec = inherited(full, leaf)
        return spec if spec is not None else rules.spec_for(
            full, getattr(leaf, "ndim", 0))

    return StateSpecs(
        step=P(),
        params=map_with_path(lambda p, v: param_specs[path_str(p)],
                             state.params),
        model_state=map_with_path(
            lambda p, v: rules.spec_for("model_state/" + path_str(p),
                                        getattr(v, "ndim", 0)),
            state.model_state),
        opt_state=map_with_path(opt_spec, state.opt_state),
        rng=P(),
    )


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a `TrainState`'s leaves live: the mesh, the rules, and the
    specs derived from the FULL shapes."""

    mesh: Mesh
    rules: ShardingRules
    specs: StateSpecs

    def sharded_on(self, axis: str) -> bool:
        """Does any leaf hold a slice over `axis`?"""
        return self.mesh.shape[axis] > 1 and any(
            s.dim(axis) is not None for part in ("params", "opt_state")
            for _, s in flatten_with_path(getattr(self.specs, part)))

    @property
    def sharded(self) -> bool:
        """Does any leaf hold a slice?"""
        return any(self.sharded_on(axis) for axis in _AXES)


def _sharded_leaves(tree, spec_tree, axis: str = DATA_AXIS):
    """[(path, leaf, dim)] for each leaf of `tree` whose spec splits it
    over `axis`."""
    specs = dict(flatten_with_path(spec_tree))
    return [(path, leaf, specs[path].dim(axis))
            for path, leaf in flatten_with_path(tree)
            if specs[path].dim(axis) is not None]


def replicated_leaves(tree, spec_tree, axes=_AXES) -> dict:
    """``{path: leaf}`` of the leaves of `tree` that no axis of `axes`
    splits: every rank of those axes' groups holds the same bits of them
    (``axes=("model",)``: the leaves every rank of a model group holds
    alike, FSDP slices included)."""
    specs = dict(flatten_with_path(spec_tree))
    return {path: leaf for path, leaf in flatten_with_path(tree)
            if all(specs[path].dim(a) is None for a in axes)}


def shard_tree(tree, spec_tree, mesh: Mesh):
    """`tree` (full leaves, identical on every rank) with each sharded
    leaf narrowed to this rank's contiguous slice (its own memory): its
    ``model`` dim to this rank's model index, then its ``data`` dim to
    its data index."""
    specs = dict(flatten_with_path(spec_tree))

    def one(path, leaf):
        out = leaf
        for axis in _AXES:
            d, ranks = specs[path].dim(axis), mesh.shape[axis]
            if d is None or ranks == 1:
                continue
            n = out.shape[d] // ranks
            out = out.narrow(d, mesh.axis_index(axis) * n, n)
        if out is leaf:
            return leaf
        return out.clone(memory_format=torch.contiguous_format)

    return map_with_path(one, tree)


def gather_tree(tree, spec_tree, mesh: Mesh, axes=(DATA_AXIS, MODEL_AXIS)):
    """`tree` with every leaf sharded over `axes` all-gathered over them,
    ``data`` first (one collective per axis for the whole tree; every
    rank of the axis must call it). The step gathers the ``data`` axis
    alone: the tensor-parallel slices stay local."""
    for axis in _AXES[::-1]:
        if axis not in axes or mesh.shape[axis] == 1:
            continue
        sharded = _sharded_leaves(tree, spec_tree, axis)
        if not sharded:
            continue
        full = collectives.gather_leaves([leaf for _, leaf, _ in sharded],
                                         [d for _, _, d in sharded], mesh,
                                         axis)
        by_path = {path: f for (path, _, _), f in zip(sharded, full)}
        tree = map_with_path(lambda p, leaf, b=by_path: b.get(p, leaf), tree)
    return tree


def _check_matches(state, mesh: Mesh, rules: ShardingRules) -> None:
    if (rules.rules or rules.fsdp_axis) and \
            rules.match_count(state.params, mesh) == 0:
        what = (tuple(p for p, _ in rules.rules)
                or f"fsdp over axis {rules.fsdp_axis!r}")
        raise ValueError(
            f"sharding rules {what} matched no parameter path — the model "
            "would silently train fully replicated (DP) under this "
            "strategy's name. Pick rules that match this model's params, "
            "or use DP_RULES explicitly.")


def shard_train_state(state, mesh: Mesh, rules: ShardingRules = DP_RULES):
    """The FULL `state` (identical on every rank: same seed, same init)
    placed by `rules`: sharded leaves narrowed to this rank's slice, and
    the `Placement` attached. Refuses a non-trivial rule set that matches
    no parameter, as the reference does."""
    _check_matches(state, mesh, rules)
    specs = derive_state_specs(state, mesh, rules)
    return dataclasses.replace(
        state,
        params=shard_tree(state.params, specs.params, mesh),
        opt_state=shard_tree(state.opt_state, specs.opt_state, mesh),
        placement=Placement(mesh, rules, specs))


def unshard_state(state):
    """The full state of a placed `state`: every sharded leaf gathered
    (collective: every rank calls it). The placement is dropped."""
    placement = state.placement
    if placement is None:
        return state
    mesh, specs = placement.mesh, placement.specs
    return dataclasses.replace(
        state,
        params=gather_tree(state.params, specs.params, mesh),
        opt_state=gather_tree(state.opt_state, specs.opt_state, mesh),
        placement=None)


def reshard_state(state, mesh: Mesh, rules: ShardingRules = DP_RULES):
    """Move a placed `state` onto `mesh` under `rules`: gather what its
    current placement split, then shard for the new one. Values are
    kept bit for bit."""
    return shard_train_state(unshard_state(state), mesh, rules)


def full_template(state):
    """A state shaped like the FULL version of placed `state` (sharded
    leaves as uninitialized tensors of their full shape, on their device;
    no collective): the structure a checkpoint restores into."""
    placement = state.placement
    if placement is None or not placement.sharded:
        return state
    mesh = placement.mesh

    def widen(tree, spec_tree):
        specs = dict(flatten_with_path(spec_tree))

        def one(path, leaf):
            shape = list(leaf.shape)
            for axis in _AXES:
                d = specs[path].dim(axis)
                if d is not None:
                    shape[d] *= mesh.shape[axis]
            if shape == list(leaf.shape):
                return leaf
            return leaf.new_empty(shape)

        return map_with_path(one, tree)

    return dataclasses.replace(
        state, params=widen(state.params, placement.specs.params),
        opt_state=widen(state.opt_state, placement.specs.opt_state),
        placement=None)
