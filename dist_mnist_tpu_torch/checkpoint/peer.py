"""Peer-replicated shards: elastic recovery at local-disk speed (port of
the reference `checkpoint/peer.py`).

A shrink restores a dead host's shards from the checkpoint STORE, and the
disk round-trip dominates its recovery. Every host already holds its
part of the state in memory, so each host also keeps a REPLICA of its
ring neighbor's shards (`ring_peer` over cluster/membership.py host ids),
and a shrink restores the dead host's shards from the surviving peer
instead of the store — falling back to the store when the peer died with
it.

A host is a rank (a stated departure: the port runs one device per
process, so a host's addressable shards are its rank's own slices, as
`cluster/mesh.py` takes a host for a slice). Its stable id is
``DIST_MNIST_TPU_HOST_ID``, which the elastic supervisor sets, else its
rank.

Layout (this repo models "host h's local disk" as ``<root>/h<h>/``; in a
real fleet the replica write is a neighbor-to-neighbor send):

    <root>/h<holder>/s<src>/step_<N>.peer

``holder`` is whose disk it is, ``src`` is whose shards the file holds —
each host pushes its own shards to its own dir AND its ring peer's. A
file is an 8-byte little-endian header length, a JSON header, then the
raw bytes of every piece (64-byte aligned): the header gives the step,
the generator's state, the crc32 of the bytes, and every leaf's path,
FULL shape and dtype with the ``[start, stop)`` span per dim of each
piece this host holds (its FSDP and TP slices, `parallel/sharding.py`)
and where its bytes lie. Raw bytes under a dtype name round-trip every
dtype the state holds, bf16 included, and read back as views of one
buffer (no zip or pickle to undo). The atomic rename into place IS the
commit marker: readers only ever see complete files, and a kill
mid-write leaves a ``.tmp-<pid>`` that no restore considers; a file
whose bytes fail the crc32 is unreadable, and the restore falls back. A restore assembles every source host's pieces from
dirs whose holder is ALIVE (``DIST_MNIST_TPU_ALIVE_HOSTS``, stamped per
generation by the elastic supervisor), checks full element coverage per
leaf, and re-shards the result under the target's placement; any gap —
peer and owner both gone, partial write set, a src that never wrote —
returns None and the caller falls back to the store.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import zlib
from pathlib import Path

import torch

from dist_mnist_tpu_torch.cluster.membership import ENV_ALIVE_HOSTS, ring_peer
from dist_mnist_tpu_torch.cluster.mesh import DATA_AXIS, MODEL_AXIS
from dist_mnist_tpu_torch.parallel.sharding import (
    full_template,
    path_str,
    shard_train_state,
)
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

log = logging.getLogger(__name__)

#: in-flight atomic-write temp files (a pending entry after a test means
#: a write path skipped its finally)
_PENDING_TMP: set = set()

#: a peer file's name ends in this; its pieces' bytes are aligned to
#: _ALIGN bytes
SUFFIX = ".peer"
_ALIGN = 64
#: the parts of a TrainState a peer file holds, in its key order
_PARTS = ("params", "model_state", "opt_state")
#: the axes a leaf may be split over, narrowed in this order
#: (`parallel.sharding.shard_tree`)
_AXES = (MODEL_AXIS, DATA_AXIS)


def alive_hosts_from_env(default=None) -> list[int] | None:
    """The supervisor-stamped alive-host list; `default` when the env is
    absent (single-generation runs outside the supervisor)."""
    raw = os.environ.get(ENV_ALIVE_HOSTS)
    if not raw:
        return default
    try:
        return sorted({int(tok) for tok in raw.split(",") if tok.strip()})
    except ValueError:
        log.warning("unparseable %s=%r; ignoring", ENV_ALIVE_HOSTS, raw)
        return default


def _leaves(state) -> list[tuple[str, torch.Tensor]]:
    """[(path, tensor)] of the state's params, model state and optimizer
    state, paths prefixed with their part."""
    out = []
    for part in _PARTS:
        for path, leaf in flatten_with_path(getattr(state, part)):
            if isinstance(leaf, torch.Tensor):
                out.append((path_str((part, *path)), leaf))
    return out


def _spans(leaf: torch.Tensor, spec, mesh) -> tuple[list[int], list]:
    """(the full leaf's shape, [[start, stop], ...] per dim of this rank's
    slice of it): `shard_tree`'s narrowing, the model dim first, then
    data. A leaf no axis splits is its own full leaf."""
    splits = [] if spec is None else [
        (spec.dim(axis), mesh.shape[axis], mesh.axis_index(axis))
        for axis in _AXES
        if spec.dim(axis) is not None and mesh.shape[axis] > 1]
    full = list(leaf.shape)
    for d, ranks, _ in splits:
        full[d] *= ranks
    spans = [[0, n] for n in full]
    for d, ranks, index in splits:
        n = (spans[d][1] - spans[d][0]) // ranks
        spans[d] = [spans[d][0] + index * n, spans[d][0] + (index + 1) * n]
    return full, spans


class PeerReplicator:
    """Serialize THIS host's shards to its own dir and its ring peer's;
    assemble any host set's shards back on restore."""

    def __init__(self, root: str | Path, host_id: int, hosts, *,
                 max_to_keep: int = 5):
        self.root = Path(root).absolute()
        self.host_id = int(host_id)
        self.hosts = sorted({int(h) for h in hosts})
        self.peer = ring_peer(self.host_id, self.hosts)
        self.max_to_keep = max(1, int(max_to_keep))

    # -- write side ---------------------------------------------------------

    def write(self, step: int, state, placement=None) -> None:
        """Serialize this host's slices of `state` at `step` to its own
        disk and the ring peer's. `placement` (the state's, which a fork
        may have dropped) says which leaves are slices. Runs on the
        snapshot writer thread: the host copy happens here, off the loop."""
        data = self._serialize(step, state, placement or state.placement)
        holders = [self.host_id] if self.peer is None else [
            self.host_id, self.peer]
        for holder in holders:
            d = self.root / f"h{holder}" / f"s{self.host_id}"
            d.mkdir(parents=True, exist_ok=True)
            final = d / f"step_{int(step)}{SUFFIX}"
            tmp = d / f"step_{int(step)}{SUFFIX}.tmp-{os.getpid()}"
            _PENDING_TMP.add(tmp)
            try:
                tmp.write_bytes(data)
                os.replace(tmp, final)
            finally:
                _PENDING_TMP.discard(tmp)
                tmp.unlink(missing_ok=True)
            self._prune(d)

    def _serialize(self, step: int, state, placement) -> bytes:
        specs = mesh = None
        if placement is not None:
            mesh = placement.mesh
            specs = {}
            for part in _PARTS:
                for path, spec in flatten_with_path(
                        getattr(placement.specs, part)):
                    specs[path_str((part, *path))] = spec
        leaves, chunks, offset = [], [], 0
        for path, leaf in _leaves(state):
            full, spans = _spans(
                leaf, None if specs is None else specs.get(path), mesh)
            raw = _raw_bytes(leaf)
            leaves.append({"path": path, "shape": full,
                           "dtype": str(leaf.dtype).removeprefix("torch."),
                           "pieces": [{"start": [a for a, _ in spans],
                                       "stop": [b for _, b in spans],
                                       "offset": offset,
                                       "nbytes": len(raw)}]})
            chunks.append(raw)
            offset += len(raw)
            chunks.append(bytes(-offset % _ALIGN))
            offset += len(chunks[-1])
        rng = _raw_bytes(state.rng.get_state())
        chunks.append(rng)
        blob = b"".join(chunks)
        header = json.dumps({
            "step": int(step), "crc32": zlib.crc32(blob),
            "rng": {"device": state.rng.device.type, "offset": offset,
                    "nbytes": len(rng)},
            "leaves": leaves}).encode("utf-8")
        return len(header).to_bytes(8, "little") + header + blob

    def _prune(self, d: Path) -> None:
        steps = sorted((n, f) for f in d.iterdir()
                       if (n := _step_of(f.name, "step_", SUFFIX)) is not None)
        for _, f in steps[:-self.max_to_keep]:
            f.unlink(missing_ok=True)

    # -- read side ----------------------------------------------------------

    def restore(self, target_state, *, alive=None, min_step=None):
        return restore_from_peers(self.root, target_state, alive=alive,
                                  min_step=min_step)


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes in row-major order (any dtype, bf16 included)."""
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def _read(f: Path) -> tuple[dict, torch.Tensor]:
    """(header, the data bytes as a uint8 tensor) of a peer file; raises
    ValueError when the bytes fail the header's crc32."""
    raw = f.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    if zlib.crc32(data) != header["crc32"]:
        raise ValueError(f"{f.name}: crc32 mismatch")
    return header, torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _piece(blob: torch.Tensor, piece: dict, dtype: str) -> torch.Tensor:
    """A piece's tensor: a view of `blob` (its offset is `_ALIGN`-byte
    aligned, as a view of another dtype needs), shaped by its span."""
    shape = [b - a for a, b in zip(piece["start"], piece["stop"])]
    raw = blob[piece["offset"]:piece["offset"] + piece["nbytes"]]
    return raw.view(getattr(torch, dtype)).reshape(shape)


def _step_of(name: str, prefix: str, suffix: str) -> int | None:
    """N of ``<prefix>N<suffix>``, or None for any other name."""
    if not (name.startswith(prefix) and name.endswith(suffix)):
        return None
    digits = name[len(prefix):len(name) - len(suffix)]
    return int(digits) if digits.isdigit() else None


def _scan(root: Path) -> dict:
    """{step: {src: [readable file, ...]}} over the whole peer root (a
    directory walk: a temp file's name does not end in the suffix)."""
    out: dict = {}
    for holder_dir in root.iterdir():
        if _step_of(holder_dir.name, "h", "") is None:
            continue
        for src_dir in holder_dir.iterdir():
            src = _step_of(src_dir.name, "s", "")
            if src is None:
                continue
            for f in src_dir.iterdir():
                step = _step_of(f.name, "step_", SUFFIX)
                if step is not None:
                    out.setdefault(step, {}).setdefault(src, []).append(f)
    return out


def restore_from_peers(root: str | Path, target_state, *, alive=None,
                       min_step: int | None = None):
    """Assemble the freshest fully covered step from alive holders' dirs
    into `target_state`'s structure, dtypes, devices and placement.

    Returns ``(state, step, sources)`` — sources maps src host -> the
    holder dir its pieces were read from — or None when no step at or
    above `min_step` has full element coverage from alive holders (the
    caller then falls back to the checkpoint store). `alive` is a host-id
    collection; the default comes from DIST_MNIST_TPU_ALIVE_HOSTS, else
    every holder dir present counts as reachable."""
    root = Path(root).absolute()
    if not root.exists():
        return None
    if alive is None:
        alive = alive_hosts_from_env()
    catalog = _scan(root)
    if alive is not None:
        alive = {int(h) for h in alive}
        for by_src in catalog.values():
            for src in list(by_src):
                by_src[src] = sorted(
                    f for f in by_src[src]
                    if int(f.parent.parent.name[1:]) in alive)
    for step in sorted(catalog, reverse=True):
        if min_step is not None and step < min_step:
            break  # staler than the store's frontier: not worth assembling
        by_src = {s: sorted(fs) for s, fs in catalog[step].items() if fs}
        if not by_src:
            continue
        got = _assemble(by_src, target_state)
        if got is not None:
            state, sources = got
            return state, step, sources
    return None


def _assemble(by_src: dict, target_state):
    """The full state filled from per-source files, placed as
    `target_state`; None unless every element of every leaf is covered.
    Sources are read in host order until every leaf is covered (a leaf
    no axis splits is whole in each source's file: the first one read
    serves it, with no copy)."""
    template = full_template(target_state)  # full shapes, no collective
    targets = dict(_leaves(template))
    bufs: dict = {}   # path -> full tensor (a whole piece, or filled)
    masks: dict = {}  # path -> coverage of a buffer filled from slices
    covered: set = set()
    sources, head = {}, None
    for src, files in sorted(by_src.items()):
        if len(covered) == len(targets):
            break
        f = files[0]
        try:
            payload, blob = _read(f)
            for leaf in payload["leaves"]:
                p = leaf["path"]
                if p not in targets or p in covered:
                    continue  # structure drift (an extra leaf), or served
                want = targets[p]
                if (list(want.shape) != list(leaf["shape"]) or
                        str(want.dtype).removeprefix("torch.")
                        != leaf["dtype"]):
                    log.warning("peer shard %s is %s %s, the target %s %s; "
                                "falling back to the store", p,
                                leaf["dtype"], leaf["shape"], want.dtype,
                                list(want.shape))
                    return None
                for piece in leaf["pieces"]:
                    data = _piece(blob, piece, leaf["dtype"])
                    if list(data.shape) == list(want.shape):
                        bufs[p] = data
                        covered.add(p)
                        break
                    if p not in masks:
                        bufs[p] = torch.empty(want.shape, dtype=want.dtype)
                        masks[p] = torch.zeros(want.shape, dtype=torch.bool)
                    idx = tuple(slice(a, b) for a, b in
                                zip(piece["start"], piece["stop"]))
                    bufs[p][idx] = data
                    masks[p][idx] = True
                if p in masks and bool(masks[p].all()):
                    covered.add(p)
        except (OSError, RuntimeError, KeyError, ValueError,
                TypeError) as err:
            log.warning("unreadable peer file %s (%s: %s)", f,
                        type(err).__name__, str(err)[:200])
            return None
        sources[src] = f.parent.parent.name
        if head is None:
            head = payload
            r = payload["rng"]
            head["rng"]["state"] = blob[r["offset"]:
                                        r["offset"] + r["nbytes"]].clone()
    missing = sorted(set(targets) - covered)
    if missing:
        mask = masks.get(missing[0])
        log.info("peer restore incomplete: leaf %s covered %.1f%%",
                 missing[0], 0.0 if mask is None
                 else 100.0 * float(mask.float().mean()))
        return None
    if head["rng"]["device"] != target_state.rng.device.type:
        log.warning("peer files hold a %s generator, the target a %s one; "
                    "falling back to the store", head["rng"]["device"],
                    target_state.rng.device.type)
        return None

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, (*prefix, k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, (*prefix, i)) for i, v in enumerate(tree)]
            return (type(tree)(*vals) if hasattr(tree, "_fields")
                    else type(tree)(vals))
        if isinstance(tree, torch.Tensor):
            return bufs[path_str(prefix)].to(tree.device)
        return tree

    rng = torch.Generator(device=target_state.rng.device)
    rng.set_state(head["rng"]["state"])
    step = template.step
    full = dataclasses.replace(
        template,
        step=torch.tensor(int(head["step"]), dtype=step.dtype,
                          device=step.device),
        **{part: rebuild(getattr(template, part), (part,))
           for part in _PARTS},
        rng=rng, placement=None)
    placement = target_state.placement
    if placement is not None:
        full = shard_train_state(full, placement.mesh, placement.rules)
    return full, sources
