"""Checkpointing of the `TrainState` (port of the reference
`checkpoint/manager.py`), in torch's own file format.

Reference mapping (SURVEY.md §3.5): graph-embedded SaveV2/RestoreV2
(saver.py:233-312, 1186), the `checkpoint` state proto that tracked the
latest step (checkpoint_management.py:176), and
`SessionManager.prepare_session`'s auto-restore (:186-257). The reference
package writes orbax step directories; this one writes:

    <dir>/<step>/state.pt     torch.save of plain dicts, lists, tuples and
                              tensors ({"step", "params", "model_state",
                              "opt_state", "rng"}), so that
                              torch.load(weights_only=True) reads it
    <dir>/<step>/meta.json    every leaf's key path, shape and dtype, the
                              generator's device type, and the crc32 of
                              state.pt: the counterpart of orbax's tree
                              metadata, read without loading arrays
    <dir>/commits/<step>.committed
    <dir>/quarantine/step_<N>/

A step is written into ``<dir>/<step>.tmp-<pid>/``, each file fsynced,
then renamed to ``<dir>/<step>/`` (`os.replace`) and the parent fsynced.
`rng` is ``{"state": TrainState.rng.get_state(), "device": <type>}``;
restore sets that state on a `torch.Generator` of the target's device,
so the draws after a restore continue the uninterrupted run's.

Crash consistency: a step directory is RESTORE-ELIGIBLE only once its
commit marker lands (tmp file + `os.replace`, after the write is known
durable): at once on the sync path; on the async path when
`flush_commits()` sees the writer finished, or at the next `save()` /
`wait()`. A kill mid-write leaves a tmp directory or a step directory
with no marker; `restore()` quarantines the latter without spending a
fallback, and `latest_step()` never reports it. A directory that
predates the protocol (steps, no ``commits/``) is adopted on open.

Async save: `save()` first waits for the previous write (as orbax does),
then copies the state to host memory before it returns, so no later
update reaches the saved copy, and a ``SnapshotWriter-<step>`` thread
writes the files. The write-behind layer over this manager
(`checkpoint/snapshot.py` `AsyncSnapshotter`, with the peer ring of
`checkpoint/peer.py`) keeps the collective half of `save` (`agree`, the
gather) on the loop thread and calls the collective-free half,
`write_full`, from its writer thread.

Several ranks (`cluster/coordination.py`): every rank constructs the
manager and calls `save` at the same steps. The chief decides whether a
save happens and every rank takes that decision (`coordination.agree`);
each FSDP- or TP-sharded leaf is all-gathered to its full shape (over
the data axis, then the model axis), so the file, its `meta.json` shapes
and its markers are those one rank writes; only the chief writes,
quarantines and applies retention; the others wait at a barrier on open
and on close. Every rank restores the full file and re-shards it under
the target's placement (`parallel/sharding.py`), so a DP checkpoint
restores under FSDP, TP or FSDP x TP and back.
"""

from __future__ import annotations

import dataclasses
import errno
import io
import json
import logging
import os
import pickle
import re
import shutil
import threading
import time
import zlib
from pathlib import Path

import torch

from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.parallel.sharding import (
    full_template,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
META_FILE = "meta.json"

#: messages of torch's zip reader that mean the bytes are damaged
_ZIP_READER_MARKERS = (
    "pytorchstreamreader failed",
    "failed finding central directory",
    "invalid header or archive is corrupted",
)


class StructureMismatch(ValueError):
    """The checkpoint's tree and the restore target's differ (a key, a
    container length, a shape or a dtype). Structural, never corruption:
    it would fail the same way on every older step."""


def _is_read_corruption(err: Exception) -> bool:
    """Does `err` mean an UNREADABLE payload (truncated, missing or
    mangled files) rather than a structure mismatch or a logic error?
    This gates the restore FALLBACK ladder, which only makes sense for
    damage local to one step directory.

    By type: `EOFError` and `OSError` (the storage layer failed; a crc32
    mismatch is raised as ``OSError(EIO)``), `pickle.UnpicklingError`, a
    `UnicodeDecodeError` out of the unpickler and a `json.JSONDecodeError`
    out of meta.json. By message: the `RuntimeError`s of torch's zip
    reader (`_ZIP_READER_MARKERS`). `StructureMismatch` never is."""
    if isinstance(err, StructureMismatch):
        return False
    if isinstance(err, (EOFError, OSError, pickle.UnpicklingError,
                        UnicodeDecodeError, json.JSONDecodeError)):
        return True
    if isinstance(err, RuntimeError):
        msg = str(err).lower()
        return any(m in msg for m in _ZIP_READER_MARKERS)
    return False


# -- the saved tree -----------------------------------------------------------

def _host_copy(tree):
    """`tree` with every tensor copied to host memory (dicts, lists and
    tuples kept; a namedtuple becomes a plain tuple)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_host_copy(v) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).contiguous()
    return tree


def _meta_tree(tree):
    """The tree's structure with each tensor as ``{"leaf": true, "shape",
    "dtype"}`` (tuples become JSON lists)."""
    if isinstance(tree, dict):
        return {str(k): _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return {"leaf": True, "shape": list(tree.shape),
                "dtype": str(tree.dtype).removeprefix("torch.")}
    return {"leaf": True, "value": tree}


def _is_meta_leaf(node) -> bool:
    return isinstance(node, dict) and node.get("leaf") is True


def _meta_paths(node, path=()) -> set[str]:
    if _is_meta_leaf(node):
        return {"/".join(path)}
    if isinstance(node, dict):
        return set().union(*(_meta_paths(v, (*path, k))
                             for k, v in node.items())) if node else set()
    if isinstance(node, list):
        return set().union(*(_meta_paths(v, (*path, str(i)))
                             for i, v in enumerate(node))) if node else set()
    return {"/".join(path)}


def _weights_trees(state) -> dict:
    return {"params": state.params, "model_state": state.model_state,
            "opt_state": state.opt_state}


def _rebuild(target, saved, path: str, device=None):
    """`saved` in `target`'s structure: the target's container types
    (tuples and namedtuples rebuilt from the target), each tensor checked
    against the target leaf's shape and dtype and moved to its device (or
    `device`). Raises `StructureMismatch` naming the first difference."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            have = sorted(saved) if isinstance(saved, dict) else type(saved)
            raise StructureMismatch(
                f"tree structure differs at {path or '/'}: checkpoint keys "
                f"{have}, target keys {sorted(target)}")
        return {k: _rebuild(v, saved[k], f"{path}/{k}", device)
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise StructureMismatch(
                f"tree structure differs at {path or '/'}: checkpoint has "
                f"{type(saved).__name__} of "
                f"{len(saved) if isinstance(saved, (list, tuple)) else '?'}"
                f", target {type(target).__name__} of {len(target)}")
        vals = [_rebuild(t, s, f"{path}/{i}", device)
                for i, (t, s) in enumerate(zip(target, saved))]
        if hasattr(target, "_fields"):
            return type(target)(*vals)
        return type(target)(vals)
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise StructureMismatch(f"{path}: checkpoint holds "
                                    f"{type(saved).__name__}, not a tensor")
        if tuple(saved.shape) != tuple(target.shape):
            raise StructureMismatch(
                f"{path}: shape {tuple(saved.shape)} in the checkpoint, "
                f"{tuple(target.shape)} in the target")
        if saved.dtype != target.dtype:
            raise StructureMismatch(f"{path}: dtype {saved.dtype} in the "
                                    f"checkpoint, {target.dtype} in the "
                                    "target")
        return saved.to(device if device is not None else target.device)
    return saved


def _strip_metric_state(state, keep=frozenset()):
    """(state without top-level `_metric` model_state entries — except
    those in `keep` — and the full metric key set). Those entries are
    additive health stats; a checkpoint written before a model grew them
    is still valid: restore without the ones it lacks and refill them
    from the target."""
    ms = state.model_state
    if not isinstance(ms, dict):
        return state, set()
    keys = {k for k in ms if isinstance(k, str) and k.endswith("_metric")}
    if not keys:
        return state, set()
    stripped = {k: v for k, v in ms.items() if k not in keys or k in keep}
    return dataclasses.replace(state, model_state=stripped), keys


def _refill_metric_state(restored, target_state):
    """Put back any `_metric` entries the healed restore omitted, using
    the target's (initial) values."""
    ms, tms = restored.model_state, target_state.model_state
    if not isinstance(ms, dict) or not isinstance(tms, dict):
        return restored
    missing = {k: v for k, v in tms.items()
               if isinstance(k, str) and k.endswith("_metric")
               and k not in ms}
    if not missing:
        return restored
    return dataclasses.replace(restored, model_state={**ms, **missing})


def _flip_block_layouts(state, probe_only: bool = False):
    """A copy of `state` with every ViT-block-layout dict (params and the
    optimizer slots that mirror them) converted to the OTHER layout by
    `models.vit.convert_block_layout`; None when the state holds no block
    layout. `probe_only=True` answers "would a flip apply?" without
    building the copy."""
    from dist_mnist_tpu_torch.models.vit import convert_block_layout

    found = False

    def is_block_dict(node):
        return isinstance(node, dict) and (
            "blocks" in node or any(
                isinstance(k, str) and re.fullmatch(r"block\d+", k)
                for k in node))

    def rec(node):
        nonlocal found
        if is_block_dict(node):
            found = True
            return node if probe_only else convert_block_layout(node)
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple):  # chained optimizer states
            vals = [rec(v) for v in node]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else tuple(vals))
        if isinstance(node, list):
            return [rec(v) for v in node]
        return node

    converted = (rec(state.params), rec(state.model_state),
                 rec(state.opt_state))
    if not found:
        return None
    if probe_only:
        return True
    return dataclasses.replace(state, params=converted[0],
                               model_state=converted[1],
                               opt_state=converted[2])


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durably(path: Path, write) -> None:
    with open(path, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())


class CheckpointManager:
    """Save/restore `TrainState` with retention, commit markers and an
    async write (see the module docstring for the layout).

    `max_to_keep` ≙ tf.train.Saver(max_to_keep=5).
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 5,
                 async_save: bool = True, max_restore_fallbacks: int = 1):
        # how many OLDER steps restore() may fall back to when the latest
        # is unreadable (each unreadable step is quarantined); 0 disables
        # the ladder and restores the strict propagate-first-error behavior
        self.max_restore_fallbacks = max_restore_fallbacks
        self.max_to_keep = max_to_keep
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._async = bool(async_save)
        self._last_saved: int | None = None
        # step -> dispatch time.monotonic() of saves whose marker hasn't
        # landed yet (async path)
        self._pending_commits: dict[int, float] = {}
        self._commits_dir = self.directory / "commits"
        # the writer thread's handoff: steps it made durable, its error
        self._lock = threading.Lock()
        self._written: set[int] = set()
        self._writer_error: BaseException | None = None
        self._thread: threading.Thread | None = None
        # only the chief writes, quarantines and prunes
        self._chief = coordination.is_chief()
        if self._chief:
            self._adopt_legacy_steps()
        # the others read the directory only once its adoption is done
        coordination.barrier()

    # -- the step directories -------------------------------------------------

    def all_steps(self) -> list[int]:
        """Every finalized step directory, committed or not, ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    # -- commit-marker protocol -----------------------------------------------

    def _adopt_legacy_steps(self) -> None:
        """First open of a pre-protocol directory (steps, no ``commits/``):
        mark every existing step committed — its writer waited for
        durability before exiting."""
        if self._commits_dir.exists():
            return
        self._commits_dir.mkdir(parents=True, exist_ok=True)
        for step in self.all_steps():
            self._write_marker(step)

    def _marker_path(self, step: int) -> Path:
        return self._commits_dir / f"{step}.committed"

    def _write_marker(self, step: int) -> None:
        tmp = self._commits_dir / f"{step}.committed.tmp-{os.getpid()}"
        tmp.write_text(json.dumps({"step": step}), encoding="utf-8")
        os.replace(tmp, self._marker_path(step))

    def _is_committed(self, step: int) -> bool:
        return (step in self._pending_commits
                or self._marker_path(step).exists())

    def _commit(self, step: int, dispatch_ts: float) -> None:
        self._write_marker(step)
        events.emit("checkpoint_commit", step=step,
                    dur_ms=round((time.monotonic() - dispatch_ts) * 1e3, 3))

    def _collect_writer(self, *, block: bool) -> None:
        """Join a finished (or, with `block`, the running) writer thread
        and re-raise its error, as orbax's wait surfaces a failed write."""
        t = self._thread
        if t is not None and (block or not t.is_alive()):
            t.join()
            self._thread = None
        with self._lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def flush_commits(self) -> None:
        """Marker flush for the training loop (called every step by
        CheckpointHook): an async save's marker lands as soon as its
        writer has made the step durable, not at the NEXT save()/wait() —
        a kill inside the cadence window must not quarantine a step that
        WAS durable. Also applies retention."""
        if not self._pending_commits:
            return
        with self._lock:
            done = sorted(s for s in self._pending_commits
                          if s in self._written)
            self._written.difference_update(done)
        for step in done:
            self._commit(step, self._pending_commits.pop(step))
        if done:
            self._apply_retention()

    def _apply_retention(self) -> None:
        """Keep the newest `max_to_keep` committed steps; remove older
        step directories and their markers (the chief's job)."""
        if not self._chief:
            return
        committed = [s for s in self.all_steps()
                     if self._marker_path(s).exists()]
        for step in committed[:max(0, len(committed) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._marker_path(step).unlink(missing_ok=True)
        live = set(self.all_steps())
        for p in self._commits_dir.glob("*.committed"):
            try:
                if int(p.name.split(".")[0]) not in live:
                    p.unlink(missing_ok=True)
            except ValueError:
                pass

    def latest_step(self, *, refresh: bool = False) -> int | None:
        """Newest COMMITTED step (in-process async saves count — their
        durability is guaranteed before this process exits). The step
        list is read from the directory on every call, so `refresh` (the
        reference's rescan for a directory another process writes) needs
        no extra work here."""
        del refresh
        committed = [s for s in self.all_steps() if self._is_committed(s)]
        committed += list(self._pending_commits)
        return max(committed) if committed else None

    # -- save -----------------------------------------------------------------

    def _write_step(self, step: int, payload: dict, meta: dict) -> None:
        """Write one step durably: tmp dir, fsynced files, rename, fsync
        of the parent."""
        tmp = self.directory / f"{step}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        buf = io.BytesIO()
        torch.save(payload, buf)
        data = buf.getvalue()
        meta = {**meta, "state_crc32": zlib.crc32(data),
                "state_bytes": len(data)}
        _write_durably(tmp / STATE_FILE, lambda fh: fh.write(data))
        _write_durably(tmp / META_FILE, lambda fh: fh.write(
            json.dumps(meta, sort_keys=True).encode("utf-8")))
        _fsync_dir(tmp)
        os.replace(tmp, self._step_dir(step))
        _fsync_dir(self.directory)

    def _writer(self, step: int, payload: dict, meta: dict) -> None:
        try:
            self._write_step(step, payload, meta)
        except BaseException as exc:  # noqa: BLE001 — re-raised by the owner
            with self._lock:
                self._writer_error = exc
            return
        with self._lock:
            self._written.add(step)

    def is_fresh(self, step: int) -> bool:
        """Would a save of `step` write anything? Not when this manager
        saved it last or it is already the latest on disk (re-saving an
        identical step is never useful — e.g. save-on-create right after a
        restore). The chief's answer is the one that counts."""
        return not (step == self._last_saved or step == self.latest_step())

    def save(self, state, *, dispatch_ts: float | None = None) -> bool:
        """Save if this step isn't already on disk (`is_fresh`).

        The state is copied to host memory before this returns; on the
        async path a background thread writes it. `dispatch_ts`
        (time.monotonic) backdates the dispatch→durable span on the
        ``checkpoint_commit`` event. Several ranks: every rank calls it
        (see the module docstring); only the chief writes."""
        step = state.step_int
        if not coordination.agree(self.is_fresh(step)):
            return False
        t0 = dispatch_ts if dispatch_ts is not None else time.monotonic()
        state = unshard_state(state)  # FSDP leaves gathered: a collective
        self.write_full(step, state, dispatch_ts=t0)
        return True

    def write_full(self, step: int, state, *,
                   dispatch_ts: float | None = None) -> None:
        """The collective-free half of `save`: every rank has agreed that
        `step` is saved, and `state` is the FULL state (gathered; None on
        a rank other than the chief, which only records the step). The
        chief writes it. `AsyncSnapshotter`'s writer thread calls this."""
        t0 = dispatch_ts if dispatch_ts is not None else time.monotonic()
        if not self._chief:
            self._last_saved = step
            return
        # one write at a time (orbax blocks a save on the previous one):
        # the previous step is durable now, so its marker can land
        self.wait()
        if self._step_dir(step).exists():
            # a finalized dir without a marker: its writer died before
            # committing it; never a restore point
            self._quarantine(step)
        payload = {
            "step": step,
            **_host_copy(_weights_trees(state)),
            "rng": {"state": state.rng.get_state(),
                    "device": state.rng.device.type},
        }
        meta = {"step": step,
                "rng_device": state.rng.device.type,
                "tree": _meta_tree({k: payload[k] for k in (
                    "params", "model_state", "opt_state")})}
        if self._async:
            self._pending_commits[step] = t0
            self._thread = threading.Thread(
                target=self._writer, args=(step, payload, meta),
                name=f"SnapshotWriter-{step}", daemon=True)
            self._thread.start()
        else:
            self._write_step(step, payload, meta)
            self._commit(step, t0)
            self._apply_retention()
        self._last_saved = step
        log.info("checkpoint saved at step %d -> %s", step, self.directory)
        events.emit("checkpoint_save", step=step)

    # -- restore --------------------------------------------------------------

    def restore(self, target_state):
        """Restore the latest checkpoint into `target_state`'s structure,
        dtypes and devices, and its placement: the full file is read, then
        sharded as the target is. Returns None when no checkpoint exists.

        A structure mismatch that is exactly the ViT scanned↔unrolled
        block layout flip (``blocks`` stack vs ``block0..N-1`` — the two
        layouts `scan_blocks` toggles between, models/vit.py
        ``convert_block_layout``), or an older `_metric` model-state set,
        is healed: the checkpoint is restored in ITS layout and converted
        to the target's (params AND the optimizer slots that mirror
        them).

        A latest step that is UNREADABLE for a non-structural reason
        (truncated/missing/mangled files — `_is_read_corruption`) falls
        back to the next-older committed step, quarantining the bad
        directory under ``<dir>/quarantine/``; at most
        `max_restore_fallbacks` times. Anything else — and corruption
        with no older step left — re-raises the ORIGINAL error.

        A step directory with NO commit marker (its writer died before
        committing it) is quarantined up front WITHOUT spending a
        fallback: it never was a restore point."""
        if self._pending_commits or self._thread is not None:
            self.wait()  # our own in-flight writes: make them committed
        # every rank reads only what the chief has finished writing
        coordination.barrier()
        placement = target_state.placement
        restored = self._restore_latest(full_template(target_state))
        if restored is None or placement is None:
            return restored
        return shard_train_state(restored, placement.mesh, placement.rules)

    def _restore_latest(self, target_state):
        for bad in [s for s in self.all_steps() if not self._is_committed(s)]:
            log.warning("checkpoint step %d has no commit marker (writer "
                        "died mid-write?); quarantining it", bad)
            self._quarantine(bad)
        step = self.latest_step()
        fallbacks = 0
        while step is not None:
            try:
                return self._restore_step(step, target_state)
            except Exception as err:  # noqa: BLE001 — classified below
                older = self._step_before(step)
                if (older is None
                        or fallbacks >= self.max_restore_fallbacks
                        or not _is_read_corruption(err)):
                    raise
                log.error("checkpoint step %d unreadable (%s: %s); "
                          "quarantining it and falling back to step %d",
                          step, type(err).__name__, str(err)[:200], older)
                self._quarantine(step)
                fallbacks += 1
                step = older
        return None

    def _restore_step(self, step: int, target_state):
        """Restore ONE step (structure healing included)."""
        t0 = time.monotonic()
        try:
            restored = self._restore_into(step, target_state)
        except StructureMismatch as err:
            if not self._is_healable(step, target_state):
                raise
            restored = self._restore_with_structure_healing(
                step, target_state, err)
        log.info("restored checkpoint step %d from %s", step, self.directory)
        events.emit("checkpoint_restore", step=step, source="store",
                    dur_ms=round((time.monotonic() - t0) * 1e3, 3))
        return restored

    def _step_before(self, step: int) -> int | None:
        older = [s for s in self.all_steps()
                 if s < step and self._is_committed(s)]
        return max(older) if older else None

    def _quarantine(self, step: int) -> None:
        """Move the step's directory to ``<dir>/quarantine/step_<N>`` so
        retention, latest_step and any later restore never see it again.
        Moved, not deleted: the payload stays for post-mortem. Only the
        chief moves anything; another rank just stops trusting the step."""
        self._pending_commits.pop(step, None)
        if self._last_saved == step:
            self._last_saved = None  # a re-save of this step must not dedupe
        if not self._chief:
            return
        src = self._step_dir(step)
        dst_root = self.directory / "quarantine"
        dst_root.mkdir(exist_ok=True)
        dst = dst_root / f"step_{step}"
        if dst.exists():
            shutil.rmtree(dst)
        if src.exists():
            shutil.move(str(src), str(dst))
        self._marker_path(step).unlink(missing_ok=True)
        events.emit("checkpoint_quarantine", step=step)

    def _read_meta(self, step: int) -> dict:
        return json.loads((self._step_dir(step) / META_FILE).read_text(
            encoding="utf-8"))

    def _load(self, step: int) -> dict:
        """The step's payload. Its bytes are checked against meta.json's
        crc32 after torch's reader has taken them: the reader notices a
        damaged archive or pickle, not flipped bytes in a tensor's
        data."""
        meta = self._read_meta(step)
        path = self._step_dir(step) / STATE_FILE
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if zlib.crc32(path.read_bytes()) != meta.get("state_crc32"):
            raise OSError(errno.EIO, f"checkpoint step {step}: {STATE_FILE} "
                          "does not match the crc32 in meta.json")
        return payload

    def _restore_into(self, step: int, target_state):
        """Restore `step` into the TARGET's structure, dtypes and devices;
        the generator state onto a generator of the target's device."""
        payload = self._load(step)
        trees = _rebuild(_weights_trees(target_state),
                         {k: payload[k] for k in ("params", "model_state",
                                                  "opt_state")}, "")
        target_step = target_state.step
        rng_device = target_state.rng.device
        if payload["rng"]["device"] != rng_device.type:
            raise StructureMismatch(
                f"rng: the checkpoint's generator is a "
                f"{payload['rng']['device']} generator, the target's a "
                f"{rng_device.type} one")
        rng = torch.Generator(device=rng_device)
        rng.set_state(payload["rng"]["state"])
        return TrainState(
            step=torch.tensor(int(payload["step"]), dtype=target_step.dtype,
                              device=target_step.device),
            params=trees["params"], model_state=trees["model_state"],
            opt_state=trees["opt_state"], rng=rng)

    def _restore_with_structure_healing(self, step, target_state, err):
        """Fallback ladder for known benign structure drifts, tried in
        order; anything else re-raises the ORIGINAL error:
        1. the checkpoint carries an older `_metric` model-state set —
           trim the target's metric keys to the on-disk set (from
           meta.json) when known, else strip them all; restore, then fill
           the rest from the target's initial values;
        2. the ViT scanned<->unrolled block layout flip;
        3. both at once."""
        stripped, metric_keys = _strip_metric_state(target_state)
        ondisk = self._ondisk_model_state_keys(step)
        keep = (metric_keys & ondisk) if ondisk is not None else set()
        trimmed = (_strip_metric_state(target_state, keep=keep)[0]
                   if keep and keep != metric_keys else None)
        has_blocks = _flip_block_layouts(target_state, probe_only=True)
        flip_cache: list = []

        def flipped():
            if not flip_cache:
                flip_cache.append(_flip_block_layouts(target_state))
            return flip_cache[0]

        strip_can_help = metric_keys and (ondisk is None
                                          or keep != metric_keys)
        attempts = []
        if trimmed is not None:
            attempts.append(("with only the on-disk _metric entries "
                             f"{sorted(keep)}", lambda: trimmed, False))
        if strip_can_help:
            attempts.append(("without the _metric model-state entries "
                             f"{sorted(metric_keys)}", lambda: stripped,
                             False))
        if has_blocks:
            attempts.append(("in the flipped ViT block layout", flipped,
                             True))
        if strip_can_help and has_blocks:
            if trimmed is not None:
                attempts.append(
                    ("flipped layout + on-disk _metric entries only",
                     lambda: _strip_metric_state(flipped(), keep=keep)[0],
                     True))
            attempts.append(("flipped layout + no _metric entries",
                             lambda: _strip_metric_state(flipped())[0],
                             True))
        for what, make_target, is_flipped in attempts:
            try:
                restored = self._restore_into(step, make_target())
            except StructureMismatch:
                continue
            log.warning("checkpoint step %d did not match the target "
                        "structure (%s); restored %s", step, str(err)[:200],
                        what)
            if is_flipped:
                restored = _flip_block_layouts(restored)
            return _refill_metric_state(restored, target_state)
        raise err

    def _is_healable(self, step: int, target_state) -> bool:
        """Should a `StructureMismatch` enter the structure-healing
        ladder? Only when meta.json shows a different set of leaf paths
        than the target's: a shape or dtype difference on the same paths
        is something no rung can heal."""
        tree = self._ondisk_tree(step)
        if tree is None:
            return False  # no evidence either way: don't retry blindly
        target_meta = _meta_tree(_weights_trees(target_state))
        return _meta_paths(tree) != _meta_paths(target_meta)

    def _ondisk_tree(self, step: int):
        """meta.json's tree (no array reads), or None when unreadable."""
        try:
            tree = self._read_meta(step)["tree"]
        except (OSError, ValueError, KeyError):
            return None
        return tree if isinstance(tree, dict) else None

    def _ondisk_model_state_keys(self, step: int):
        """Top-level model_state key set of the checkpoint (from
        meta.json), or None when it isn't readable."""
        tree = self._ondisk_tree(step)
        ms = None if tree is None else tree.get("model_state")
        return set(ms) if isinstance(ms, dict) and not _is_meta_leaf(ms) \
            else None

    def restore_weights(self, params_like, model_state_like, *,
                        step: int | None = None, device=None):
        """Weights-only restore for inference (serve/loader.py): returns
        ``(step, params, model_state)``, or None when no checkpoint
        exists. No optimizer is ever constructed: the payload's slots are
        read and dropped.

        `params_like`/`model_state_like` give the structure, shapes and
        dtypes (e.g. a fresh `model.init`); the restored leaves go to
        `device`, or to each template leaf's device."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        if not self._is_committed(step):
            raise FileNotFoundError(
                f"checkpoint step {step} is not a committed step of "
                f"{self.directory} (have {self.all_steps()})")
        payload = self._load(step)
        params = _rebuild(params_like, payload["params"], "params", device)
        model_state = _rebuild(model_state_like, payload["model_state"],
                               "model_state", device)
        return step, params, model_state

    def restore_or_init(self, init_state):
        """≙ SessionManager.prepare_session (session_manager.py:259): try
        the latest checkpoint, else the freshly-initialized state."""
        restored = self.restore(init_state)
        return (restored, True) if restored is not None else (init_state,
                                                               False)

    def wait(self) -> None:
        """Block until every dispatched save is durable AND committed —
        the durability point `TrainLoop._honor_preemption` and
        `CheckpointHook.end` rely on before the process may exit."""
        try:
            self._collect_writer(block=True)
        finally:
            self.flush_commits()
            self._pending_commits.clear()  # a failed write never commits

    def close(self) -> None:
        """Wait for the chief's writes, then every rank meets at a
        barrier: no rank leaves before the last checkpoint is durable."""
        self.wait()
        coordination.barrier()
