"""Async snapshotting: the checkpoint write off the step's critical path
(port of the reference `checkpoint/snapshot.py`).

The loop thread pays for a FORK of the TrainState (`fork_state`: a
`clone()` of every tensor leaf on the device and a copy of the
generator's state) and a queue handoff; a background writer thread owns
the slow part (the copy to host memory, the file write, the commit
marker, the peer replicas).

Collectives stay on the loop thread (a stated departure in how the work
is split; the reference's writer thread calls the whole orbax save). The
port's `CheckpointManager.save` runs two of them: `coordination.agree`
on whether the step is saved, and `unshard_state`'s all-gathers of the
FSDP and TP slices. A writer thread that ran them on a fork would put
them on the default gloo group beside the step's own, in an order that
differs between ranks: a hang or a wrong sum. So `save` here takes the
agree decision (`CheckpointManager.is_fresh` of the chief) and gathers
the full state on the loop thread, forks it (the chief only: only the
chief writes the store), forks this rank's own slices too when a peer
ring is attached, and enqueues; the writer calls the manager's
collective-free `write_full`, then `PeerReplicator.write`.

The fork is ordered on the device: its clones are issued on the loop's
current CUDA stream, so the next step's in-place updates (the optimizer)
run after them, and a CUDA event recorded after the clones is what the
writer waits on before it copies the fork to the host.

Write-behind is BOUNDED: at most `window` snapshots may be forked but not
durable at once (queued + in flight). A save that would exceed the bound
either blocks — the stall is attributed (``save_stall`` journal event,
`save_stall_s`, and it lands in CheckpointHook's `consume_save_s`, the
goodput `save` bucket, since the block happens inside `save`) — or drops
the oldest QUEUED snapshot (``drop_oldest``; the in-flight write is never
abandoned, so with an empty queue the new fork is admitted as a
transient one-snapshot overshoot). With more than one rank
``drop_oldest`` becomes ``block``: drops are decided by each rank's own
queue, and two ranks could drop different steps.

Durability contract: `wait()` returns only after every accepted snapshot
is written AND committed (and its peer replicas written), and re-raises
the first writer error. `TrainLoop._honor_preemption` and
`CheckpointHook.end` call save + wait, so the preemption drain works
unchanged through this wrapper.

`AsyncSnapshotter` implements the CheckpointManager protocol (save /
restore / restore_or_init / wait / close / latest_step) and forwards
everything else to the wrapped manager, so it slots in as both
`TrainLoop.checkpoint_manager` and `CheckpointHook`'s manager. With a
`PeerReplicator` attached, `restore()` tries the peer ring before the
store (checkpoint/peer.py).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque

import torch

from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.parallel.sharding import unshard_state

log = logging.getLogger(__name__)

#: writer threads are named <prefix>-<n> so tests can assert none leak
THREAD_NAME_PREFIX = "SnapshotWriter"

_POLICIES = ("block", "drop_oldest")


def _clone_tree(tree):
    """`tree` with every tensor cloned (dicts, lists, tuples and
    namedtuples kept)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_clone_tree(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _fork_rng(rng: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=rng.device)
    out.set_state(rng.get_state())
    return out


def fork_state(state):
    """A copy of `state` in fresh device buffers: every tensor leaf
    cloned on the current stream (so later in-place updates of the
    originals are ordered after the copy), the generator's state copied,
    the placement kept. No host transfer happens here."""
    return dataclasses.replace(
        state, step=state.step.detach().clone(),
        params=_clone_tree(state.params),
        model_state=_clone_tree(state.model_state),
        opt_state=_clone_tree(state.opt_state),
        rng=_fork_rng(state.rng))


def _fork_event(state):
    """A CUDA event recorded after the fork's clones, or None on the
    CPU (a CPU clone has finished when it returns)."""
    if state is None or state.step.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(state.step.device))
    return event


class _Item:
    """One accepted snapshot: the chief's full fork (None elsewhere),
    this rank's own slices for the peer ring (None without one), and the
    event the writer waits on."""

    __slots__ = ("step", "full", "local", "placement", "event", "ts")

    def __init__(self, step, full, local, placement, event, ts):
        self.step = step
        self.full = full
        self.local = local
        self.placement = placement
        self.event = event
        self.ts = ts


class AsyncSnapshotter:
    """Bounded write-behind checkpointing over a `CheckpointManager`.

    Parameters
    ----------
    manager:
        The durable store (CheckpointManager, possibly fault-wrapped),
        constructed with ``async_save=False``: asyncness is owned by this
        layer's writer thread, and a synchronous inner write lands the
        commit marker in the same writer pass.
    window:
        Max snapshots forked but not durable at once (>= 1).
    policy:
        ``"block"`` (default) or ``"drop_oldest"`` — what `save` does when
        the window is full.
    peer:
        Optional `PeerReplicator` for ring redundancy and peer-first
        restore.
    """

    def __init__(self, manager, *, window: int = 1, policy: str = "block",
                 peer=None):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}: {policy!r}")
        ctx = coordination.context()
        if policy == "drop_oldest" and ctx is not None and ctx.world > 1:
            log.warning("drop_oldest is unsafe with %d ranks (divergent "
                        "drops desync the ranks' saves); using policy=block",
                        ctx.world)
            policy = "block"
        self._inner = manager
        self._peer = peer
        self._window = max(1, int(window))
        self._policy = policy
        self._cond = threading.Condition()
        self._q: deque = deque()  # _Item
        self._busy = False        # writer holds an item (popped, not durable)
        self._stop = False
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_step: int | None = None
        #: attributed write-behind stalls (block policy) / drops
        self.save_stall_s = 0.0
        self.dropped = 0

    # -- manager protocol ---------------------------------------------------

    def save(self, state) -> bool:
        """Agree, gather and fork on this (the loop's) thread, then
        enqueue; never writes on the caller's thread. Returns True when a
        snapshot was accepted."""
        if self._error is not None:
            raise RuntimeError("snapshot writer failed") from self._error
        step = state.step_int
        fresh = step != self._last_step and self._inner.is_fresh(step)
        if not coordination.agree(fresh):
            return False
        t0 = time.monotonic()
        placement = state.placement
        sharded = placement is not None and placement.sharded
        full = unshard_state(state) if sharded else state  # a collective
        chief = coordination.is_chief()
        fork = fork_state(full) if chief or (
            self._peer is not None and not sharded) else None
        local = None
        if self._peer is not None:
            local = fork_state(state) if sharded else fork
        event = _fork_event(fork if fork is not None else local)
        events.emit("snapshot_fork", step=int(step),
                    fork_ms=round((time.monotonic() - t0) * 1e3, 3))
        item = _Item(int(step), fork if chief else None, local, placement,
                     event, t0)
        stall = 0.0
        with self._cond:
            while len(self._q) + (1 if self._busy else 0) >= self._window:
                if self._policy == "drop_oldest":
                    if not self._q:
                        break  # only the in-flight write remains: overshoot
                    dropped = self._q.popleft()
                    self.dropped += 1
                    events.emit("snapshot_drop", step=dropped.step)
                    continue
                t_stall = time.monotonic()
                self._cond.wait(timeout=0.05)
                stall += time.monotonic() - t_stall
                if self._error is not None:
                    self.save_stall_s += stall
                    raise RuntimeError(
                        "snapshot writer failed") from self._error
            self._q.append(item)
            self._last_step = step
            self._cond.notify_all()
        if stall > 0.0:
            self.save_stall_s += stall
            events.emit("save_stall", step=int(step),
                        stall_ms=round(stall * 1e3, 3))
        self._ensure_thread()
        return True

    def restore(self, target_state):
        """Peer-first restore: assemble from the ring when it has a step at
        least as fresh as the store's committed frontier, else (peer gone,
        stale, or incomplete) fall through to the store ladder.

        Drains the write-behind queue first, and with several ranks meets
        at a barrier before reading the ring: every rank's replicas of the
        drained steps are then on disk. The ranks take the ring only when
        every one of them assembled the chief's step; otherwise all go to
        the store together (its restore meets at a barrier of its own)."""
        self.wait()
        self._last_step = None  # the frontier moves back: saves are fresh
        if self._peer is not None:
            coordination.barrier()
            try:
                store_step = self._inner.latest_step()
            except Exception:  # noqa: BLE001 — the store decides below
                store_step = None
            store_step = coordination.agree(store_step)
            t0 = time.monotonic()
            try:
                got = self._peer.restore(target_state, min_step=store_step)
            except Exception as err:  # noqa: BLE001 — redundancy, never fatal
                log.warning("peer restore failed (%s: %s); using the store",
                            type(err).__name__, str(err)[:200])
                got = None
            mine = None if got is None else got[1]
            chief_step = coordination.agree(mine)
            if chief_step is not None and not coordination.any_rank(
                    mine != chief_step):
                restored, step, sources = got
                events.emit(
                    "peer_restore", step=int(step),
                    dur_ms=round((time.monotonic() - t0) * 1e3, 3),
                    sources=sources)
                log.info("restored step %d from peer ring (sources=%s)",
                         step, sources)
                return restored
        return self._inner.restore(target_state)

    def restore_or_init(self, init_state):
        restored = self.restore(init_state)
        return (restored, True) if restored is not None else (init_state,
                                                               False)

    def latest_step(self, *, refresh: bool = False):
        return self._inner.latest_step(refresh=refresh)

    def wait(self) -> None:
        """Drain: every accepted snapshot durable + committed (peer writes
        included) before return. Re-raises the first writer error."""
        with self._cond:
            while self._q or self._busy:
                self._cond.wait(timeout=0.05)
        self._inner.wait()
        if self._error is not None:
            raise RuntimeError("snapshot writer failed") from self._error

    def consume_save_stall_s(self) -> float:
        """Drain the attributed stall counter (bench reporting)."""
        s, self.save_stall_s = self.save_stall_s, 0.0
        return s

    def close(self) -> None:
        try:
            with self._cond:
                while (self._q or self._busy) and self._error is None:
                    self._cond.wait(timeout=0.05)
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
                self._thread = None
            if self._error is not None:
                log.error("snapshot writer error at close: %r", self._error)
            self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- writer thread ------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop,
                name=f"{THREAD_NAME_PREFIX}-{id(self) & 0xFFFF}",
                daemon=True)
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop and not self._q:
                    return
                item = self._q.popleft()
                self._busy = True
                self._cond.notify_all()
            try:
                if item.event is not None:
                    item.event.synchronize()  # the fork's clones are done
                # a sync inner write: when this returns the step is durable
                # and its commit marker has landed, so `checkpoint_commit`'s
                # dur_ms (back-dated to the fork) spans dispatch -> durable
                self._inner.write_full(item.step, item.full,
                                       dispatch_ts=item.ts)
                self._inner.wait()
                if self._peer is not None:
                    try:
                        self._peer.write(item.step, item.local,
                                         item.placement)
                    except Exception as err:  # noqa: BLE001 — redundancy only
                        log.warning(
                            "peer replication of step %d failed (%s: %s)",
                            item.step, type(err).__name__, str(err)[:200])
            except BaseException as err:  # noqa: BLE001 — surfaced in wait()
                if self._error is None:
                    self._error = err
                log.error("snapshot write of step %d failed: %r", item.step,
                          err)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
