"""The port's resilience cases: what every rank of a gloo group runs
(`torch_ranks.run_ranks`) for the snapshot and peer-ring tests, the MLP
states they start from, and the leak check each resilience test module
runs after every test. This module imports the port and never JAX."""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.checkpoint import (
    AsyncSnapshotter,
    CheckpointManager,
    PeerReplicator,
)
from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.parallel.sharding import (
    resolve_rules,
    shard_train_state,
    unshard_state,
)
from dist_mnist_tpu_torch.train import create_train_state, make_train_step
from torch_ranks import to_numpy

#: threads a resilience path starts and must join
THREAD_PREFIXES = ("SnapshotWriter", "ElasticGrowTimer", "FaultKillTimer",
                   "LaunchPump")


def leaked(tmp_root: Path, before: set) -> list[str]:
    """What a test left behind: live threads of `THREAD_PREFIXES`, live
    children of the port's launcher, pending peer-ring temp files, and
    supervisor temp dirs under `tmp_root` that were not in `before`."""
    import sys

    from dist_mnist_tpu_torch.cli.launch import SUPERVISOR_DIR_PREFIX

    out = [t.name for t in threading.enumerate()
           if t.is_alive() and t.name.startswith(THREAD_PREFIXES)]
    launch_mod = sys.modules.get("dist_mnist_tpu_torch.cli.launch")
    if launch_mod is not None:
        out += [f"child pid={p.pid}" for p in launch_mod._LIVE_CHILDREN
                if p.poll() is None]
    peer_mod = sys.modules.get("dist_mnist_tpu_torch.checkpoint.peer")
    if peer_mod is not None:
        out += [f"pending peer tmp {p}" for p in peer_mod._PENDING_TMP]
    out += [f"stray supervisor dir {p}"
            for p in tmp_root.glob(SUPERVISOR_DIR_PREFIX + "*")
            if p not in before]
    return out


def wait_unleaked(tmp_root: Path, before: set, timeout: float = 5.0):
    """`leaked` once it is empty, or what is still there at `timeout` (a
    thread that just saw its stop flag may be mid-exit)."""
    deadline = time.monotonic() + timeout
    while True:
        left = leaked(tmp_root, before)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)


def mlp_state(rules_name: str, mesh, seed: int = 0, step: int = 7,
              trained: bool = True):
    """A hidden-64 MLP state under Adam, placed on `mesh` by the named
    rules: one training step on a seeded batch (so the optimizer slots
    hold values), then its step counter set to `step`."""
    model, opt = MLP(hidden_units=64), optim.adam(1e-3)
    rules = resolve_rules(rules_name)
    state = shard_train_state(
        create_train_state(model, opt, seed,
                           np.zeros((1, 28, 28, 1), np.uint8), "cpu"),
        mesh, rules)
    if trained:
        rng = np.random.default_rng(seed)
        n = 8 * mesh.size
        images = rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
        labels = rng.integers(0, 10, n).astype(np.int32)
        rows = slice(mesh.rank * 8, (mesh.rank + 1) * 8)
        batch = {"image": torch.from_numpy(images[rows].copy()),
                 "label": torch.from_numpy(labels[rows].copy())}
        state, _ = make_train_step(model, opt, mesh=mesh)(state, batch)
    return dataclasses.replace(state, step=torch.tensor(step,
                                                        dtype=torch.int32))


def full_numpy(state) -> dict:
    """The full (gathered) state's params, optimizer state, step and
    generator state as numpy (a collective on a placed state)."""
    full = unshard_state(state)
    return {"params": to_numpy(full.params),
            "opt_state": to_numpy(full.opt_state),
            "step": int(full.step_int),
            "rng": full.rng.get_state().numpy()}


def snapshot_and_restore(root: str, rules_name: str) -> dict:
    """Every rank: the MLP state under `rules_name` on the whole group,
    saved at step 7 through the `AsyncSnapshotter` with this rank's
    `PeerReplicator` (host = rank; the chief writes the store), then
    restored on the same group into a state of another seed, once from
    the ring and once from the store. Returns the saved full state and
    both restores (gathered), and this rank's placement facts."""
    mesh = make_mesh(MeshSpec(data=-1), device="cpu")
    ctx = coordination.context()
    state = mlp_state(rules_name, mesh, seed=0, step=7)
    peer = PeerReplicator(Path(root) / "peer", ctx.rank, range(ctx.world))
    snap = AsyncSnapshotter(CheckpointManager(Path(root) / "store",
                                              async_save=False), peer=peer)
    journal = Path(root) / f"journal_{ctx.rank}.jsonl"
    prev = events.set_journal(events.RunJournal(journal))
    try:
        assert snap.save(state)
        snap.wait()
        target = mlp_state(rules_name, mesh, seed=9, step=0, trained=False)
        from_ring = snap.restore(target)
    finally:
        snap.close()
        events.set_journal(prev).close()
    store = CheckpointManager(Path(root) / "store", async_save=False)
    try:
        from_store = store.restore(target)
    finally:
        store.close()
    return {"rank": ctx.rank, "world": ctx.world,
            "events": [r["event"] for r in events.read_journal(journal)],
            "sharded": bool(state.placement.sharded),
            "saved": full_numpy(state), "ring": full_numpy(from_ring),
            "store": full_numpy(from_store),
            "ring_placed_like_target": [
                tuple(a.shape) for a in from_ring.params["hid"].values()
            ] == [tuple(a.shape) for a in target.params["hid"].values()]}
