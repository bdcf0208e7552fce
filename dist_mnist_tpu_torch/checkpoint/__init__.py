"""Checkpoint/resume — Saver + CheckpointSaverHook + SessionManager
restore (port of the reference `checkpoint/`), in torch's own file
format, with the async write-behind layer (`AsyncSnapshotter`) and the
peer ring (`PeerReplicator`)."""

from dist_mnist_tpu_torch.checkpoint.manager import CheckpointManager
from dist_mnist_tpu_torch.checkpoint.peer import (
    PeerReplicator,
    restore_from_peers,
)
from dist_mnist_tpu_torch.checkpoint.snapshot import (
    AsyncSnapshotter,
    fork_state,
)

__all__ = ["AsyncSnapshotter", "CheckpointManager", "PeerReplicator",
           "fork_state", "restore_from_peers"]
