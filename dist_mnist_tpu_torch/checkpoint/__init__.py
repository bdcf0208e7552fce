"""Checkpoint/resume — Saver + CheckpointSaverHook + SessionManager
restore (port of the reference `checkpoint/`, one process), in torch's own
file format. The async write-behind layer (`AsyncSnapshotter`) and the
peer ring (`PeerReplicator`) join with ROADMAP §1 item 13."""

from dist_mnist_tpu_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
