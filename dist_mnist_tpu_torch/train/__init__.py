"""Training core (port of the reference `train/`, one device): the state,
the steps, and the hooked `TrainLoop` (`loop.py`) with the hook protocol
(`hooks/`)."""

from dist_mnist_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    state_memory_bytes,
)
from dist_mnist_tpu_torch.train.loop import StopSignal, TrainLoop
from dist_mnist_tpu_torch.train.step import (
    evaluate,
    make_eval_step,
    make_fused_train_step,
    make_scanned_train_fn,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "state_memory_bytes",
    "make_train_step",
    "make_fused_train_step",
    "make_scanned_train_fn",
    "make_eval_step",
    "evaluate",
    "TrainLoop",
    "StopSignal",
]
