"""Training core (port of the reference `train/`, one device): the state
and the steps. The hooked `TrainLoop` joins with the hooks and checkpoint
slice."""

from dist_mnist_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    state_memory_bytes,
)
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
]
