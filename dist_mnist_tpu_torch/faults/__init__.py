"""Resilience (port of the reference `faults/`, one device): the
preemption handshake and goodput accounting. The fault-injection plans
and shims (`plan.py`, `inject.py`) join with ROADMAP §1 item 13."""

from dist_mnist_tpu_torch.faults.goodput import (
    GoodputClock,
    GoodputHook,
    elastic_summary,
)
from dist_mnist_tpu_torch.faults.preemption import (
    PreemptionNotice,
    install_preemption_handlers,
)

__all__ = [
    "GoodputClock",
    "GoodputHook",
    "elastic_summary",
    "PreemptionNotice",
    "install_preemption_handlers",
]
