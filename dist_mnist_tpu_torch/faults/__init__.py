"""Fault injection and resilience (port of the reference `faults/`):
chaos plans, injector shims, the preemption handshake, and goodput
accounting.

Modules:
- plan       — `FaultPlan`/`Fault`: the deterministic fault schedule (a
               copy of the reference's)
- inject     — shims that land each fault kind on its real seam
- preemption — SIGTERM/SIGINT -> step-boundary checkpoint-and-exit-0
- goodput    — productive/restore/replay/stall wall-time attribution

Exports resolve lazily (PEP 562): train/loop.py imports faults.goodput at
its module top, while faults.inject imports train.loop for
PreemptionError — eager re-exports here would close that cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "Fault": "dist_mnist_tpu_torch.faults.plan",
    "FaultPlan": "dist_mnist_tpu_torch.faults.plan",
    "FaultInjectionHook": "dist_mnist_tpu_torch.faults.inject",
    "FaultyBatches": "dist_mnist_tpu_torch.faults.inject",
    "FaultyCheckpointManager": "dist_mnist_tpu_torch.faults.inject",
    "FaultyEngine": "dist_mnist_tpu_torch.faults.inject",
    "FaultyStepFn": "dist_mnist_tpu_torch.faults.inject",
    "GoodputClock": "dist_mnist_tpu_torch.faults.goodput",
    "GoodputHook": "dist_mnist_tpu_torch.faults.goodput",
    "elastic_summary": "dist_mnist_tpu_torch.faults.goodput",
    "PreemptionNotice": "dist_mnist_tpu_torch.faults.preemption",
    "install_preemption_handlers": "dist_mnist_tpu_torch.faults.preemption",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
