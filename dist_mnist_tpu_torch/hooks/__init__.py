"""Hook lifecycle — the SessionRunHook system, functional.

Replaces SURVEY.md §2.4 row 18 (basic_session_run_hooks.py). Same lifecycle
shape (begin / before-step / after-step / end), but hooks receive the step's
returned metrics dict instead of injecting fetches into a feed/fetch merge
(there is no session to merge into).

Port of the reference's `hooks/`: every hook but `OverlapHook`, which
refuses (`hooks.builtin.OverlapHook`; ROADMAP §1 item 13).
"""

from dist_mnist_tpu_torch.hooks.base import Hook
from dist_mnist_tpu_torch.hooks.builtin import (
    StopAtStepHook,
    StepCounterHook,
    InputPipelineHook,
    StepTimeHook,
    LoggingHook,
    NaNGuardHook,
    NanLossError,
    CheckpointHook,
    SummaryHook,
    ProfilerHook,
    EvalHook,
    GlobalStepWaiterHook,
    FinalOpsHook,
    MemoryProfileHook,
    MemoryHook,
)

__all__ = [
    "Hook",
    "StopAtStepHook",
    "StepCounterHook",
    "InputPipelineHook",
    "StepTimeHook",
    "LoggingHook",
    "NaNGuardHook",
    "NanLossError",
    "CheckpointHook",
    "SummaryHook",
    "ProfilerHook",
    "EvalHook",
    "GlobalStepWaiterHook",
    "FinalOpsHook",
    "MemoryProfileHook",
    "MemoryHook",
]
