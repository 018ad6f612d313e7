"""Resilience: fault injection, guarded steps, cooperative preemption and
crash-safe snapshots.

Counterpart of part of ``torchgpipe_tpu/resilience``: the fault plans and
faulty transports of :mod:`~torchgpipe_tpu_torch.resilience.faults`,
:class:`~torchgpipe_tpu_torch.resilience.guard.StepGuard` with
:func:`~torchgpipe_tpu_torch.resilience.guard.classify_error` and
:class:`~torchgpipe_tpu_torch.resilience.guard.GuardPolicy`,
:class:`~torchgpipe_tpu_torch.resilience.preemption.PreemptionHandler`,
and the single-process
:class:`~torchgpipe_tpu_torch.resilience.checkpoint.CheckpointManager`.
The elastic ``Supervisor`` is not ported yet (ROADMAP.md, queue A item
5.6: it calls the planner).
"""

from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CheckpointManager,
    Snapshot,
    latest_step_or_none,
)
from torchgpipe_tpu_torch.resilience.guard import (
    GuardPolicy,
    GuardStats,
    StepGuard,
    classify_error,
)
from torchgpipe_tpu_torch.resilience.preemption import PreemptionHandler

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "GuardPolicy",
    "GuardStats",
    "PreemptionHandler",
    "Snapshot",
    "StepGuard",
    "classify_error",
    "faults",
    "latest_step_or_none",
]
