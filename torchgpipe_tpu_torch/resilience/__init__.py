"""Resilience for the serving engine: retry classification, cooperative
preemption and crash-safe snapshots.

Counterpart of part of ``torchgpipe_tpu/resilience``:
:func:`~torchgpipe_tpu_torch.resilience.guard.classify_error` and
:class:`~torchgpipe_tpu_torch.resilience.guard.GuardPolicy`,
:class:`~torchgpipe_tpu_torch.resilience.preemption.PreemptionHandler`
with the simulated preemption of
:mod:`~torchgpipe_tpu_torch.resilience.faults`, and the single-process
:class:`~torchgpipe_tpu_torch.resilience.checkpoint.CheckpointManager`.
``StepGuard`` and the elastic ``Supervisor`` are not ported yet
(ROADMAP.md, queue A items 2 and 5).
"""

from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CheckpointManager,
    Snapshot,
    latest_step_or_none,
)
from torchgpipe_tpu_torch.resilience.guard import GuardPolicy, classify_error
from torchgpipe_tpu_torch.resilience.preemption import PreemptionHandler

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "GuardPolicy",
    "PreemptionHandler",
    "Snapshot",
    "classify_error",
    "faults",
    "latest_step_or_none",
]
