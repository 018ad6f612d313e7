"""Deterministic fault injection: a simulated preemption.

Counterpart of the preemption part of ``torchgpipe_tpu/resilience/
faults.py``: :func:`inject` with ``preempt_at_step=k`` makes
:meth:`~torchgpipe_tpu_torch.resilience.preemption.PreemptionHandler.check`
report a preemption at step ``k`` — a SIGTERM without the SIGTERM.  The
reference's other faults (NaN cells, slow stages, dead replicas, faulty
transports) belong to engines not ported yet (ROADMAP.md, queue A
items 2 and 5).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break while the plan is active (see :func:`inject`)."""

    # PreemptionHandler.check(step) reports True for step >= this.
    preempt_at_step: Optional[int] = None


_lock = threading.Lock()
_active: Optional[FaultPlan] = None


@contextlib.contextmanager
def inject(*, preempt_at_step: Optional[int] = None) -> Iterator[FaultPlan]:
    """Activate a :class:`FaultPlan` for the enclosed block.  Plans do not
    nest: a second concurrent ``inject`` raises."""
    global _active
    plan = FaultPlan(preempt_at_step=preempt_at_step)
    with _lock:
        if _active is not None:
            raise RuntimeError(
                "a fault plan is already active; fault injections do not nest"
            )
        _active = plan
    try:
        yield plan
    finally:
        with _lock:
            _active = None


def active_plan() -> Optional[FaultPlan]:
    """The currently injected plan, or None."""
    return _active


def should_preempt(step: int) -> bool:
    """True iff the active plan simulates a preemption at/before ``step``."""
    plan = _active
    return (
        plan is not None
        and plan.preempt_at_step is not None
        and step >= plan.preempt_at_step
    )


__all__ = ["FaultPlan", "active_plan", "inject", "should_preempt"]
