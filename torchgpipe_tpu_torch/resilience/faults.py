"""Deterministic fault injection: the chaos harness of the resilience
stack, and the oracle of its tests.

Counterpart of ``torchgpipe_tpu/resilience/faults.py``, with the same
names and plan fields:

* :func:`inject` activates a :class:`FaultPlan` for the enclosed steps.
  ``nan_at=(stage, micro_batch)`` poisons that cell's input with NaNs
  (the per-cell schedulers call :func:`corrupt_cell_input`: the
  single-process ``GPipe``'s and each ``DistributedGPipe`` rank's);
  ``preempt_at_step=k`` makes
  :meth:`~torchgpipe_tpu_torch.resilience.preemption.PreemptionHandler.check`
  report a preemption at step ``k``; ``die_at_megastep=(rank, k)`` is a
  training rank's cooperative death (:func:`should_die_at_megastep`,
  checked by a training loop between steps); ``slow_at``,
  ``die_at_step``, ``slow_replica_at`` and ``bad_version_at`` are the
  straggler and serving-fleet faults (:func:`cell_delay_s`,
  :func:`should_die`, :func:`replica_delay_s`,
  :func:`bad_version_delay_s`), pure functions whose consumers (the
  tracer's straggler, the fleet router) come with their engines.
* :class:`FaultyTransport` wraps any transport of
  :mod:`torchgpipe_tpu_torch.distributed.context` and applies
  :class:`SendFault` rules on ``send``: ``drop`` (a ``ConnectionError``
  at the sender), ``lose`` (silently discarded), ``delay`` and
  ``duplicate``; ``hang_at`` blocks a send until :meth:`release`.

A plan that can change a captured CUDA graph (``nan_at``) changes
:func:`plan_token`, which ``GPipe(fused=True)`` keys its graphs by.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

Pytree = Any


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break while the plan is active (see :func:`inject`)."""

    # Poison the input of pipeline cell (stage, micro-batch) with NaNs.
    nan_at: Optional[Tuple[int, int]] = None
    # PreemptionHandler.check(step) reports True for step >= this.
    preempt_at_step: Optional[int] = None
    # Slow every cell of one stage by (stage, extra_seconds).
    slow_at: Optional[Tuple[int, float]] = None
    # Kill serving-fleet replica (replica, engine step).
    die_at_step: Optional[Tuple[int, int]] = None
    # Kill training rank (rank, completed megasteps).
    die_at_megastep: Optional[Tuple[int, int]] = None
    # Slow one serving replica by (replica, extra_seconds) per step.
    slow_replica_at: Optional[Tuple[int, float]] = None
    # A published parameter version that degrades: (replica, version).
    bad_version_at: Optional[Tuple[int, int]] = None
    # Extra seconds per step while ``bad_version_at`` matches.
    bad_version_delay: float = 0.05


_lock = threading.Lock()
_active: Optional[FaultPlan] = None
# Bumped on every activation and deactivation: a cache of captured
# programs keyed by plan_token() never reuses one captured under a plan.
_epoch: int = 0


@contextlib.contextmanager
def inject(
    *,
    nan_at: Optional[Tuple[int, int]] = None,
    preempt_at_step: Optional[int] = None,
    slow_at: Optional[Tuple[int, float]] = None,
    die_at_step: Optional[Tuple[int, int]] = None,
    die_at_megastep: Optional[Tuple[int, int]] = None,
    slow_replica_at: Optional[Tuple[int, float]] = None,
    bad_version_at: Optional[Tuple[int, int]] = None,
    bad_version_delay: float = 0.05,
) -> Iterator[FaultPlan]:
    """Activate a :class:`FaultPlan` for the enclosed block.  Plans do not
    nest: a second concurrent ``inject`` raises."""
    global _active, _epoch
    plan = FaultPlan(nan_at=nan_at, preempt_at_step=preempt_at_step,
                     slow_at=slow_at, die_at_step=die_at_step,
                     die_at_megastep=die_at_megastep,
                     slow_replica_at=slow_replica_at,
                     bad_version_at=bad_version_at,
                     bad_version_delay=bad_version_delay)
    with _lock:
        if _active is not None:
            raise RuntimeError(
                "a fault plan is already active; fault injections do not nest"
            )
        _active = plan
        _epoch += 1
    try:
        yield plan
    finally:
        with _lock:
            _active = None
            _epoch += 1


def active_plan() -> Optional[FaultPlan]:
    """The currently injected plan, or None."""
    return _active


def plan_token() -> Optional[int]:
    """Cache key for captured programs: this activation's epoch when the
    active plan changes what a step computes (``nan_at``), else None
    (host-side plans must not force a second capture)."""
    plan = _active
    return _epoch if plan is not None and plan.nan_at is not None else None


def _nan_like(t: Any) -> Any:
    if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
        return torch.full_like(t, float("nan"))
    return t


def poison(tree: Pytree) -> Pytree:
    """Every floating tensor of ``tree`` replaced by NaNs (shape, dtype
    and device kept); other leaves unchanged."""
    return pytree.tree_map(_nan_like, tree)


def corrupt_cell_input(stage: int, microbatch: int, tree: Pytree) -> Pytree:
    """Per-cell scheduler hook, called with the cell's indices: poisons
    the input iff the active plan names this cell."""
    plan = _active
    if plan is None or plan.nan_at != (stage, microbatch):
        return tree
    return poison(tree)


def spmd_corrupt_cell_input(stage: Any, microbatch: Any, tree: Pytree) -> Pytree:
    """The same poisoning with ``stage`` and ``microbatch`` as device
    tensors (an SPMD schedule's lane and tick indices): a ``torch.where``
    mask, so it runs inside a captured program.  The caller checks for a
    ``nan_at`` plan on the host and keys its programs by
    :func:`plan_token`."""
    plan = _active
    if plan is None or plan.nan_at is None:
        return tree
    s, i = plan.nan_at
    hit = torch.logical_and(torch.as_tensor(stage) == s, torch.as_tensor(microbatch) == i)

    def mask(t: Any) -> Any:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return torch.where(hit.to(t.device), torch.full_like(t, float("nan")), t)
        return t

    return pytree.tree_map(mask, tree)


def cell_delay_s(stage: int) -> float:
    """Extra seconds per cell the active plan injects into ``stage`` (0.0
    without a matching ``slow_at``)."""
    plan = _active
    if plan is None or plan.slow_at is None or plan.slow_at[0] != stage:
        return 0.0
    return float(plan.slow_at[1])


def should_die(replica: int, step: int) -> bool:
    """True iff the active plan kills serving replica ``replica`` at or
    before its engine step ``step``."""
    plan = _active
    return (
        plan is not None
        and plan.die_at_step is not None
        and plan.die_at_step[0] == replica
        and step >= plan.die_at_step[1]
    )


def should_die_at_megastep(rank: int, megasteps: int) -> bool:
    """True iff the active plan kills training rank ``rank`` at or before
    ``megasteps`` completed (mega)steps: the cooperative death a training
    loop checks between steps."""
    plan = _active
    return (
        plan is not None
        and plan.die_at_megastep is not None
        and plan.die_at_megastep[0] == rank
        and megasteps >= plan.die_at_megastep[1]
    )


def replica_delay_s(replica: int) -> float:
    """Extra seconds per engine step the active plan injects into serving
    replica ``replica`` (0.0 without a matching ``slow_replica_at``)."""
    plan = _active
    if (
        plan is None
        or plan.slow_replica_at is None
        or plan.slow_replica_at[0] != replica
    ):
        return 0.0
    return float(plan.slow_replica_at[1])


def bad_version_delay_s(replica: int, version: int) -> float:
    """Extra seconds per engine step while serving replica ``replica``
    runs parameter version ``version`` (0.0 without a matching
    ``bad_version_at``)."""
    plan = _active
    if (
        plan is None
        or plan.bad_version_at is None
        or plan.bad_version_at != (replica, version)
    ):
        return 0.0
    return float(plan.bad_version_delay)


def should_preempt(step: int) -> bool:
    """True iff the active plan simulates a preemption at/before ``step``."""
    plan = _active
    return (
        plan is not None
        and plan.preempt_at_step is not None
        and step >= plan.preempt_at_step
    )


# --------------------------------------------------------------------- #
# transport faults                                                      #
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class SendFault:
    """One rule :class:`FaultyTransport` applies on ``send``.  ``None``
    fields match anything; ``times`` bounds how often the rule fires (-1:
    every match), after which sends pass through clean."""

    action: str  # 'drop' | 'lose' | 'delay' | 'duplicate'
    dst: Optional[str] = None
    kind: Any = None
    index: Optional[int] = None
    times: int = 1
    delay_s: float = 0.05
    fired: int = 0

    _ACTIONS = ("drop", "lose", "delay", "duplicate")

    def __post_init__(self) -> None:
        if self.action not in self._ACTIONS:
            raise ValueError(
                f"action must be one of {self._ACTIONS}, got {self.action!r}"
            )

    def matches(self, dst: str, kind: Any, index: int) -> bool:
        if self.times >= 0 and self.fired >= self.times:
            return False
        return (
            (self.dst is None or self.dst == dst)
            and (self.kind is None or self.kind == kind)
            and (self.index is None or self.index == index)
        )


class FaultyTransport:
    """Any transport with deterministic send-side faults.

    ``drop`` raises ``ConnectionError`` at the sender (a transient error
    for :func:`~torchgpipe_tpu_torch.resilience.guard.classify_error`),
    ``lose`` discards the message (the receiver's ``recv_timeout``
    catches it), ``delay`` sleeps before delivering and ``duplicate``
    delivers twice.  ``hang_at=(kind, index)`` blocks a matching send
    until :meth:`release`, which lets it return undelivered.  Every other
    attribute is the wrapped transport's.
    """

    def __init__(
        self,
        inner: Any,
        faults: Sequence[SendFault] = (),
        *,
        hang_at: Optional[Tuple[Any, int]] = None,
    ) -> None:
        self.inner = inner
        self.faults: List[SendFault] = list(faults)
        self.hang_at = hang_at
        self.log: List[Tuple[str, str, Any, int]] = []  # (action, dst, kind, i)
        self._hang_release = threading.Event()

    def add(self, fault: SendFault) -> "FaultyTransport":
        self.faults.append(fault)
        return self

    def release(self) -> None:
        """Unblock every sender hung by ``hang_at`` (their messages stay
        undelivered) and let later matches pass."""
        self._hang_release.set()

    def send(self, dst: str, kind: Any, index: int, payload: Any) -> None:
        if (
            self.hang_at is not None
            and self.hang_at == (kind, index)
            and not self._hang_release.is_set()
        ):
            self.log.append(("hang", dst, kind, index))
            self._hang_release.wait()
            return
        sends = 1
        for f in self.faults:
            if not f.matches(dst, kind, index):
                continue
            f.fired += 1
            self.log.append((f.action, dst, kind, index))
            if f.action == "drop":
                raise ConnectionError(
                    f"fault injection: dropped send of {kind!r}[{index}] "
                    f"to {dst!r}"
                )
            if f.action == "lose":
                return
            if f.action == "delay":
                time.sleep(f.delay_s)
            elif f.action == "duplicate":
                sends += 1
        for _ in range(sends):
            self.inner.send(dst, kind, index, payload)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)


__all__ = [
    "FaultPlan", "FaultyTransport", "SendFault", "active_plan",
    "bad_version_delay_s", "cell_delay_s", "corrupt_cell_input", "inject",
    "plan_token", "poison", "replica_delay_s", "should_die",
    "should_die_at_megastep", "should_preempt", "spmd_corrupt_cell_input",
]
