"""Transient-failure classification and the retry policy.

Counterpart of ``classify_error`` and ``GuardPolicy`` in
``torchgpipe_tpu/resilience/guard.py`` (``:74-111``).  The serving
engine retries a step under them (``Engine._dispatch``).  ``StepGuard``,
the training-step wrapper with its non-finite skip, is not ported yet
(ROADMAP.md, queue A item 2).

The classification is keyed on what a CUDA process raises:

* transient (a retry can succeed): ``ConnectionError`` and its
  subclasses, ``TimeoutError``, and ``torch.cuda.OutOfMemoryError``
  (the caching allocator's counterpart of XLA's ``RESOURCE_EXHAUSTED``:
  freed blocks return once the stream drains);
* fatal: everything else, a CUDA runtime or launch error included.
  Those are sticky: the context is lost, and no retry in the same
  process can succeed.
"""

from __future__ import annotations

import dataclasses

import torch


def classify_error(err: BaseException) -> str:
    """``'transient'`` (retry can help) or ``'fatal'`` (re-raise now)."""
    if isinstance(err, (ConnectionError, TimeoutError, torch.cuda.OutOfMemoryError)):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Retry knobs (defaults are the reference's).  ``skip_nonfinite`` is
    kept for the reference's signature; only ``StepGuard`` reads it."""

    max_retries: int = 3          # transient retries per step
    backoff_base: float = 0.25    # seconds; doubles per attempt
    backoff_max: float = 8.0      # cap on a single sleep
    skip_nonfinite: bool = True   # skip-step on non-finite loss/params

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base * (2.0 ** attempt), self.backoff_max)


__all__ = ["GuardPolicy", "classify_error"]
