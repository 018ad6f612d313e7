"""Checkpoint modes and phase flags for the pipeline engine.

Counterpart of ``torchgpipe_tpu/checkpoint.py``: the modes,
:func:`checkpoint_stop` and the phase introspection
(:func:`is_checkpointing`, :func:`is_recomputing`, :func:`phase`).  In
the port a checkpointed cell runs its forward under ``torch.no_grad()``
keeping only its input, and recomputes with gradients on in the backward
schedule before its cotangent is applied (recompute-ahead).  The flags
are runtime flags here: a layer reads them while the cell runs.

Not ported: ``'offload'`` (a saved-tensor hook to pinned host memory,
ROADMAP.md queue A item 2), and the reference's named-save remat policies
(``NAMED_SAVE_POINTS``, ``policies``), which are ``jax.checkpoint``
machinery with no eager counterpart.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from torchgpipe_tpu_torch.models.transformer import not_ported

CHECKPOINT_MODES = ("always", "except_last", "never", "offload")


def checkpoint_stop(mode: str, chunks: int, *, train: bool) -> int:
    """Micro-batches ``[0, stop)`` are checkpointed (none at eval)."""
    if mode not in CHECKPOINT_MODES:
        raise ValueError(
            f"checkpoint is not one of {CHECKPOINT_MODES!r}: {mode!r}"
        )
    if mode == "offload":
        raise not_ported("checkpoint='offload' (residuals in host memory)", "2")
    if not train:
        return 0
    return {"always": chunks, "except_last": chunks - 1, "never": 0}[mode]


class _Phase(threading.local):
    def __init__(self) -> None:
        self.checkpointing = False
        self.recomputing = False


_phase = _Phase()


def is_checkpointing() -> bool:
    """True while a checkpointed (no-residual) forward runs."""
    return _phase.checkpointing


def is_recomputing() -> bool:
    """True while a checkpointed cell recomputes its forward in the
    backward schedule."""
    return _phase.recomputing


@contextlib.contextmanager
def phase(*, checkpointing: bool = False, recomputing: bool = False) -> Iterator[None]:
    """Set the phase flags for the cell that runs inside."""
    prev = (_phase.checkpointing, _phase.recomputing)
    _phase.checkpointing = checkpointing
    _phase.recomputing = recomputing
    try:
        yield
    finally:
        _phase.checkpointing, _phase.recomputing = prev
