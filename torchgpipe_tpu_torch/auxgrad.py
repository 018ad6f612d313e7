"""Scale of injected auxiliary gradients.

Counterpart of ``torchgpipe_tpu/auxgrad.py``.  A layer that injects an
auxiliary objective's gradient through an identity whose backward adds
it (:func:`torchgpipe_tpu_torch.models.moe.add_aux_grad`) runs once per
micro-batch, while the pipeline's task loss is reduced over the whole
mini-batch, so a constant injection would multiply the auxiliary
coefficient by the number of micro-batches.  The pipeline sets this
scale to ``1/m`` (``m`` the micro-batches of the current run) around
every cell's forward, and around a checkpointed cell's recompute too;
an injection site reads it when its forward runs and keeps it for its
backward.  The optimized objective is then
``task_loss + weight * mean_over_microbatches(aux)`` whatever the chunk
count.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator


class _Scale(threading.local):
    def __init__(self) -> None:
        self.value = 1.0


_scale = _Scale()


def current_aux_scale() -> Any:
    """The scale an aux-gradient injection running now applies."""
    return _scale.value


@contextlib.contextmanager
def aux_scale(value: Any) -> Iterator[None]:
    """Set the aux-gradient scale (used by the pipeline)."""
    prev = _scale.value
    _scale.value = value
    try:
        yield
    finally:
        _scale.value = prev
