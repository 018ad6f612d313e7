"""Tensor and sequence parallelism for the SPMD engine.

Counterpart of ``torchgpipe_tpu/parallel``: Megatron tensor parallelism
(:mod:`.tensor`), ring attention (:mod:`.ring_attention`) and Ulysses
(:mod:`.ulysses`) over the ``tp`` and ``sp`` axes that
:class:`~torchgpipe_tpu_torch.spmd.SpmdGPipe` binds (:mod:`.axes`), and
the static tables of its interleaved (:mod:`.interleaved`) and
zero-bubble (:mod:`.zerobubble`) schedules.
"""

from torchgpipe_tpu_torch.parallel.axes import (  # noqa: F401
    BoundAxis,
    axis_bound,
    bind_axes,
)
from torchgpipe_tpu_torch.parallel.ring_attention import (  # noqa: F401
    attention,
    full_attention,
    ring_attention,
)
from torchgpipe_tpu_torch.parallel.tensor import (  # noqa: F401
    all_gather_value,
    pmax_stop,
    psum_grad,
    psum_value,
)
from torchgpipe_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401

__all__ = ["BoundAxis", "all_gather_value", "attention", "axis_bound", "bind_axes",
           "full_attention", "pmax_stop", "psum_grad", "psum_value", "ring_attention",
           "ulysses_attention"]
