"""Automatic stage balancing: per-layer costs -> exact block partition.

Counterpart of ``torchgpipe_tpu/balance/__init__.py``.  Usage::

    from torchgpipe_tpu_torch.balance import balance_by_flops

    balance = balance_by_flops(4, layers, sample)
    model = GPipe(layers, balance, chunks=8)

Three cost sources, each fed to :func:`blockpartition.solve_sizes`
(minimise the bottleneck stage's sum):

* :func:`balance_by_flops`: per-layer forward+backward FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over copies of the layers
  on the meta device: shapes only, no memory, no device time,
  deterministic.  Matmuls and convolutions count; elementwise glue does
  not (the reference's walker weighs the same ops).
* :func:`balance_by_time`: measured per-layer forward+backward time on
  the layers' device (CUDA events on the card).
* :func:`balance_by_size`: per-layer memory from the allocator.

The sample is one micro-batch's input; skips are threaded from layer to
layer as the pipeline threads them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from torchgpipe_tpu_torch.balance import blockpartition
from torchgpipe_tpu_torch.balance.profile import (
    layer_fwd_bwd,
    meta_sandbox,
    profile_sizes,
    profile_times,
    sweep,
)
from torchgpipe_tpu_torch.models.transformer import Device

__all__ = [
    "balance_by_flops",
    "balance_by_time",
    "balance_by_size",
    "balance_cost",
    "layer_flops",
]


def balance_cost(costs: Sequence[float], partitions: int) -> List[int]:
    """Turn per-layer costs into a balance via exact block partitioning."""
    return blockpartition.solve_sizes(costs, partitions)


def layer_flops(layers: Sequence[nn.Module], sample: torch.Tensor) -> List[float]:
    """Per-layer forward+backward FLOPs, counted on meta copies of the
    layers (the caller's model is not touched and no device runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    flops: List[float] = []

    def count(i: int, layer: nn.Module, x: torch.Tensor, pops: Dict):
        with FlopCounterMode(display=False) as counter:
            out = layer_fwd_bwd(layer, x, pops)
        flops.append(float(counter.get_total_flops()))
        return out

    sweep(layers, sample.to("meta"), meta_sandbox, count)
    return flops


def balance_by_flops(
    partitions: int, layers: Sequence[nn.Module], sample: torch.Tensor
) -> List[int]:
    """Balance by counted per-layer forward+backward FLOPs
    (:func:`layer_flops`)."""
    return balance_cost(layer_flops(layers, sample), partitions)


def balance_by_time(
    partitions: int,
    layers: Sequence[nn.Module],
    sample: torch.Tensor,
    *,
    timeout: float = 1.0,
    device: Device = None,
) -> List[int]:
    """Balance by profiled forward+backward time per layer on ``device``
    (``cuda`` unless named): each call costs about ``timeout`` seconds of
    real device time, and its numbers vary with what else runs."""
    return balance_cost(
        profile_times(layers, sample, timeout=timeout, device=device), partitions
    )


def balance_by_size(
    partitions: int,
    layers: Sequence[nn.Module],
    sample: torch.Tensor,
    *,
    param_scale: float = 2.0,
    device: Device = None,
) -> List[int]:
    """Balance by per-layer memory: ``param_scale`` times the parameter
    bytes plus the activation bytes of a forward+backward."""
    return balance_cost(
        profile_sizes(layers, sample, param_scale=param_scale, device=device),
        partitions,
    )
