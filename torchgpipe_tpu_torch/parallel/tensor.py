"""Tensor-parallelism primitives (Megatron style) over a bound mesh axis.

Counterpart of ``torchgpipe_tpu/parallel/tensor.py``.  Weights of a
parallel region are sharded over a ``tp`` axis (column-parallel input
projections, row-parallel output projection) and the activations entering
and leaving the region are replicated.  Two collectives make the math
exact (Shoeybi et al., "Megatron-LM", arXiv:1909.08053):

* region exit, :func:`psum_value`: the sum of the lanes' partial outputs
  forward, the identity backward (everything downstream is replicated, so
  each lane already holds the whole cotangent; a sum there would count it
  ``tp`` times);
* region entry, :func:`psum_grad`: the identity forward, the sum of the
  lanes' cotangents backward (each lane back-propagates only its own heads'
  or hidden units' share).

With both in place every activation outside a region, and so the gradient
of every tp-replicated parameter, is the same on every lane; parameters
sharded over tp keep lane-local gradients.  :func:`all_gather_value`'s
backward is a slice and :func:`pmax_stop`'s gradient is zero, each pinned
for the same reason.  Each is a ``torch.autograd.Function`` over the axis
that :func:`~torchgpipe_tpu_torch.parallel.axes.axis_bound` names; the
backward uses the axis bound at the forward.
"""

from __future__ import annotations

from typing import Any

import torch

from torchgpipe_tpu_torch.parallel.axes import BoundAxis, require_axis

Pytree = Any

__all__ = ["all_gather_value", "partition_rules", "pmax_stop", "psum_grad",
           "psum_value"]


def partition_rules(tp_axis: str, pp_axis: str = "pp") -> Any:
    """The Megatron layout as a regex rule table of the analysis layer,
    which is ROADMAP.md queue A item 5.6; the transformer block declares
    the same layout in ``meta['param_specs']``."""
    from torchgpipe_tpu_torch.models.transformer import not_ported

    raise not_ported("parallel.tensor.partition_rules (analysis.partition_rules)", "5.6")


def _map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.ax.all_reduce(g), None


class _PsumValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
        return ax.all_reduce(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _PmaxStop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
        return ax.all_reduce(x, op="max")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return torch.zeros_like(g), None


class _AllGatherValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: BoundAxis, dim: int) -> torch.Tensor:
        ctx.ax, ctx.dim, ctx.local = ax, dim % x.ndim, x.shape[dim % x.ndim]
        return ax.all_gather(x, ctx.dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        lo = ctx.ax.index * ctx.local
        return g.narrow(ctx.dim, lo, ctx.local).contiguous(), None, None


def psum_grad(x: Pytree, axis_name: str) -> Pytree:
    """Identity forward; the sum of the cotangent over ``axis_name``
    backward.  Place at the entry of a tensor-parallel region (the Megatron
    "f" operator)."""
    ax = require_axis(axis_name)
    return _map(lambda t: _PsumGrad.apply(t, ax), x)


def psum_value(x: Pytree, axis_name: str) -> Pytree:
    """The sum over ``axis_name`` forward; identity backward.  Place at the
    exit of a tensor-parallel region (the Megatron "g" operator)."""
    ax = require_axis(axis_name)
    return _map(lambda t: _PsumValue.apply(t, ax), x)


def pmax_stop(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The maximum over ``axis_name`` with a zero gradient: for
    log-sum-exp shifts, whose gradient contribution cancels."""
    return _PmaxStop.apply(x, require_axis(axis_name))


def all_gather_value(x: torch.Tensor, axis_name: str, axis: int = -1) -> torch.Tensor:
    """The lanes' shards concatenated along ``axis`` in lane order
    forward; backward each lane keeps its own shard's slice of the
    (replicated) cotangent, not the reduce-scatter that would count it
    once per lane.  The vocab-parallel head's full logits
    (``LMHead(gather_logits=True)``)."""
    return _AllGatherValue.apply(x, require_axis(axis_name), axis)
