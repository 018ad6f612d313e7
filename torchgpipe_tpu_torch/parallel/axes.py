"""Mesh axes bound to the layers that collect over them.

JAX finds a collective's axis by name inside ``shard_map``; PyTorch has no
such scope.  :class:`~torchgpipe_tpu_torch.spmd.SpmdGPipe` therefore binds
its sequence- and tensor-parallel axes (:func:`bind_axes`) around every
step it runs, and a layer asks :func:`axis_bound` for an axis by name: the
:class:`BoundAxis` while the engine runs it, None elsewhere.  Unbound, the
same layer computes the unsharded math (its tensors are the whole
sequence, its weights whole), which is what lets ``init``, an oracle and
``generate`` run the modules unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch

# The axes bound in this context (a thread or task of its own sees its own).
_BOUND: contextvars.ContextVar[Dict[str, "BoundAxis"]] = contextvars.ContextVar(
    "torchgpipe_tpu_torch_bound_axes", default={})


class BoundAxis:
    """One mesh axis of this process's :class:`~torchgpipe_tpu_torch.spmd.Mesh`:
    its ``name``, ``size`` and this rank's ``index`` along it, and the
    collectives over the ranks that differ from this one only along it
    (staged through the host under gloo on a card and counted in
    ``mesh.staged_bytes`` under ``kind``)."""

    def __init__(self, mesh: Any, name: str, kind: str):
        self.mesh, self.name, self.kind = mesh, name, kind
        self.size = mesh.shape[name]
        self.index = mesh.coords[name]

    def __repr__(self) -> str:
        return f"BoundAxis({self.name!r}, index={self.index}, size={self.size})"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce(t, self.name, op=op, kind=self.kind)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The lanes' ``t`` concatenated along ``dim`` in lane order."""
        return torch.cat(self.mesh.all_gather(t, self.name, kind=self.kind), dim)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``t`` into ``size`` equal chunks along ``split_dim``, send
        chunk ``p`` to lane ``p`` and concatenate what every lane sent this
        one along ``concat_dim``, in lane order (``lax.all_to_all(...,
        tiled=True)``)."""
        chunks = list(t.chunk(self.size, split_dim))
        return torch.cat(self.mesh.all_to_all(chunks, self.name, kind=self.kind),
                         concat_dim)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the next lane of the ring (``index + 1``) and
        return what the previous one sent (``lax.ppermute`` over ``j ->
        j + 1``)."""
        return self.mesh.shift(t, self.name, kind=self.kind)


class _AllToAll(torch.autograd.Function):
    """:meth:`BoundAxis.all_to_all` under autograd; its backward is the
    inverse exchange (the split and concatenated dims swapped)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: BoundAxis, split_dim: int, concat_dim: int):
        ctx.args = (ax, split_dim, concat_dim)
        return ax.all_to_all(x.contiguous(), split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ax, split_dim, concat_dim = ctx.args
        return ax.all_to_all(g.contiguous(), concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, ax: BoundAxis, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """The differentiable all-to-all over a bound axis (``lax.all_to_all(...,
    tiled=True)``): Ulysses' sequence/head swaps and the expert layer's
    dispatch to the lanes that own its experts share it."""
    return _AllToAll.apply(x, ax, split_dim, concat_dim)


def axis_bound(name: Optional[str]) -> Optional[BoundAxis]:
    """The :class:`BoundAxis` of ``name`` while an engine runs a layer over
    it, else None (``name`` None too)."""
    if name is None:
        return None
    return _BOUND.get().get(name)


def require_axis(name: str) -> BoundAxis:
    """:func:`axis_bound`, raising when ``name`` is not bound (the
    reference's unbound collective raises a ``NameError``)."""
    ax = axis_bound(name)
    if ax is None:
        raise NameError(
            f"mesh axis {name!r} is not bound: collectives over it run inside "
            "SpmdGPipe's steps (or a spmd.bind_axes(mesh, ...) block)")
    return ax


@contextlib.contextmanager
def bind_axes(mesh: Any, names: Sequence[Optional[str]],
              kinds: Optional[Sequence[str]] = None) -> Iterator[List[BoundAxis]]:
    """Bind ``names`` (None entries skipped) of ``mesh`` for the duration of
    the block; ``kinds`` labels each axis's host staging in
    ``mesh.staged_by`` (default: the axis name)."""
    kinds = list(kinds) if kinds is not None else list(names)
    bound = [BoundAxis(mesh, name, kind or name)
             for name, kind in zip(names, kinds) if name is not None]
    token = _BOUND.set(dict(_BOUND.get(), **{ax.name: ax for ax in bound}))
    try:
        yield bound
    finally:
        _BOUND.reset(token)
