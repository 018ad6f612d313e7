"""Scatter a mini-batch into micro-batches and gather them back.

Counterpart of ``torchgpipe_tpu/microbatch.py`` (``check``,
``batch_size``, ``chunk_sizes``, ``scatter``, ``gather``).  A mini-batch
is a pytree (tensor, tuple, list or dict, as ``torch.utils._pytree``
flattens it) of tensors sharing the leading (batch) dimension: a packed
batch is the dict ``{"tokens", "segment_ids", "positions"}``.  Chunks
follow ``torch.chunk`` size semantics: ceil-sized, the last one short,
possibly fewer than asked for.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence

import torch
import torch.utils._pytree as pytree

Batch = Any   # a pytree of tensors


def _leaves(value: Batch) -> List:
    return pytree.tree_leaves(value)


def check(value: Batch) -> None:
    """Validate a mini-batch: a non-empty pytree of tensors with a
    common leading dimension (the reference's messages)."""
    leaves = _leaves(value)
    if not leaves:
        raise TypeError("expected a non-empty pytree of arrays as input")
    sizes = set()
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"expected arrays as batch leaves, got {type(leaf).__name__}"
            )
        if leaf.ndim == 0:
            raise TypeError("batch leaves must have a leading batch dimension")
        sizes.add(leaf.shape[0])
    if len(sizes) != 1:
        raise ValueError(
            "all batch leaves must share the leading batch dimension, got "
            f"{sorted(sizes)}"
        )


def batch_size(value: Batch) -> int:
    """Leading-dimension size of a mini-batch."""
    return _leaves(value)[0].shape[0]


def chunk_sizes(total: int, chunks: int) -> List[int]:
    """``torch.chunk`` size semantics: 7 into 4 -> ``[2, 2, 2, 1]``;
    3 into 4 -> ``[1, 1, 1]``."""
    if total <= 0:
        raise ValueError("batch size must be positive")
    if chunks <= 0:
        raise ValueError("chunks must be positive")
    size = math.ceil(total / chunks)
    out: List[int] = []
    remaining = total
    while remaining > 0:
        take = min(size, remaining)
        out.append(take)
        remaining -= take
    return out


def scatter(value: Batch, chunks: int) -> List[Batch]:
    """Split a mini-batch into a list of micro-batches (views, no copy)."""
    check(value)
    sizes = chunk_sizes(batch_size(value), chunks)
    leaves, spec = pytree.tree_flatten(value)
    parts = [leaf.split(sizes) for leaf in leaves]
    return [pytree.tree_unflatten([p[i] for p in parts], spec)
            for i in range(len(sizes))]


def gather(microbatches: Sequence[Batch]) -> Batch:
    """Concatenate micro-batches back into one mini-batch."""
    if not microbatches:
        raise ValueError("no micro-batches to gather")
    flat = [pytree.tree_flatten(mb) for mb in microbatches]
    spec = flat[0][1]
    return pytree.tree_unflatten(
        [torch.cat(list(leaves)) for leaves in zip(*(f[0] for f in flat))], spec)
