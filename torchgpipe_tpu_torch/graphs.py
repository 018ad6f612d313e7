"""CUDA graphs over static buffers.

The capture recipe shared by the serving Engine's programs and
``GPipe(fused=True)``: :func:`capture` runs a warm-up on a side stream
(cuBLAS handles, the allocator, kernels built at their first launch, the
flash kernels' work lists uploaded once per shape: nothing of that may
happen inside a capture), then captures the body in
``capture_error_mode="global"`` into the owner's one memory pool.
:class:`StaticTree` holds the device buffers a graph reads its inputs
from, filled before each replay by ``copy_``: from a pinned staging
buffer for a host tensor (guarded by an event, so the staging buffer is
written again only after the copy out of it ran), or device to device.
A replay runs no Python: whatever the body does on the host (counters,
Python state) happens once, at capture.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree


def capture(
    body: Callable[[], Any], device: torch.device, pool: Any, *,
    warmup: Optional[Callable[[], Any]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``(graph, warm-up result)``: ``warmup()`` (if given) on a side
    stream, then ``body()`` captured into a new graph in ``pool`` (a
    ``torch.cuda.graph_pool_handle()``).  A replay advances
    ``generator``'s offset as the eager body's draws would.  A capture
    that fails raises."""
    current = torch.cuda.current_stream(device)
    result = None
    if warmup is not None:
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = warmup()
        current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="global"):
        body()
    return graph, result


def tensor_key(tree: Any) -> Hashable:
    """The structure of ``tree`` with each tensor as its shape and dtype
    (other leaves as themselves): what a captured graph is specialised
    to."""
    leaves, spec = pytree.tree_flatten(tree)
    return spec, tuple(
        (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t for t in leaves
    )


class StaticTree:
    """Device buffers for the tensors of a tree of tuples, lists and
    dicts, shaped like ``like``; :meth:`load` copies a tree of the same
    :func:`tensor_key` into them, :attr:`value` is the tree over the
    buffers."""

    def __init__(self, like: Any, device: torch.device) -> None:
        leaves, self._spec = pytree.tree_flatten(like)
        self._bufs: List[Any] = [
            torch.empty(t.shape, dtype=t.dtype, device=device)
            if isinstance(t, torch.Tensor) else t for t in leaves
        ]
        self._host: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self._copied = torch.cuda.Event() if device.type == "cuda" else None
        self.value = pytree.tree_unflatten(self._bufs, self._spec)

    def load(self, tree: Any) -> None:
        leaves, _ = pytree.tree_flatten(tree)
        if self._copied is not None:
            self._copied.synchronize()
        for i, (buf, src) in enumerate(zip(self._bufs, leaves)):
            if not isinstance(src, torch.Tensor):
                continue
            if src.device.type == "cpu" and buf.is_cuda:
                if self._host[i] is None:
                    self._host[i] = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
                self._host[i].copy_(src)
                buf.copy_(self._host[i], non_blocking=True)
            else:
                buf.copy_(src)
        if self._copied is not None:
            self._copied.record()
