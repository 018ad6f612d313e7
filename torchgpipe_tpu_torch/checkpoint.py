"""Checkpoint modes and phase flags for the pipeline engine.

Counterpart of ``torchgpipe_tpu/checkpoint.py``: the modes,
:func:`checkpoint_stop` and the phase introspection
(:func:`is_checkpointing`, :func:`is_recomputing`, :func:`phase`).  In
the port a checkpointed cell runs its forward under ``torch.no_grad()``
keeping only its input, and recomputes with gradients on in the backward
schedule before its cotangent is applied (recompute-ahead).  The flags
are runtime flags here: a layer reads them while the cell runs.

``'offload'`` is the ``'never'`` schedule (stop 0: no cell recomputes)
with each cell's saved tensors in pinned host memory between its
forward and its backward (:class:`Offload`).

Not ported: the reference's named-save remat policies
(``NAMED_SAVE_POINTS``, ``policies``), which are ``jax.checkpoint``
machinery with no eager counterpart.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Optional

import torch

CHECKPOINT_MODES = ("always", "except_last", "never", "offload")


def checkpoint_stop(mode: str, chunks: int, *, train: bool) -> int:
    """Micro-batches ``[0, stop)`` are checkpointed (none at eval, and
    none under ``'offload'``, which keeps every cell's residuals, in host
    memory)."""
    if mode not in CHECKPOINT_MODES:
        raise ValueError(
            f"checkpoint is not one of {CHECKPOINT_MODES!r}: {mode!r}"
        )
    if not train or mode == "offload":
        return 0
    return {"always": chunks, "except_last": chunks - 1, "never": 0}[mode]


class _Saved:
    """One saved tensor of a cell: on its device until the cell's forward
    ends, then (a CUDA tensor) in pinned host memory until it is fetched
    for the backward."""

    __slots__ = ("dev", "host", "device", "copied")

    def __init__(self, t: torch.Tensor) -> None:
        self.dev: Optional[torch.Tensor] = t
        self.host: Optional[torch.Tensor] = None
        self.device = t.device
        self.copied: Any = None   # the event after the copy to the host

    def get(self) -> torch.Tensor:
        if self.dev is None:   # not fetched ahead: bring it back here
            self.copied.synchronize()
            self.dev = self.host.to(self.device)
            self.host = None
        return self.dev


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Offload:
    """``checkpoint='offload'`` for one training step.

    :meth:`cell` runs a cell's forward under saved-tensor hooks: every
    tensor autograd saves, but for those that stay on the device anyway
    (views of the cell's inputs and of its stage's parameters), is
    recorded once: once per storage for whole-storage views (reshapes),
    else once per view.  As the forward ends, the CUDA ones
    are copied to pinned host memory on a side stream, and their device
    memory is released once the copies have run.  :meth:`fetch` copies
    a cell's tensors back on that stream (the schedule fetches the next
    cell while the current cell's backward runs) and makes the current
    stream wait for them.  A CPU stage's tensors stay where they are:
    its memory is host memory already.

    ``saved_bytes`` counts the bytes of the recorded tensors,
    ``moved_bytes`` those copied to the host."""

    def __init__(self) -> None:
        self.saved_bytes = 0
        self.moved_bytes = 0
        self._cells: Dict[Hashable, List[_Saved]] = {}
        self._ready: Dict[Hashable, Any] = {}
        self._streams: Dict[torch.device, Any] = {}

    def _side(self, device: torch.device) -> Any:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @contextlib.contextmanager
    def cell(self, key: Hashable, device: torch.device,
             keep: Iterable[torch.Tensor]) -> Iterator[None]:
        """Record the saved tensors of the forward run inside, keyed by
        ``key``; ``keep`` are tensors whose storage stays on the device
        (the cell's inputs, the stage's parameters)."""
        skip = {_storage(t) for t in keep}
        seen: Dict[tuple, _Saved] = {}
        saved: List[_Saved] = []

        def pack(t: torch.Tensor) -> Any:
            if _storage(t) in skip:
                return t
            # A contiguous view of a whole storage (a reshape) is taken
            # once per storage, flat; any other view once per view.
            whole = t.is_contiguous() and t.storage_offset() == 0 and \
                t.numel() * t.element_size() == t.untyped_storage().nbytes()
            key = (_storage(t), t.dtype) if whole else \
                (_storage(t), t.storage_offset(), tuple(t.shape), t.stride(), t.dtype)
            if key not in seen:
                seen[key] = _Saved(t.reshape(-1) if whole else t)
                saved.append(seen[key])
                self.saved_bytes += t.numel() * t.element_size()
            return seen[key], (tuple(t.shape) if whole else None)

        def unpack(packed: Any) -> torch.Tensor:
            if isinstance(packed, torch.Tensor):
                return packed
            h, shape = packed
            return h.get() if shape is None else h.get().view(shape)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
        self._cells[key] = saved
        if device.type != "cuda":
            return
        side = self._side(device)
        side.wait_stream(torch.cuda.current_stream(device))
        copied = torch.cuda.Event()
        with torch.cuda.stream(side):
            for h in saved:
                t = h.dev
                h.host = torch.empty_like(t, device="cpu", pin_memory=True)
                h.host.copy_(t, non_blocking=True)
                t.record_stream(side)
                h.dev, h.copied = None, copied
                self.moved_bytes += t.numel() * t.element_size()
            copied.record(side)

    def fetch(self, key: Hashable, device: torch.device) -> None:
        """Issue the copies of cell ``key``'s tensors back to ``device``
        (once)."""
        if key in self._ready or device.type != "cuda":
            return
        side = self._side(device)
        side.wait_stream(torch.cuda.current_stream(device))
        pending = [h for h in self._cells.get(key, ()) if h.dev is None]
        devs = [torch.empty_like(h.host, device=device) for h in pending]
        with torch.cuda.stream(side):
            for h, d in zip(pending, devs):
                d.copy_(h.host, non_blocking=True)
                h.dev, h.host = d, None
            self._ready[key] = torch.cuda.Event()
            self._ready[key].record(side)

    def before_backward(self, key: Hashable, device: torch.device,
                        nxt: Optional[Hashable], nxt_device: Optional[torch.device]) -> None:
        """Cell ``key``'s tensors on ``device`` before its backward runs,
        and the next cell's (``nxt``) on their way: one cell ahead, so
        the copy overlaps this backward (each cell more of depth would
        hold one more cell's residuals on the device)."""
        self.fetch(key, device)
        if nxt is not None:
            self.fetch(nxt, nxt_device)
        ready = self._ready.pop(key, None)
        if ready is not None:
            torch.cuda.current_stream(device).wait_event(ready)
        self._cells.pop(key, None)


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
