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

The named-save remat policies (:data:`NAMED_SAVE_POINTS`,
:class:`NamedSavePolicy`, :data:`policies`) refine a checkpointed cell:
its no-grad forward keeps the values its policy names, and its recompute
takes them instead of computing them again (:class:`Remat`).  A value is
named where the model tags it (:func:`checkpoint_name`), at the
reference's points: ``attn_out`` and ``mlp_hidden`` in the transformer
block, ``ce_logits`` in the head, ``flash_out`` and ``flash_stats`` (the
flash kernel's O and LSE) in ``ops/flash_attention.py``.  The
``flash_*`` pair is kept by the flash ``autograd.Function`` itself, so a
recompute under ``policies.save_flash_stats`` launches no forward
kernel.  The other names, and ``policies.dots_no_batch`` (every product
with a 2-D weight, ``aten.mm``/``aten.addmm``), go through a
``TorchDispatchMode`` over the cell, as torch's selective-checkpoint
caching modes do: the forward keeps the output of the op that produced a
named value (the k-th call of that op in the cell), and the recompute's
k-th call of that op returns it without running.  The values are the
ones the recompute would have produced (the cell is deterministic), so
the gradients are bitwise those of the policy-free cell.  A value that
something writes in place after its op made it (a tensor-parallel
all-reduce into a cloned buffer, where the collectives are not staged
through the host) is not what that op makes, so it is not kept: the
recompute makes it again.  An offload
policy (``policies.offload_names``) keeps its values in pinned host
memory between the forward and the recompute (in a captured step, in
buffers that the warm-up made and the graph holds: :class:`HostBuffers`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

CHECKPOINT_MODES = ("always", "except_last", "never", "offload")

# The named save points the model zoo tags (the reference's list).
NAMED_SAVE_POINTS = (
    "attn_out",     # attention output projection (block residual branch)
    "mlp_hidden",   # feed-forward hidden activation (gate*up / fc act)
    "ce_logits",    # lm-head logits (the [tokens, vocab] matrix)
    "flash_out",    # flash-attention kernel output (vjp residual)
    "flash_stats",  # flash-attention log-sum-exp rows (vjp residual)
)


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


# --------------------------------------------------------------------- #
# named-save remat policies                                             #
# --------------------------------------------------------------------- #


class NamedSavePolicy:
    """A remat policy over named save points: ``names`` are kept by a
    checkpointed cell's forward (on the device, or with ``offload`` in
    pinned host memory) and not recomputed.  ``label`` says what it does
    (``"save:attn_out"``, ``"offload:..."``); ``default_preset`` marks the
    catch-all :meth:`_Policies.offload_default`."""

    ops: Tuple[Any, ...] = ()

    def __init__(self, names: Tuple[str, ...], *, offload: bool = False,
                 label: Optional[str] = None, default_preset: bool = False) -> None:
        self.names = tuple(names)
        self.offload = bool(offload)
        self.default_preset = default_preset
        self.label = label or (("offload:" if self.offload else "save:") + ",".join(self.names))

    def __repr__(self) -> str:
        return f"NamedSavePolicy({self.label!r})"


class OpSavePolicy(NamedSavePolicy):
    """A remat policy over ops, not names: the outputs of ``ops`` are kept
    (``policies.dots_no_batch``: the products with a 2-D weight;
    ``policies.nothing_saveable``: nothing, ``'always'`` spelled as a
    policy)."""

    def __init__(self, label: str, ops: Tuple[Any, ...]) -> None:
        super().__init__((), label=label)
        self.ops = tuple(ops)


class _Policies:
    """Preset remat policies for ``SpmdGPipe(remat_policy=)`` and
    ``GPipe(fused=True, remat_policy=...)``: named points on the
    recompute/memory curve between ``checkpoint='always'`` (save nothing)
    and ``'never'`` (save everything)."""

    @property
    def save_attn_out(self) -> NamedSavePolicy:
        """Keep the attention branch's output (one ``[b, s, dim]`` tensor a
        block)."""
        return NamedSavePolicy(("attn_out",))

    @property
    def save_block_outputs(self) -> NamedSavePolicy:
        """Keep the attention output and the feed-forward hidden."""
        return NamedSavePolicy(("attn_out", "mlp_hidden"))

    @property
    def save_flash_stats(self) -> NamedSavePolicy:
        """Keep the flash kernel's O and LSE, so the recompute never
        launches the forward kernel."""
        return NamedSavePolicy(("flash_out", "flash_stats"))

    @property
    def dots_no_batch(self) -> OpSavePolicy:
        """Keep every product with no batch dims (a 2-D weight: ``aten.mm``
        and ``aten.addmm``), recompute the rest; name-free, so it applies to
        any model."""
        aten = torch.ops.aten
        return OpSavePolicy("dots_no_batch", (aten.mm.default, aten.addmm.default))

    @property
    def nothing_saveable(self) -> OpSavePolicy:
        """Keep nothing: ``checkpoint='always'`` as an explicit policy."""
        return OpSavePolicy("nothing_saveable", ())

    def save_names(self, *names: str) -> NamedSavePolicy:
        """Keep exactly these named values on the device."""
        return NamedSavePolicy(tuple(names))

    def offload_names(self, *names: str) -> NamedSavePolicy:
        """Keep exactly these named values in pinned host memory between
        the forward and the recompute."""
        return NamedSavePolicy(tuple(names), offload=True)

    def offload_default(self) -> NamedSavePolicy:
        """Every canonical named save point (:data:`NAMED_SAVE_POINTS`) in
        host memory."""
        return NamedSavePolicy(NAMED_SAVE_POINTS, offload=True, label="offload_default",
                               default_preset=True)


policies = _Policies()


def check_policy(policy: Any) -> None:
    """Refuse a remat policy the port cannot apply: it takes the presets
    of :data:`policies` (a :class:`NamedSavePolicy`), not ``jax.checkpoint``
    policy callables."""
    if policy is not None and not isinstance(policy, NamedSavePolicy):
        raise TypeError(
            f"remat_policy must be a checkpoint.policies preset or a "
            f"checkpoint.NamedSavePolicy, got {type(policy).__name__}")


class _Held:
    """One kept value: the tensor (or, with ``host``, its copy in that
    pinned host buffer) and what the recompute checks before taking it
    (its version and the producing op's input shapes)."""

    __slots__ = ("t", "host", "device", "version", "sig")

    def __init__(self, t: torch.Tensor, host: Optional[torch.Tensor] = None,
                 sig: Any = None) -> None:
        self.version, self.sig, self.device, self.host = t._version, sig, t.device, host
        self.t: Optional[torch.Tensor] = t.detach()
        if host is not None:
            host.copy_(t, non_blocking=True)
            self.t = None

    @property
    def nbytes(self) -> int:
        t = self.t if self.t is not None else self.host
        return t.numel() * t.element_size()

    def get(self) -> torch.Tensor:
        if self.t is None:
            return self.host.to(self.device, non_blocking=True)
        if self.t._version != self.version:
            raise RuntimeError(
                "a value a remat policy kept was changed in place after the "
                "forward kept it; the recompute cannot take it")
        return self.t


def _sig(args: Any) -> Tuple:
    return tuple((tuple(a.shape), a.dtype) for a in args if isinstance(a, torch.Tensor))


def _key(t: torch.Tensor) -> Tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype)


def _writes(func: Any, kwargs: Dict[str, Any]) -> bool:
    """Whether ``func`` may write into a tensor it is given: in place by
    name (``mul_``, and ``c10d.allreduce_``, whose schema marks no write),
    by its schema, or through ``out=``."""
    schema = func._schema
    return (schema.name.endswith("_") or "out" in kwargs
            or any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments))


class _OpCache(TorchDispatchMode):
    """A cell's ops below autograd: in the forward (``use=False``) it keeps
    the outputs the policy's ops make and remembers which op made each
    other output (by storage, with the version it had); in the recompute
    it returns the kept output of the k-th call of an op instead of
    running it.  An output that a later op writes in place (an all-reduce
    into a cloned buffer) is no longer what its op made: it is forgotten,
    or dropped if kept, and the recompute runs that op again."""

    def __init__(self, cell: "_CellStore", use: bool) -> None:
        super().__init__()
        self.cell, self.use = cell, use
        self.calls: Dict[Any, int] = {}
        self.made: Dict[int, Tuple[Tuple, Any, int, Tuple, int]] = {}
        self.kept: Dict[int, Tuple[Any, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.use and _writes(func, kwargs):
            for x in pytree.tree_leaves((args, kwargs)):
                if isinstance(x, torch.Tensor):
                    self.written(x)
        if _state.opaque:
            return func(*args, **kwargs)
        k = self.calls.get(func, 0)
        self.calls[func] = k + 1
        if self.use:
            held = self.cell.ops.pop((func, k), None)
            if held is None:
                return func(*args, **kwargs)
            if held.sig != _sig(args):
                raise RuntimeError(
                    f"remat policy: the recompute's call {k} of {func} takes other "
                    "inputs than the forward's; the cell does not run the same ops twice")
            return held.get()
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and not func.is_view and not _writes(func, kwargs):
            if func in self.cell.policy.ops:
                self.cell.keep_op(func, k, out, _sig(args))
            else:
                self.made[_storage(out)] = (_key(out), func, k, _sig(args), out._version)
        return out

    def written(self, x: torch.Tensor) -> None:
        ptr = _storage(x)
        self.made.pop(ptr, None)
        kept = self.kept.pop(ptr, None)
        if kept is not None:
            self.cell.drop_op(kept)


class _CellStore:
    """What one checkpointed cell's forward kept: the flash calls' ``(o,
    lse)`` pairs in call order, and op outputs by ``(op, call)``."""

    def __init__(self, remat: "Remat") -> None:
        self.remat, self.policy = remat, remat.policy
        self.flash: List[Tuple[_Held, _Held]] = []
        self.ops: Dict[Tuple[Any, int], _Held] = {}
        self.mode: Optional[_OpCache] = None

    def keep_op(self, func: Any, k: int, t: torch.Tensor, sig: Tuple) -> None:
        if (func, k) not in self.ops:
            self.ops[(func, k)] = self.remat.held(t, sig)
            self.mode.kept[_storage(t)] = (func, k)

    def drop_op(self, fk: Tuple[Any, int]) -> None:
        held = self.ops.pop(fk, None)
        if held is not None:
            self.remat.saved_bytes -= held.nbytes

    def keep_named(self, t: torch.Tensor) -> None:
        """Keep the output of the op that made ``t`` (or the tensor ``t``
        views), unless something wrote into it since: then the recompute
        makes it again."""
        if self.mode is None:
            return
        base = t if t._base is None else t._base
        made = self.mode.made.get(_storage(base))
        if made is not None and made[0] == _key(base) and made[4] == base._version:
            self.keep_op(made[1], made[2], base, made[3])


class _State(threading.local):
    def __init__(self) -> None:
        self.cell: Optional[_CellStore] = None
        self.use = False
        self.opaque = 0


_state = _State()


class HostBuffers:
    """The pinned host buffers of one captured step's offloaded values.
    The eager warm-up makes them, in the order the step keeps its values;
    the capture takes them in that order (no pinned memory is allocated
    while a stream is captured), and the graph holds them, so every
    replay copies through the same memory."""

    def __init__(self) -> None:
        self.bufs: List[torch.Tensor] = []
        self.next = 0

    def take(self, t: torch.Tensor) -> torch.Tensor:
        if self.next == len(self.bufs):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "remat policy: the captured step offloads more values than its warm-up")
            self.bufs.append(torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True))
        buf = self.bufs[self.next]
        if buf.shape != t.shape or buf.dtype != t.dtype:
            raise RuntimeError(
                "remat policy: the captured step offloads other values than its warm-up")
        self.next += 1
        return buf


class Remat:
    """A remat policy applied over one training step: :meth:`forward`
    around a checkpointed cell's no-grad forward keeps what ``policy``
    names, :meth:`recompute` around its recompute hands it back (and
    checks that every kept value was taken).  ``saved_bytes`` counts the
    kept bytes of the step.  An offload policy copies each value on the
    card into pinned host memory: a fresh buffer, or with ``host`` (a
    captured step's :class:`HostBuffers`) the next of its buffers."""

    def __init__(self, policy: NamedSavePolicy, host: Optional[HostBuffers] = None) -> None:
        check_policy(policy)
        self.policy, self.host = policy, host
        if host is not None:
            host.next = 0
        names = set(policy.names)
        self.flash = {"flash_out", "flash_stats"} <= names
        self.by_ops = bool(policy.ops) or bool(names - {"flash_out", "flash_stats"})
        self.saved_bytes = 0
        self._cells: Dict[Hashable, _CellStore] = {}

    def held(self, t: torch.Tensor, sig: Any = None) -> _Held:
        """Keep ``t`` (counted in ``saved_bytes``), offloaded if the policy
        says so and ``t`` is on the card."""
        host = None
        if self.policy.offload and t.device.type == "cuda":
            host = self.host.take(t) if self.host is not None else torch.empty(
                t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
        held = _Held(t, host, sig)
        self.saved_bytes += held.nbytes
        return held

    @contextlib.contextmanager
    def _active(self, cell: _CellStore, use: bool) -> Iterator[None]:
        prev = (_state.cell, _state.use)
        _state.cell, _state.use = cell, use
        mode = _OpCache(cell, use) if self.by_ops else None
        cell.mode = mode
        try:
            with mode if mode is not None else contextlib.nullcontext():
                yield
        finally:
            _state.cell, _state.use = prev
            cell.mode = None

    @contextlib.contextmanager
    def forward(self, key: Hashable) -> Iterator[None]:
        """Cell ``key``'s no-grad forward: keep what the policy names."""
        cell = self._cells[key] = _CellStore(self)
        with self._active(cell, False):
            yield

    @contextlib.contextmanager
    def recompute(self, key: Hashable) -> Iterator[None]:
        """Cell ``key``'s recompute: take what its forward kept."""
        cell = self._cells.pop(key)
        with self._active(cell, True):
            yield
        if cell.flash or cell.ops:
            raise RuntimeError(
                f"remat policy {self.policy.label}: the recompute of cell {key} left "
                f"{len(cell.flash)} flash results and {len(cell.ops)} op outputs "
                "untaken; the cell does not run the same calls twice")


def checkpoint_name(t: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``t`` as the named save point ``name`` (:data:`NAMED_SAVE_POINTS`):
    in a checkpointed cell's forward whose policy names it, the output of
    the op that made ``t`` is kept, and the recompute takes it instead of
    running that op again.  Returns ``t``; outside such a cell a no-op."""
    cell = _state.cell
    if cell is not None and not _state.use and name in cell.policy.names:
        cell.keep_named(t)
    return t


def flash_call(fwd: Callable[..., Tuple[torch.Tensor, torch.Tensor]], *args: Any
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fwd(*args) -> (o, lse)``, a flash forward: under a policy that
    names ``flash_out`` and ``flash_stats``, a checkpointed cell's forward
    keeps the pair and its recompute takes it back without calling
    ``fwd`` (no kernel launch).  The ops inside are opaque to the cell's
    op cache either way."""
    cell = _state.cell
    _state.opaque += 1
    try:
        if cell is None or not cell.remat.flash:
            return fwd(*args)
        if _state.use:
            if not cell.flash:
                raise RuntimeError(
                    "remat policy: the recompute makes more flash calls than "
                    "the forward kept")
            o, lse = cell.flash.pop(0)
            return o.get(), lse.get()
        o, lse = fwd(*args)
        cell.flash.append((cell.remat.held(o), cell.remat.held(lse)))
        return o, lse
    finally:
        _state.opaque -= 1
