"""The SPMD pipeline engine over ``torch.distributed``: one process per mesh
position, pipeline parallelism (``pp``) composed with data (``dp``),
expert (``ep``), sequence (``sp``) and tensor (``tp``) parallelism.

Counterpart of ``torchgpipe_tpu/spmd.py``.  The reference expresses the
whole GPipe schedule as one ``shard_map``-ped program over a
``jax.sharding.Mesh``: stage hand-offs are ``ppermute``, reductions
``psum``.  In PyTorch's idiom the same engine is one process per mesh
position:

* :func:`make_mesh` gives this process its coordinates on ``('pp',
  'dp'[, 'ep'][, 'sp'][, 'tp'])`` (``pp`` outermost, ``tp`` innermost, as
  the reference's axis order) and one process group per set of axes;
* each process holds its stage's slice of the stacked ``[n_stages, ...]``
  block parameters and the ``pre``/``post`` (embedding / head)
  parameters, every leaf that a layer's ``meta['param_specs']`` shards
  over ``tp`` cut to its lane's slice (:meth:`SpmdGPipe.init`,
  :meth:`~SpmdGPipe.place`);
* activations go to the next ``pp`` rank and their gradients to the
  previous one by point-to-point ``isend``/``recv``;
* the batch is split over ``dp`` x ``ep`` on its rows (expert
  parallelism shards tokens too) and over ``sp`` on its sequence; the
  engine binds its ``ep``, ``tp`` and ``sp`` axes around each step
  (``parallel.axes``), and the layers run their collectives over them:
  the experts' all-to-alls (``models.moe``), Megatron's all-reduces
  (``parallel.tensor``), the ring or Ulysses (``parallel.ring_attention``,
  ``parallel.ulysses``);
* ``pre``/``post`` gradients are summed over ``pp``, every gradient is
  averaged over ``dp`` and averaged (or, for a summed loss, summed) over
  ``ep`` and ``sp`` by ``all_reduce`` (the pre/post ones in one reduction
  over the rank's pp x dp x ep x sp group), as the reference's ``psum``
  and ``pmean`` do; never over ``tp``, whose sharded leaves differ from
  lane to lane, and expert leaves (sharded over ``ep``) never over
  ``ep``: the all-to-all's backward already brought every lane's tokens'
  contributions home.

The backend is the caller's: ``nccl`` where each rank has a card of its
own, or ``gloo``, which stages every transfer through host memory (ranks
sharing one card, which NCCL does not take).  All compute stays on each
rank's device; the host staging is counted (:attr:`Mesh.staged_bytes`,
by kind in :attr:`Mesh.staged_by`).

Schedules: ``'fill_drain'`` (GPipe), ``'1f1b'`` (PipeDream-flush,
ordered by the reference's closed-form tick table :func:`fwd_tick` /
:func:`bwd_tick`), ``'interleaved'`` (Megatron's virtual stages: blocks
stored ``[n, v, ...]``, rank ``j``'s chunk ``c`` global block ``c*n + j``)
and ``'zb'`` (zero-bubble: a backward split into an input-gradient B cell
and a weight-gradient W cell), the last two run in the order of the
reference's static tables (:mod:`~torchgpipe_tpu_torch.parallel.interleaved`,
:mod:`~torchgpipe_tpu_torch.parallel.zerobubble`); none but fill-drain
with ``sp``, as in the reference.  Checkpoint modes ``'always'``,
``'except_last'`` and ``'never'`` follow the port's
:mod:`~torchgpipe_tpu_torch.checkpoint`: a checkpointed cell runs its
forward without a graph, keeping its input, and recomputes in its
backward (its tp all-reduces and ring transfers with it, in the same
order on every lane); ``'zb'`` takes ``'never'`` and ``'always'``.
Under a row-decomposable loss (``loss_reduction`` ``'mean'``/``'sum'``)
the fill-drain head and loss are sharded over ``pp`` (each stage runs
them on 1/n of the batch), and ragged batches are edge-padded and
masked out exactly.

``fsdp=True`` stores each block leaf sharded over ``dp`` on its first
free dim that ``dp`` divides (:meth:`SpmdGPipe._fsdp_layout`); every step
all-gathers the full tensors once, runs the schedule on them and
reduce-scatters their gradients back (:meth:`Mesh.reduce_scatter`).  The
ZeRO levels of :meth:`SpmdGPipe.make_train_step` (``zero=``): 0, the
plain update; 1, the optimizer over this dp lane's 1/dp segment of each
flattened leaf, the updated segments all-gathered back; 3, the plain
update of the fsdp storage shards.

Parameters are trees in the reference's layout (``{"pre", "blocks",
"post"}``; an ``nn.Sequential`` as a tuple of its children's trees, a
layer as the dict of its parameters by name), with torch tensors as
leaves; the engine runs a layer on a tree through
``torch.func.functional_call``.

The engine's own knobs: ``train_step(rng=)`` keys every cell (one key
per step, micro-batch and layer of the whole model, so the masks do not
depend on the schedule), ``megastep=K`` runs K guarded steps a call,
``checkpoint='offload'`` (fill-drain) keeps each cell's saved tensors in
pinned host memory, and ``resilience.faults.inject(nan_at=)`` poisons a
cell's input; an exception raised in a cell keeps its type and gains a
note naming its stage and micro-batch.

``remat_policy`` (a :data:`~torchgpipe_tpu_torch.checkpoint.policies`
preset; fill-drain under ``'always'``, ``'except_last'`` or
``'offload'``) refines the checkpointed cells: a cell's no-grad forward
keeps what the policy names and its recompute takes it back
(:class:`~torchgpipe_tpu_torch.checkpoint.Remat`); under ``'offload'``
an explicit policy checkpoints every cell and names what it keeps (in
host memory for an offload policy), as the reference's does.

Not ported, raising ``NotImplementedError`` that names ROADMAP.md:
``tracer=``, ``partition_rules=`` and ``hbm_budget_bytes=`` (queue A item
5.6).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from torch.nn.utils.stateless import _reparametrize_module

from torchgpipe_tpu_torch import checkpoint as _ckpt
from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch import rng as _rng
from torchgpipe_tpu_torch.auxgrad import aux_scale
from torchgpipe_tpu_torch.models.transformer import not_ported
from torchgpipe_tpu_torch.parallel.axes import axis_bound, bind_axes
from torchgpipe_tpu_torch.resilience import faults as _faults
from torchgpipe_tpu_torch.skip.layout import pop_keys, stash_keys

Pytree = Any

__all__ = ["Mesh", "P", "SpmdGPipe", "broadcast_specs", "bwd_tick", "fwd_tick",
           "layer_param_specs", "make_mesh", "module_tree", "spec_mentions"]


# --------------------------------------------------------------------- #
# partition specs                                                       #
# --------------------------------------------------------------------- #


class P(tuple):
    """A partition spec: one entry per leading dim of a leaf, each a mesh
    axis name, a tuple of names, or None (replicated); the port's
    counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: Any) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def _children(layer: nn.Module) -> Optional[Union[tuple, dict]]:
    """The children of a compound layer: an ``nn.Sequential``'s as a
    tuple (the reference's ``chain``), else None."""
    if isinstance(layer, nn.Sequential):
        return tuple(layer)
    return None


def _row_coupled(layer: nn.Module) -> list:
    """Row-coupled mechanisms in ``layer`` whose auxiliary terms see ragged
    padding rows (batch-norm statistics average over the padded micro-batch;
    a MoE balance penalty counts the duplicated tokens).  Task-loss
    gradients stay exact either way — this feeds the one-time ragged-batch
    warning in :meth:`SpmdGPipe.train_step`."""
    from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
    from torchgpipe_tpu_torch.ops.nn import BatchNorm

    out = []
    for m in layer.modules():
        if isinstance(m, DeferredBatchNorm):
            out.append("deferred_batch_norm statistics")
        elif isinstance(m, BatchNorm):
            out.append("batch_norm statistics")
        moe = getattr(m, "moe", None)
        if getattr(moe, "balance_weight", 0.0) > 0.0:
            out.append("MoE balance_weight penalty")
    return out


def _declared_axes(layer: nn.Module, key: str) -> list:
    """Collect ``meta[key]`` declarations (a layer's ``meta`` dict),
    recursing into children."""
    out = []
    for m in layer.modules():
        meta = getattr(m, "meta", None)
        if isinstance(meta, dict) and key in meta:
            out.append(meta[key])
    return out


def layer_param_specs(layer: nn.Module, stage_axis: Optional[str] = None) -> Pytree:
    """:class:`P` tree *prefix* for a layer's params.

    ``stage_axis`` names the leading stacked-stage dim for pipeline blocks
    (specs get it prepended); pass ``None`` for un-stacked layers (pre/post),
    whose declared specs apply as-is.

    Layers declare sharded leaves via ``meta['param_specs']`` — a dict naming
    *every* param key with its per-stage spec.  A declared value may itself
    be a dict (a sub-layer's specs) or a bare ``P`` prefix covering that
    subtree.  Undeclared layers get a single ``P(stage_axis)`` prefix
    covering their whole params subtree (stacked-stage dim sharded,
    everything else replicated).  Compound layers (``nn.Sequential``)
    recurse; fully-replicated subtrees collapse back to one prefix spec.
    The result broadcasts to per-leaf form via :func:`broadcast_specs`.
    """
    repl = P(stage_axis) if stage_axis else P()
    children = _children(layer)
    if children is not None:
        sub = tuple(layer_param_specs(c, stage_axis) for c in children)
        if all(isinstance(v, P) and v == repl for v in sub):
            return repl
        return sub
    meta = getattr(layer, "meta", None)
    declared = meta.get("param_specs") if isinstance(meta, dict) else None
    if declared:

        def with_stage(s):
            if isinstance(s, P):
                return P(stage_axis, *tuple(s)) if stage_axis else s
            return {k: with_stage(v) for k, v in s.items()}

        return {k: with_stage(s) for k, s in declared.items()}
    return repl


def spec_mentions(spec: P, axis: str) -> bool:
    """True if a partition spec shards any dim over ``axis``."""
    for ax in spec:
        if ax is None:
            continue
        if axis in (ax if isinstance(ax, tuple) else (ax,)):
            return True
    return False


def broadcast_specs(prefix: Pytree, tree: Pytree) -> Pytree:
    """Expand a spec tree-prefix to one :class:`P` per leaf of ``tree``
    (the broadcasting ``shard_map`` applies to its in_specs)."""
    if isinstance(prefix, P):
        return _tree_map(lambda _: prefix, tree)
    if isinstance(prefix, Mapping) and isinstance(tree, Mapping):
        if set(prefix) != set(tree):
            raise ValueError(
                f"spec keys {sorted(prefix)} do not match tree keys {sorted(tree)}")
        return {k: broadcast_specs(prefix[k], tree[k]) for k in tree}
    if isinstance(prefix, (tuple, list)) and isinstance(tree, (tuple, list)):
        if len(prefix) != len(tree):
            raise ValueError(
                f"spec tuple of {len(prefix)} does not match tree tuple of {len(tree)}")
        return type(tree)(broadcast_specs(p, t) for p, t in zip(prefix, tree))
    raise ValueError(
        f"spec {type(prefix).__name__} does not match tree {type(tree).__name__}")


# --------------------------------------------------------------------- #
# parameter trees                                                       #
# --------------------------------------------------------------------- #


def _is_node(t: Any) -> bool:
    return isinstance(t, (Mapping, tuple, list)) and not isinstance(t, P)


def _tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` (nested dicts, tuples, lists),
    with the leaves at the same place in ``rest``."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree: Pytree) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _items(tree: Pytree, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in the tree's own order."""
    if isinstance(tree, Mapping):
        return [kv for k, v in tree.items() for kv in _items(v, path + (k,))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return [kv for i, v in enumerate(tree) for kv in _items(v, path + (i,))]
    return [(path, tree)]


def _get(tree: Pytree, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _stack(trees: Sequence[Pytree]) -> Pytree:
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def module_tree(module: nn.Module, leaf: Callable[[str, torch.Tensor], Any] = None,
                skip: Sequence[str] = ()) -> Pytree:
    """A module's parameters in the reference's tree layout: an
    ``nn.Sequential`` as the tuple of its children's trees, any other
    module as the dict of its own parameters and its children's trees by
    name (a parameter-less layer as ``()``).  Each leaf is ``leaf(dotted
    name, parameter)`` (default: the parameter); top-level names in
    ``skip`` are left out (a tied head's spliced ``table``)."""
    leaf = leaf or (lambda name, p: p)

    def walk(m: nn.Module, prefix: str, top: bool) -> Pytree:
        if isinstance(m, nn.Sequential):
            return tuple(walk(c, f"{prefix}{i}.", False) for i, c in enumerate(m))
        out: Dict[str, Any] = {}
        for name, p in m._parameters.items():
            if p is not None and not (top and name in skip):
                out[name] = leaf(prefix + name, p)
        for name, c in m._modules.items():
            sub = walk(c, f"{prefix}{name}.", False)
            if _leaves(sub):
                out[name] = sub
        return out if out else ()

    return walk(module, "", True)


def _call(module: nn.Module, names: Pytree, tree: Pytree, *args: Any) -> Any:
    """``module(*args)`` with its parameters taken from ``tree`` (the
    layout of :func:`module_tree`; ``names`` the same tree of dotted
    names)."""
    mapping = {name: _get(tree, path) for path, name in _items(names)}
    return functional_call(module, mapping, args)


# --------------------------------------------------------------------- #
# the mesh                                                              #
# --------------------------------------------------------------------- #

# dtype codes of the point-to-point header
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool]
_HEADER = 8   # dtype code, ndim, up to 6 dims
# message tags: kind * _TAG + micro-batch (or leaf); the sequence-parallel
# ring and all-to-all own kinds of their own, apart from the pp hand-offs
_TAG = 1 << 16
_ACT, _GRAD, _SLICE, _SLICE_GRAD, _GATHER, _RING, _A2A = 1, 2, 3, 4, 5, 6, 7


def _rank_at(shape: Mapping[str, int], at: Mapping[str, int]) -> int:
    """The global rank at coordinates ``at``: row-major over ``shape``'s
    axes in their order."""
    r = 0
    for name, size in shape.items():
        r = r * size + at[name]
    return r


def _coords_at(shape: Mapping[str, int], rank: int) -> Dict[str, int]:
    """The inverse of :func:`_rank_at`."""
    out = {}
    for name in reversed(tuple(shape)):
        rank, out[name] = divmod(rank, shape[name])
    return {name: out[name] for name in shape}


class Mesh:
    """This process's place in a ``('pp', 'dp'[, 'ep'][, 'sp'][, 'tp'])`` mesh of
    processes: ``axis_names``, ``shape`` (axis -> size), ``coords`` (axis
    -> this rank's index), ``device`` and ``backend``.  Global ranks are
    numbered row-major over the axes in that order (``tp`` innermost), as
    the reference lays its device array out.  :meth:`group` is the process
    group of the ranks that differ from this one only along some axes
    (one per non-trivial set of axes, made by :func:`make_mesh`).

    The transfers below stage through host memory when the backend is
    ``gloo`` and the device a card; ``staged_bytes`` counts the bytes
    copied between the device and the host for them, and ``staged_by``
    the same bytes by kind (``'grads'``, ``'pp'``, ``'ep'``, ``'tp'``,
    ``'sp'``, ``'fsdp'``, ``'zero'`` ...: what moved them)."""

    def __init__(self, shape: Mapping[str, int], device: torch.device, backend: str,
                 groups: Dict[Tuple[str, ...], Any]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.rank = dist.get_rank()
        self.coords = _coords_at(self.shape, self.rank)
        self.groups = groups
        self.device = device
        self.backend = backend
        self.staged_bytes = 0
        self.staged_by: Dict[str, int] = {}
        self._pending: List[Tuple[Any, torch.Tensor]] = []
        # Pinned host buffers of the reductions, by shape and dtype, reused
        # step after step (a copy to or from pinned memory runs at the
        # link's rate; a pageable one is staged again by the driver).
        self._pinned: Dict[Tuple[tuple, torch.dtype], torch.Tensor] = {}

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend!r})")

    def rank_of(self, pp: Optional[int] = None, dp: Optional[int] = None,
                **others: int) -> int:
        """The global rank at these coordinates; an axis not given keeps
        this rank's."""
        at = dict(self.coords, **others)
        if pp is not None:
            at["pp"] = pp
        if dp is not None:
            at["dp"] = dp
        return _rank_at(self.shape, at)

    def _axes(self, axis: Union[None, str, Sequence[str]]) -> Tuple[str, ...]:
        if axis is None:
            return self.axis_names
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axis: Union[None, str, Sequence[str]]) -> int:
        n = 1
        for a in self._axes(axis):
            n *= self.shape[a]
        return n

    def group(self, axis: Union[None, str, Sequence[str]]) -> Any:
        """The process group along ``axis`` (a name, names, or None: every
        axis); None when it holds this rank alone."""
        return self.groups.get(self._axes(axis))

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type != "cpu"

    def _count(self, nbytes: int, kind: str) -> None:
        self.staged_bytes += nbytes
        self.staged_by[kind] = self.staged_by.get(kind, 0) + nbytes

    def _host(self, t: torch.Tensor, kind: str = "pp") -> torch.Tensor:
        if not self.staged:
            return t.contiguous()
        self._count(t.numel() * t.element_size(), kind)
        return t.detach().to("cpu").contiguous()

    def _back(self, t: torch.Tensor, kind: str = "pp") -> torch.Tensor:
        if not self.staged:
            return t
        self._count(t.numel() * t.element_size(), kind)
        return t.to(self.device)

    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        """Post a send of ``t`` to global rank ``dst`` (a header with its
        dtype and shape, then the payload); :meth:`flush` waits for it."""
        t = self._host(t.detach())
        if t.ndim > _HEADER - 2:
            raise ValueError(f"a transfer of {t.ndim} dims (at most {_HEADER - 2})")
        head = torch.zeros(_HEADER, dtype=torch.int64, device=t.device)
        head[0], head[1] = _DTYPES.index(t.dtype), t.ndim
        head[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
        for x in (head, t):
            self._pending.append((dist.isend(x, dst, tag=tag), x))

    def recv(self, src: int, tag: int) -> torch.Tensor:
        """The next tensor global rank ``src`` sent with ``tag``, on this
        rank's device."""
        dev = "cpu" if self.staged else self.device
        head = torch.empty(_HEADER, dtype=torch.int64, device=dev)
        dist.recv(head, src, tag=tag)
        h = head.tolist()
        t = torch.empty(h[2:2 + h[1]], dtype=_DTYPES[h[0]], device=dev)
        dist.recv(t, src, tag=tag)
        return self._back(t)

    def flush(self) -> None:
        """Wait for every posted send."""
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()

    def _pinned_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into the pinned host buffer of its shape and dtype
        (made at first use, reused step after step)."""
        key = (tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t.detach())

    def all_reduce(self, t: torch.Tensor, axis: Union[None, str, Sequence[str]],
                   scale: float = 1.0, *, op: str = "sum",
                   kind: str = "grads") -> torch.Tensor:
        """The sum (``op='max'``: the maximum) of ``t`` over ``axis`` (a
        name, names, or None: every rank of the mesh) times ``scale``, in
        ``t``'s dtype (a bf16 gradient is summed in bf16, half the bytes of
        a float32 sum through the host)."""
        if self.size(axis) == 1:
            return t if scale == 1.0 else t * scale
        if self.staged:
            buf = self._pinned_copy(t)
            self._count(2 * t.numel() * t.element_size(), kind)
        else:
            buf = t.detach().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group(axis))
        if scale != 1.0:
            buf.mul_(scale)
        return buf.to(self.device) if self.staged else buf

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int, scale: float = 1.0, *,
                       kind: str = "fsdp") -> torch.Tensor:
        """This lane's ``dim``-slice of the sum of ``t`` over ``axis``
        times ``scale``: lane ``i`` of ``n`` gets rows ``[i*s, (i+1)*s)``
        of ``dim`` (``s = t.shape[dim] / n``), in ``t``'s dtype.  FSDP's
        gradient reduction (``'fsdp'``); at two lanes the sum is the same
        two addends as :meth:`all_reduce`'s."""
        n = self.shape[axis]
        if n == 1:
            return t if scale == 1.0 else t * scale
        src = t.detach().movedim(dim, 0).contiguous()
        if self.staged:
            nbytes = src.numel() * src.element_size()
            self._count(nbytes + nbytes // n, kind)
            src = self._pinned_copy(src)
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.group(axis))
        if scale != 1.0:
            out.mul_(scale)
        if self.staged:
            out = out.to(self.device)
        return out.movedim(0, dim).contiguous()

    def broadcast(self, t: Optional[torch.Tensor], src: int, axis: str) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every rank of ``axis`` (shape and
        dtype travel with it)."""
        if self.shape[axis] == 1:
            return t
        objs = [None if t is None else (tuple(t.shape), t.dtype)]
        dist.broadcast_object_list(objs, src=src, group=self.group(axis))
        shape, dtype = objs[0]
        dev = "cpu" if self.staged else self.device
        buf = self._host(t) if self.rank == src else torch.empty(shape, dtype=dtype, device=dev)
        dist.broadcast(buf, src=src, group=self.group(axis))
        return buf.to(self.device) if self.rank == src else self._back(buf)

    def all_gather(self, t: torch.Tensor, axis: str, kind: str = "pp") -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis``, in axis order."""
        if self.shape[axis] == 1:
            return [t]
        buf = self._host(t, kind)
        out = [torch.empty_like(buf) for _ in range(self.shape[axis])]
        dist.all_gather(out, buf, group=self.group(axis))
        return [t if i == self.coords[axis] else self._back(o, kind)
                for i, o in enumerate(out)]

    def all_to_all(self, chunks: Sequence[torch.Tensor], axis: str,
                   kind: str = "sp") -> List[torch.Tensor]:
        """``chunks[p]`` to lane ``p`` of ``axis``; what each lane sent
        this one, in lane order (every lane's chunks of one shape), by
        point-to-point transfers."""
        me, n = self.coords[axis], self.shape[axis]
        out: List[Optional[torch.Tensor]] = [None] * n
        out[me] = chunks[me]
        works = []
        for p in range(n):
            if p != me:
                buf = self._host(chunks[p].detach(), kind)
                works.append((dist.isend(buf, self.rank_of(**{axis: p}), tag=_A2A * _TAG),
                              buf))
        dev = "cpu" if self.staged else self.device
        for p in range(n):
            if p != me:
                buf = torch.empty(chunks[p].shape, dtype=chunks[p].dtype, device=dev)
                dist.recv(buf, self.rank_of(**{axis: p}), tag=_A2A * _TAG)
                out[p] = self._back(buf, kind)
        for work, _ in works:
            work.wait()
        return out

    def shift(self, t: torch.Tensor, axis: str, kind: str = "sp") -> torch.Tensor:
        """Send ``t`` to the next lane of ``axis`` (a ring) and return what
        the previous lane sent this one."""
        me, n = self.coords[axis], self.shape[axis]
        if n == 1:
            return t
        buf = self._host(t.detach(), kind)
        work = dist.isend(buf, self.rank_of(**{axis: (me + 1) % n}), tag=_RING * _TAG)
        got = torch.empty(t.shape, dtype=t.dtype, device="cpu" if self.staged else self.device)
        dist.recv(got, self.rank_of(**{axis: (me - 1) % n}), tag=_RING * _TAG)
        work.wait()
        return self._back(got, kind)


_AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


def make_mesh(
    n_stages: int,
    dp: int = 1,
    sp: int = 1,
    *,
    tp: int = 1,
    ep: int = 1,
    backend: Optional[str] = None,
    device: Any = None,
) -> Mesh:
    """This process's :class:`Mesh` over a ``('pp', 'dp'[, 'ep'][, 'sp'][,
    'tp'])`` layout of ``n_stages * dp * ep * sp * tp`` processes: the
    reference's axis order, ``tp`` innermost (its two all-reduces a block
    are the chattiest traffic), then ``sp``, ``ep`` (one all-to-all pair a
    MoE layer), ``dp``, and ``pp`` outermost; ``ep``, ``sp`` and ``tp`` are
    left out at size 1, as the reference leaves them.

    ``torch.distributed`` must be initialised by the caller with that
    world size (``init_process_group(backend, init_method=..., rank=,
    world_size=)``).  One process group per set of axes is made here
    (every rank calls this, in the same order).  ``backend`` is the groups'
    backend (default: the default group's); with ``gloo`` a card's
    transfers stage through the host.  ``device`` defaults to the card
    (``cuda``, the local rank — ``LOCAL_RANK``, else the global rank —
    modulo the device count); it is the CPU only when asked."""
    sizes = {"pp": n_stages, "dp": dp, "ep": ep, "sp": sp, "tp": tp}
    shape = {a: sizes[a] for a in _AXIS_ORDER if a in ("pp", "dp") or sizes[a] > 1}
    need = n_stages * dp * ep * sp * tp
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialised with world size "
            f"n_stages * dp * sp * tp{' * ep' if ep > 1 else ''} = {need} (one process "
            "per mesh position): "
            "call torch.distributed.init_process_group(backend, init_method="
            "'tcp://localhost:<port>', rank=, world_size=) first"
        )
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} devices, have {world} processes")
    backend = backend or dist.get_backend()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    names = tuple(shape)
    mine = _coords_at(shape, dist.get_rank())
    groups: Dict[Tuple[str, ...], Any] = {}
    # Every set of axes of more than one rank, in a fixed order: a group
    # per assignment of the other axes' coordinates.
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if math.prod(shape[a] for a in axes) == 1:
                continue
            rest = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                members = [_rank_at(shape, dict(zip(rest, fixed), **dict(zip(axes, free))))
                           for free in itertools.product(*(range(shape[a]) for a in axes))]
                g = dist.new_group(sorted(members), backend=backend)
                if all(mine[a] == v for a, v in zip(rest, fixed)):
                    groups[axes] = g
    return Mesh(shape, device, backend, groups)


# --------------------------------------------------------------------- #
# the 1F1B closed form                                                  #
# --------------------------------------------------------------------- #


def fwd_tick(i: int, j: int, n: int) -> int:
    """The tick at which stage ``j`` of ``n`` runs micro-batch ``i``'s
    forward under 1F1B: ``i + j`` in the warm-up (``i <= n - 1 - j``),
    ``2i + j`` in the steady state (the reference's closed form)."""
    return i + j if i <= n - 1 - j else 2 * i + j


def bwd_tick(i: int, j: int, n: int) -> int:
    """The tick of micro-batch ``i``'s backward on stage ``j``:
    ``2n - 1 + 2i - j``."""
    return 2 * n - 1 + 2 * i - j


def _pad_batch(tree: Pytree, pad: int) -> Pytree:
    """Pad dim 0 by ``pad`` rows, edge-replicating the last row — replicas
    are valid inputs for any layer/loss (no NaN traps from zero tokens);
    the ragged-batch mask zeroes their loss and gradient contribution."""
    if pad == 0:
        return tree
    return _tree_map(
        lambda a: torch.cat([a, a[-1:].expand(pad, *a.shape[1:])], 0), tree)




def _assemble(spec: P, sizes: Mapping[str, int],
              piece: Callable[[Dict[str, int]], torch.Tensor]) -> torch.Tensor:
    """A global leaf from its shards: ``piece(coords)`` is the shard at
    those coordinates of the axes ``spec`` names, concatenated along each
    sharded dim in the row-major order of its axes."""
    entries = [(dim, ax if isinstance(ax, tuple) else (ax,))
               for dim, ax in enumerate(spec) if ax is not None]

    def rec(i: int, at: Dict[str, int]) -> torch.Tensor:
        if i == len(entries):
            return piece(at)
        dim, axes = entries[i]
        return torch.cat([rec(i + 1, dict(at, **dict(zip(axes, combo))))
                          for combo in itertools.product(*(range(sizes[a]) for a in axes))],
                         dim)

    return rec(0, {})


class _Cell:
    """One micro-batch's cell on this stage: its input (a leaf that
    requires grad when a gradient must leave it), and its output's graph
    unless checkpointed (then recomputed in the backward), its
    micro-batch ``i``, its global stage ``g`` and its key (``rng=``: the
    micro-batch's key and the whole-model index of the block's first
    layer).  A zero-bubble
    cell also keeps, from its B half to its W half, the output's
    cotangent ``gy`` and the input's gradient ``g``."""

    __slots__ = ("h", "x", "y", "ckpt", "i", "stage", "key", "gy", "g")

    def __init__(self, h, x, y, ckpt, i, stage, key):
        self.h, self.x, self.y, self.ckpt = h, x, y, ckpt
        self.i, self.stage, self.key = i, stage, key
        self.gy = self.g = None


class SpmdGPipe:
    """GPipe over a stacked block, one process per mesh position.

    Args (the reference's, same names and defaults):
      block: the per-stage computation (an ``nn.Module``; an
        ``nn.Sequential`` of sub-layers for a multi-layer stage).  Its
        input and output must have one shape and dtype.
      n_stages: pipeline depth; must equal the ``pp`` mesh axis size.
      mesh: this process's :class:`Mesh` (:func:`make_mesh`).
      chunks: micro-batches per mini-batch (m).
      loss_fn: ``loss_fn(output, target) -> scalar``, or a parametric loss
        layer (an ``nn.Module`` called as ``loss_fn(y, target)``, e.g.
        ``models.transformer.chunked_lm_loss``; its params live under
        ``params["loss"]``, replicated over pp).
      pre / post: optional layers applied before stage 0 / after stage
        n-1 (e.g. embedding / LM head), replicated over ``pp``, their
        gradients summed over it.  A ``post`` with a ``tie_pre`` tuple of
        names (``models.transformer.llama_spmd`` under
        ``tie_embeddings``) reads those parameters of ``pre`` (the tied
        embedding): they are spliced in at apply time and their
        gradients sum into ``grads["pre"]``.
      checkpoint: 'always', 'except_last', 'never' or 'offload'
        (fill-drain: no recompute, each cell's saved tensors in pinned
        host memory from its forward to its backward,
        ``checkpoint.Offload``; ``offload_stats`` has the last step's
        bytes).
      remat_policy: a ``checkpoint.policies`` preset refining the
        checkpointed cells (fill-drain; ``remat_stats`` has the bytes it
        kept in the last step).
      loss_reduction: 'mean' (default) or 'sum' declares that ``post`` and
        ``loss_fn`` decompose over batch rows that way, which shards the
        fill-drain head and loss over ``pp`` and admits ragged batches;
        ``None`` runs the head replicated on the last stage.
      schedule: 'fill_drain', '1f1b', 'interleaved' (with
        ``virtual_stages`` >= 2 chunks a rank, ``chunks`` a multiple of
        ``n_stages``) or 'zb' (checkpoint 'never' or 'always').
      dp_axis: the data-parallel axis name ('dp'), or None.
      ep_axis: the expert-parallel axis name ('ep'), or None: it shards
        the batch like a second dp axis and the expert leaves over its
        lanes (``models.moe.MoEConfig(ep_axis=)``); needs a
        ``loss_reduction``.
      fsdp: store the block leaves sharded over ``dp_axis`` (ZeRO-3);
        needs ``dp_axis``.
      zero_update: the default ZeRO level of :meth:`make_train_step`
        (0/False, 1/True, or 3 under fsdp).
      megastep: the default K of :meth:`make_train_step` (K guarded steps
        a call).

    The reference's other knobs are taken so that its calls transcribe:
    ``scan_unroll``, ``send_ahead`` and ``gather_schedule`` shape its
    compiled scan and are validated but change nothing here; the ones of
    later sub-slices raise ``NotImplementedError`` naming their queue
    item.
    """

    def __init__(
        self,
        block: nn.Module,
        n_stages: int,
        mesh: Mesh,
        chunks: int,
        loss_fn: Callable,
        pre: Optional[nn.Module] = None,
        post: Optional[nn.Module] = None,
        checkpoint: str = "always",
        remat_policy: Optional[Callable] = None,
        pp_axis: str = "pp",
        dp_axis: Optional[str] = None,
        sp_axis: Optional[str] = None,
        tp_axis: Optional[str] = None,
        ep_axis: Optional[str] = None,
        loss_reduction: Optional[str] = "mean",
        fsdp: bool = False,
        schedule: str = "fill_drain",
        virtual_stages: int = 1,
        scan_unroll: Union[int, bool] = 1,
        send_ahead: bool = True,
        megastep: int = 1,
        hbm_budget_bytes: Optional[int] = None,
        tracer: Any = None,
        partition_rules: Any = None,
        zero_update: Union[bool, int] = False,
        gather_schedule: str = "block",
    ) -> None:
        self.block, self.n_stages, self.mesh, self.chunks = block, n_stages, mesh, chunks
        self.loss_fn, self.pre, self.post = loss_fn, pre, post
        self.checkpoint, self.remat_policy = checkpoint, remat_policy
        self.pp_axis, self.dp_axis = pp_axis, dp_axis
        self.sp_axis, self.tp_axis, self.ep_axis = sp_axis, tp_axis, ep_axis
        self.loss_reduction, self.fsdp, self.schedule = loss_reduction, fsdp, schedule
        self.virtual_stages, self.scan_unroll = virtual_stages, scan_unroll
        self.send_ahead, self.megastep = send_ahead, megastep
        self.hbm_budget_bytes, self.tracer = hbm_budget_bytes, tracer
        self.partition_rules, self.zero_update = partition_rules, zero_update
        self.gather_schedule = gather_schedule
        self._validate()

    def __repr__(self) -> str:
        axes = {name: self.mesh.shape[name] for name in self.mesh.axis_names}
        extras = "".join(
            f", {k}={v!r}"
            for k, v, default in (
                ("loss_reduction", self.loss_reduction, "mean"),
                ("fsdp", self.fsdp, False),
                ("schedule", self.schedule, "fill_drain"),
                ("virtual_stages", self.virtual_stages, 1),
                ("scan_unroll", self.scan_unroll, 1),
                ("send_ahead", self.send_ahead, True),
                ("megastep", self.megastep, 1),
                ("zero_update", self.zero_update, False),
                ("gather_schedule", self.gather_schedule, "block"),
            )
            if v != default
        )
        name = getattr(self.block, "name", None) or type(self.block).__name__
        return (
            f"SpmdGPipe(block={name!r}, n_stages={self.n_stages}, "
            f"chunks={self.chunks}, checkpoint={self.checkpoint!r}, "
            f"mesh={axes}{extras})"
        )

    # ------------------------------------------------------------------ #
    # validation (the reference's __post_init__)                         #
    # ------------------------------------------------------------------ #

    def _validate(self) -> None:
        if self.pp_axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no {self.pp_axis!r} axis: {self.mesh}")
        self._loss_is_layer = isinstance(self.loss_fn, nn.Module)
        loss_lyr = self.loss_fn if self._loss_is_layer else None
        for what, lyr in (("block", self.block), ("pre", self.pre),
                          ("post", self.post), ("loss", loss_lyr)):
            if lyr is not None and (stash_keys(lyr) or pop_keys(lyr)):
                name = getattr(lyr, "name", None) or type(lyr).__name__
                raise ValueError(
                    f"SPMD engine does not support cross-stage skip "
                    f"connections, but {what} layer {name!r} declares "
                    "stash/pop. Resolve the skips inside a chain() stage "
                    "(runnable demo: examples/spmd_skips.py), or use the "
                    "MPMD GPipe engine for cross-stage skip routing."
                )
        if self.loss_reduction not in ("mean", "sum", None):
            raise ValueError("loss_reduction must be 'mean', 'sum' or None")
        self._tie_post = tuple(getattr(self.post, "tie_pre", ()) or ())
        self._tie_loss = tuple(getattr(loss_lyr, "tie_pre", ()) or ())
        for what, lyr, keys in (("post", self.post, self._tie_post),
                                ("loss", loss_lyr, self._tie_loss)):
            missing = [k for k in keys if k not in lyr._parameters]
            if missing:
                raise ValueError(
                    f"the {what} layer ties {missing} to pre but holds no such "
                    "parameter: build it holding pre's (lm_head(cfg, "
                    "table=embed.table); models.transformer.llama_spmd does)")
        if self._tie_post or self._tie_loss:
            if self.pre is None:
                raise ValueError(
                    "meta['tie_pre'] asks for pre-param splicing, but the "
                    "engine has no pre layer to take them from"
                )
            if self.schedule != "fill_drain":
                raise ValueError(
                    f"weight tying (meta['tie_pre']) is supported on the "
                    f"fill_drain schedule, not {self.schedule!r}: the "
                    "explicit-gradient schedules hand-accumulate per-cell "
                    "cotangents and do not yet route the tied "
                    "contribution into grads['pre'].  Use "
                    "schedule='fill_drain', or untie"
                )
        if not (
            self.scan_unroll is True
            or (isinstance(self.scan_unroll, int)
                and not isinstance(self.scan_unroll, bool)
                and self.scan_unroll >= 1)
        ):
            raise ValueError(
                f"scan_unroll must be True or an int >= 1, got "
                f"{self.scan_unroll!r}"
            )
        if not (isinstance(self.megastep, int) and not isinstance(self.megastep, bool)
                and self.megastep >= 1):
            raise ValueError(f"megastep must be an int >= 1, got {self.megastep!r}")
        if self.mesh.shape[self.pp_axis] != self.n_stages:
            raise ValueError(
                f"pp mesh axis size {self.mesh.shape[self.pp_axis]} != "
                f"n_stages {self.n_stages}"
            )
        for ax in (self.dp_axis, self.sp_axis, self.tp_axis, self.ep_axis):
            if ax is not None and ax not in self.mesh.axis_names:
                raise ValueError(f"mesh has no {ax!r} axis: {self.mesh}")
        if self.checkpoint not in ("always", "except_last", "never", "offload"):
            raise ValueError(
                "SPMD engine supports checkpoint="
                "'always'|'except_last'|'never'|'offload'"
            )
        if self.checkpoint == "offload" and self.schedule != "fill_drain":
            raise ValueError(
                f"checkpoint='offload' is a fill_drain feature: the "
                f"{self.schedule!r} schedule hand-writes its per-cell "
                "recompute/residual machinery (no jax.checkpoint region "
                "to attach the offload save policy to).  Use "
                "schedule='fill_drain', or checkpoint='never'/'always'"
            )
        if self.fsdp and self.dp_axis is None:
            raise ValueError(
                "fsdp shards parameters over the data-parallel lanes: set "
                "dp_axis (and give the mesh a dp axis of size > 1)"
            )
        if self.fsdp and self.ep_axis is not None:
            raise ValueError(
                "fsdp + ep is not supported: expert weights are already "
                "sharded over ep; shard the rest with tp instead"
            )
        if self.gather_schedule not in ("block", "use"):
            raise ValueError(
                "gather_schedule must be 'block' (gather each param once "
                "per block scan body) or 'use' (model per-use-site "
                f"gathering), got {self.gather_schedule!r}"
            )
        self._zero_level(self.zero_update)   # validate the declared level
        if self.sp_axis is not None and self.loss_reduction is None:
            raise ValueError(
                "sequence parallelism needs a batch/token-decomposable loss: "
                "set loss_reduction='mean' or 'sum'"
            )
        if self.ep_axis is not None and self.loss_reduction is None:
            raise ValueError(
                "expert parallelism shards the batch over the ep axis, so it "
                "needs a batch-decomposable loss: set loss_reduction='mean' "
                "or 'sum'"
            )
        if self.schedule not in ("fill_drain", "1f1b", "interleaved", "zb"):
            raise ValueError(
                "schedule must be 'fill_drain', '1f1b', 'interleaved' or 'zb'")
        if self.schedule == "interleaved":
            if self.virtual_stages < 2:
                raise ValueError(
                    "schedule='interleaved' needs virtual_stages >= 2 "
                    "(with one chunk per device it degenerates to "
                    "schedule='1f1b' — use that instead)"
                )
            if self.chunks % self.n_stages != 0:
                raise ValueError(
                    f"schedule='interleaved' needs chunks ({self.chunks}) "
                    f"divisible by n_stages ({self.n_stages}): Megatron's "
                    "micro-batch grouping (arXiv:2104.04473 §2.2) assumes "
                    "full groups"
                )
        elif self.virtual_stages != 1:
            raise ValueError("virtual_stages only applies to schedule='interleaved'")
        if self.schedule == "zb" and self.remat_policy is not None:
            raise ValueError(
                "remat_policy has no effect under schedule='zb': the "
                "recompute split is explicit in the schedule (B cells "
                "recompute whole cells under checkpoint='always'; "
                "checkpoint='never' stores vjp residuals outright)"
            )
        if self.schedule == "zb" and self.checkpoint == "except_last":
            raise ValueError(
                "schedule='zb' supports checkpoint='never' (vjp residuals "
                "stored at forward time, replayed by both backward halves "
                "— zero recompute, O(pipeline window) residual memory) and "
                "checkpoint='always' (the B cell recomputes the forward "
                "once and banks its vjp for the immediately-following W "
                "cell — O(1) residual slots for ~one extra forward per "
                "micro-batch); 'except_last' has no zb counterpart.  Use "
                "schedule='1f1b' for checkpoint='except_last'"
            )
        if self.schedule in ("1f1b", "interleaved", "zb"):
            sched = f"schedule={self.schedule!r}"
            if self.loss_reduction is None:
                raise ValueError(
                    f"{sched} computes per-micro-batch losses inside "
                    "the schedule, so the loss must decompose over "
                    "micro-batches: set loss_reduction='mean' or 'sum'"
                )
            if self.remat_policy is not None:
                raise ValueError(
                    f"{sched} hand-writes the per-cell recompute; "
                    "remat_policy does not apply (use schedule='fill_drain')"
                )
            if self.sp_axis is not None:
                # The reference's reason (a collective permute inside a
                # branch only some stages take) has a counterpart here: a
                # recomputed cell reissues its ring transfers, and only
                # fill-drain keeps every sp lane's cells in one order.
                raise ValueError(
                    f"{sched} does not compose with sequence "
                    "parallelism: ring attention's sp ppermutes would sit "
                    "inside the schedule's fwd/bwd conditional, whose "
                    "branches only some pipeline stages execute on a given "
                    "tick — collective-permute participation is global, so "
                    "lanes in the other branch would never join (verified "
                    "failure on the host backend).  psum-based tensor "
                    "parallelism is fine (group-local all-reduce); use "
                    "schedule='fill_drain' for sp"
                )
        if self.remat_policy is not None and self.checkpoint == "never":
            raise ValueError(
                "remat_policy only applies with checkpoint='always', "
                "'except_last' or 'offload'"
            )
        # Layers may declare mesh-validation hooks (the tensor-parallel
        # block checks that the tp size divides its head counts: flat-dim
        # divisibility alone would split a head across lanes).
        for lyr in (self.block, self.pre, self.post):
            if lyr is not None:
                for validate in _declared_axes(lyr, "validate_mesh"):
                    validate(self.mesh)
        # Layers that collect over a sequence or tensor axis declare it; a
        # mismatch with the engine's axes would silently compute
        # shard-local attention or partial sums, so fail loudly instead.
        for key, mine in (("sp_axis", self.sp_axis), ("tp_axis", self.tp_axis),
                          ("ep_axis", self.ep_axis)):
            declared = set()
            for lyr in (self.block, self.pre, self.post):
                if lyr is not None:
                    declared.update(_declared_axes(lyr, key))
            if declared and declared != {mine}:
                raise ValueError(
                    f"model layers declare {key} {sorted(map(str, declared))} "
                    f"but the engine was given {key}={mine!r}; set "
                    f"both from the same value (e.g. TransformerConfig.{key} "
                    f"and SpmdGPipe.{key})"
                )
        _ckpt.check_policy(self.remat_policy)
        # What later items of ROADMAP.md bring.
        if self.tracer is not None or self.partition_rules is not None \
                or self.hbm_budget_bytes is not None:
            raise not_ported("SpmdGPipe(tracer=, partition_rules=, hbm_budget_bytes=) "
                             "(the static-analysis and tracing layer, A.5.6)", "5.6")
        self._blocks_spec = layer_param_specs(self.block, self.pp_axis)
        v = self.virtual_stages
        if v > 1:
            # Blocks are stored [n, v, ...] (stage dim over pp, chunk dim
            # rank-local): declared per-stage specs gain a replicated chunk
            # dim at position 1; bare P(pp) prefixes leave it replicated.
            def with_chunk_dim(spec):
                if isinstance(spec, P):
                    return spec if len(spec) <= 1 else P(spec[0], None, *tuple(spec)[1:])
                if isinstance(spec, Mapping):
                    return {k: with_chunk_dim(x) for k, x in spec.items()}
                return type(spec)(with_chunk_dim(x) for x in spec)

            self._blocks_spec = with_chunk_dim(self._blocks_spec)
        # Every block leaf's global shape ([n, ...], or [n, v, ...]): the
        # layers hold whole tensors, tp shards included.
        lead = (self.n_stages,) + ((v,) if v > 1 else ())
        self._global_blocks = module_tree(
            self.block, lambda name, p: torch.empty((*lead, *p.shape), device="meta"))
        self._dp = self.mesh.shape[self.dp_axis] if self.dp_axis else 1
        self._fsdp_dims = None
        self._specs = {"blocks": self._blocks_spec}
        if self.fsdp:
            # The storage layout: each chosen leaf also sharded over dp.
            self._fsdp_dims, self._specs["blocks"] = self._fsdp_layout(
                self._global_blocks, self._dp)
        for key, lyr in (("pre", self.pre), ("post", self.post), ("loss", loss_lyr)):
            if lyr is not None:
                self._specs[key] = layer_param_specs(lyr, None)
        self._stage = self.mesh.coords[self.pp_axis]
        self._lane = self.mesh.coords[self.dp_axis] if self.dp_axis else 0
        self._ep = self.mesh.shape[self.ep_axis] if self.ep_axis else 1
        # The batch rows are sharded over dp x ep (row-major: lane d*ep + e).
        self._rows = self._dp * self._ep
        self._row_lane = self._lane * self._ep + (
            self.mesh.coords[self.ep_axis] if self.ep_axis else 0)
        self._sp = self.mesh.shape[self.sp_axis] if self.sp_axis else 1
        self._sp_lane = self.mesh.coords[self.sp_axis] if self.sp_axis else 0
        self._names = {
            "blocks": module_tree(self.block, lambda n, p: n),
            "pre": module_tree(self.pre, lambda n, p: n) if self.pre is not None else None,
            "post": module_tree(self.post, lambda n, p: n) if self.post is not None else None,
            "loss": module_tree(self.loss_fn, lambda n, p: n) if self._loss_is_layer else None,
        }
        self._warned_ragged_coupled = False
        self._loopback: Dict[int, torch.Tensor] = {}
        # Layers a stage's block runs (the keys' layer index per cell).
        self._per = len(self.block) if isinstance(self.block, nn.Sequential) else 1
        self._key: Optional[_rng.Key] = None   # the running step's rng
        self._where: Optional[Tuple[int, int, str]] = None   # the running cell
        self._offload: Optional[_ckpt.Offload] = None
        self._remat: Optional[_ckpt.Remat] = None
        # Bytes of the last 'offload' step (checkpoint.Offload).
        self.offload_stats = {"saved_bytes": 0, "moved_bytes": 0}
        # Bytes the remat policy kept in the last step (checkpoint.Remat).
        self.remat_stats = {"saved_bytes": 0}

    # ------------------------------------------------------------------ #
    # FSDP (ZeRO-3-style parameter sharding over dp)                     #
    # ------------------------------------------------------------------ #

    def _fsdp_layout(self, blocks: Pytree, dp: int) -> Tuple[Pytree, Pytree]:
        """The fsdp storage layout at data-parallel width ``dp``: per
        block leaf (``blocks``: global shapes, ``[n, ...]`` or ``[n, v,
        ...]``), the dim sharded over dp (-1 = replicated) and the
        storage specs (the leaf's spec with ``dp_axis`` at that dim)."""
        base = broadcast_specs(self._blocks_spec, blocks)

        def choose(spec: P, leaf: Any) -> int:
            # First dim after the stacked-stage dim (0) that no other axis
            # shards and that divides by dp; small/indivisible leaves (e.g.
            # norm scales) stay replicated.
            for i in range(1, len(leaf.shape)):
                taken = spec[i] if i < len(spec) else None
                if taken is None and leaf.shape[i] % dp == 0 and leaf.shape[i] >= dp:
                    return i
            return -1

        dims = _tree_map(choose, base, blocks)

        def augment(spec: P, dim: int) -> P:
            if dim < 0:
                return spec
            parts = list(spec) + [None] * (dim + 1 - len(spec))
            parts[dim] = self.dp_axis
            return P(*parts)

        return dims, _tree_map(augment, base, dims)

    def _gather_fsdp(self, blocks_local: Pytree) -> Pytree:
        """Full block tensors from this rank's dp shards (all-gathered over
        dp, staged under ``'fsdp'``), as new leaves that collect the
        step's gradients; a replicated leaf is passed through."""

        def gather(a: torch.Tensor, dim: int) -> torch.Tensor:
            if dim < 0:
                return a
            full = torch.cat(self.mesh.all_gather(a.detach(), self.dp_axis, kind="fsdp"), dim)
            return full.requires_grad_(a.requires_grad)

        return _tree_map(gather, blocks_local, self._fsdp_dims)

    # ------------------------------------------------------------------ #
    # parameters                                                         #
    # ------------------------------------------------------------------ #

    def _layers(self) -> List[Tuple[str, nn.Module]]:
        out = [("pre", self.pre), ("blocks", self.block), ("post", self.post)]
        if self._loss_is_layer:
            out.append(("loss", self.loss_fn))
        return [(k, m) for k, m in out if m is not None]

    @staticmethod
    def _check_stateless(layer: nn.Module, what: str) -> None:
        if any(True for _ in layer.buffers()):
            raise ValueError(
                f"SPMD engine requires stateless layers, but {what} carries "
                "state (e.g. BatchNorm running stats). Use the MPMD GPipe "
                "engine, or a stateless normalization (LayerNorm/RMSNorm)."
            )

    def _tree(self, key: str, layer: nn.Module) -> Pytree:
        skip = self._tie_post if key == "post" else self._tie_loss if key == "loss" else ()
        return module_tree(layer, skip=skip)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator], in_spec: Any) -> dict:
        """``{'pre', 'blocks', 'post'[, 'loss']}`` params, the blocks
        stacked on a leading ``[n_stages]`` axis, the same on every rank:
        each layer is drawn in turn from ``generator`` (its
        ``reset_parameters(generator)``: pre, stage 0 .. n-1's block, post,
        loss; a layer without one keeps its constructed values).  The tree
        lies where the layers do (host memory for layers built on the CPU
        or the meta device's shapes); :meth:`place` takes this rank's part
        to its device.  ``in_spec`` is an example input (a tensor, or
        ``(shape, dtype)``): the block must preserve the shape and dtype of
        the activations it receives."""
        for key, layer in self._layers():
            self._check_stateless(layer, key)
        shape, dtype = ((tuple(in_spec.shape), in_spec.dtype)
                        if isinstance(in_spec, torch.Tensor) else in_spec)
        x = torch.zeros(shape, dtype=dtype, device="meta")
        # Shapes only: a random layer draws from a placeholder key.
        with _rng.scope(_rng.Key(torch.zeros((), dtype=torch.int64))):
            if self.pre is not None:
                x = _call(self.pre, self._names["pre"],
                          _tree_map(lambda t: t.to("meta"), module_tree(self.pre)), x)
            y = _call(self.block, self._names["blocks"],
                      _tree_map(lambda t: t.to("meta"), module_tree(self.block)), x)
        if not isinstance(y, torch.Tensor) or y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(
                "SPMD pipeline blocks must preserve activation shape/dtype "
                f"(got {tuple(x.shape)} {x.dtype} -> "
                f"{tuple(getattr(y, 'shape', ()))} {getattr(y, 'dtype', None)}); "
                "use the MPMD GPipe engine for heterogeneous stages"
            )

        def reset(layer: nn.Module) -> None:
            if hasattr(layer, "reset_parameters"):
                layer.reset_parameters(generator)
            elif isinstance(layer, nn.Sequential):
                for child in layer:
                    reset(child)

        def draw(layer: nn.Module, key: str) -> Pytree:
            if generator is not None:
                reset(layer)
            return _tree_map(lambda t: t.detach().clone(), self._tree(key, layer))

        params: dict = {}
        if self.pre is not None:
            params["pre"] = draw(self.pre, "pre")
        n, v = self.n_stages, self.virtual_stages
        drawn = [draw(self.block, "blocks") for _ in range(n * v)]
        if v == 1:
            params["blocks"] = _stack(drawn)
        else:
            # [n, v, ...]: stage j's chunk c is global block c*n + j (the
            # Megatron round-robin), the blocks drawn in global order.
            params["blocks"] = _stack([_stack([drawn[c * n + j] for c in range(v)])
                                       for j in range(n)])
        if self.post is not None:
            params["post"] = draw(self.post, "post")
        if self._loss_is_layer:
            params["loss"] = draw(self.loss_fn, "loss")
        return params

    @torch.no_grad()
    def place(self, params: dict) -> dict:
        """This rank's part of a global params tree (blocks ``[n_stages,
        ...]``, ``[n_stages, virtual_stages, ...]`` interleaved) on its
        device, as copies: the stage's ``[1, ...]`` slice of the blocks,
        every leaf that a layer's ``param_specs`` shards over ``tp`` cut to
        this lane's slice along its partitioned dim, under ``fsdp`` each
        block leaf the chooser picks (:meth:`_fsdp_layout`) cut to this dp
        lane's 1/dp, the rest of pre/post/loss whole.  Keys the engine
        owns no layout for pass through."""
        self._check_global(params)
        out = dict(params)
        for key, _ in self._layers():
            out[key] = _tree_map(self._shard, params[key],
                                 broadcast_specs(self._specs[key], params[key]))
        return out

    def _shard(self, a: torch.Tensor, spec: P) -> torch.Tensor:
        """A contiguous copy on this rank's device of its slice of global
        leaf ``a`` under ``spec`` (several axes on one dim: row-major)."""
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            idx, n = 0, 1
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                idx, n = idx * self.mesh.shape[name] + self.mesh.coords[name], \
                    n * self.mesh.shape[name]
            per = a.shape[dim] // n
            a = a.narrow(dim, idx * per, per)
        return torch.empty(a.shape, dtype=a.dtype, device=self.mesh.device).copy_(a)

    def place_tree(self, tree: Pytree) -> Pytree:
        """Every tensor leaf of ``tree`` on this rank's device (optimizer
        state, restored host arrays)."""
        return _tree_map(
            lambda a: a.to(self.mesh.device) if isinstance(a, torch.Tensor) else a, tree)

    def gather(self, tree: dict) -> Optional[dict]:
        """The global tree (blocks ``[n_stages, ...]``, tp- and
        fsdp-sharded leaves whole) of per-rank trees (params or grads, as
        :meth:`place` and :meth:`train_step` give them), assembled in host
        memory on global rank 0 from the ranks that hold each piece; None
        on every other rank.  For tests and checkpoints."""
        mesh = self.mesh
        keys = [k for k, _ in self._layers()]
        leaves = [(key, path, a, spec) for key in keys
                  for (path, a), (_, spec) in zip(
                      _items(tree[key]), _items(broadcast_specs(self._specs[key], tree[key])))]

        def axes_of(spec: P) -> List[str]:
            return [n for ax in spec if ax is not None
                    for n in (ax if isinstance(ax, tuple) else (ax,))]

        if mesh.rank != 0:
            for k, (_, _, a, spec) in enumerate(leaves):
                mine = axes_of(spec)
                if all(mesh.coords[n] == 0 for n in mesh.axis_names if n not in mine) \
                        and any(mesh.coords[n] != 0 for n in mine):
                    mesh.send(a, 0, _GATHER * _TAG + k)
            mesh.flush()
            return None
        out = {k: v for k, v in tree.items() if k not in keys}
        whole: Dict[str, Dict[tuple, torch.Tensor]] = {key: {} for key in keys}
        for k, (key, path, a, spec) in enumerate(leaves):
            def piece(at: Dict[str, int], a=a, k=k) -> torch.Tensor:
                if not any(at.values()):
                    return a.detach().cpu()
                src = mesh.rank_of(**{n: at.get(n, 0) for n in mesh.axis_names})
                return mesh.recv(src, _GATHER * _TAG + k).cpu()

            whole[key][path] = _assemble(spec, mesh.shape, piece)
        for key in keys:
            out[key] = self._rebuild(tree[key], whole[key])
        return out

    # ------------------------------------------------------------------ #
    # sharded checkpoints                                                #
    # ------------------------------------------------------------------ #

    def shards(self, tree: dict) -> dict:
        """``tree`` (params or grads in :meth:`place`'s layout) with each
        leaf of the engine's layers as a ``utils.serialization.Shard``:
        its global shape and where this rank's piece starts, by the leaf's
        spec (the stage's ``[1, ...]`` slice of the blocks, a tp or ep
        lane's slice, an fsdp lane's 1/dp), and whether this rank writes
        it (of the ranks holding one piece, the one at coordinate 0 of
        every axis the spec leaves out).  Other keys pass through (whole
        leaves, which rank 0 writes)."""
        out = dict(tree)
        for key, _ in self._layers():
            out[key] = _tree_map(self._shard_index, tree[key],
                                 broadcast_specs(self._specs[key], tree[key]))
        return out

    def _shard_index(self, a: torch.Tensor, spec: P) -> Any:
        from torchgpipe_tpu_torch.utils.serialization import Shard

        gshape, start, named = list(a.shape), [0] * a.ndim, set()
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            idx, n = 0, 1
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                idx, n = idx * self.mesh.shape[name] + self.mesh.coords[name], \
                    n * self.mesh.shape[name]
                named.add(name)
            gshape[dim], start[dim] = a.shape[dim] * n, idx * a.shape[dim]
        owner = all(self.mesh.coords[n] == 0 for n in self.mesh.axis_names if n not in named)
        return Shard(a, tuple(gshape), tuple(start), owner)

    def _zero1_layout(self) -> str:
        """The layout a ZeRO-1 segment belongs to: the mesh, and this rank's
        coordinates off dp (a segment is a piece of a rank-local flat leaf,
        so it restores only into the same mesh)."""
        at = ",".join(f"{n}={c}" for n, c in self.mesh.coords.items() if n != self.dp_axis)
        return f"ZeRO-1 segments of mesh {self.mesh.shape} at {at}"

    @staticmethod
    def _state_names(opt: torch.optim.Optimizer, t: torch.Tensor
                     ) -> Dict[str, Any]:
        """The state ``opt`` keeps for a tensor like ``t`` before its first
        step: a throwaway of ``opt``'s class and hyperparameters steps once
        on a 2-element probe; each state entry of the probe's shape becomes
        an empty tensor like ``t``, each other entry (a step count) itself."""
        group = next(g for g in opt.param_groups if any(p is t for p in g["params"]))
        probe = torch.zeros(2, dtype=t.dtype, device=t.device, requires_grad=True)
        probe.grad = torch.zeros_like(probe)
        twin = type(opt)([dict({k: v for k, v in group.items() if k != "params"},
                               params=[probe])])
        twin.step()
        return {name: torch.empty_like(t) if isinstance(v, torch.Tensor)
                and v.shape == probe.shape else v
                for name, v in twin.state[probe].items()}

    def train_state(self, params: dict, optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> dict:
        """What a sharded checkpoint of this rank's training state holds:
        ``{'params': shards(params)[, 'opt': ...]}``, ``'opt'`` a list over
        ``optimizer``'s tensors (:meth:`zero_opt_state`'s, in the engine's
        leaf order) of its state by name, each entry that mirrors a
        tensor as a ``Shard`` of that tensor's leaf (ZeRO-1's segments in
        the layout of their mesh alone), a step count whole.  A fresh
        optimizer (no step yet) gives empty tensors of the state's shapes:
        the template a restore reads into.  Save it with
        ``CheckpointManager(...).save(step, state, sharded=True)``
        (or ``serialization.save_sharded``); restore with
        ``restore_latest(train_state(...))`` and :meth:`load_train_state`."""
        from torchgpipe_tpu_torch.utils.serialization import Shard

        state: dict = {"params": self.shards(params)}
        if optimizer is None:
            return state
        index = [sh for key, _ in self._layers() for sh in _leaves(state["params"][key])]
        level = getattr(optimizer, "zero_level", 0)
        opt = []
        for sh, t in zip(index, optimizer.zero_segments):
            names = optimizer.state.get(t) or self._state_names(optimizer, t)
            entry = {}
            for name, v in names.items():
                if not (isinstance(v, torch.Tensor) and v.shape == t.shape and v.ndim):
                    entry[name] = v
                elif level == 1:
                    n = t.numel()
                    entry[name] = Shard(v, (n * self._dp,), (self._lane * n,), True,
                                        self._zero1_layout())
                else:
                    entry[name] = Shard(v, sh.global_shape, sh.start, sh.owner)
            opt.append(entry)
        state["opt"] = opt
        return state

    @torch.no_grad()
    def load_train_state(self, state: dict, params: dict,
                         optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        """Load a restored :meth:`train_state` tree: each parameter copied
        in place into ``params`` (the tensors the optimizer and a captured
        step hold), and ``optimizer``'s state through its own
        ``load_state_dict``."""
        for key, _ in self._layers():
            for dst, src in zip(_leaves(params[key]), _leaves(state["params"][key])):
                dst.copy_(src)
        if optimizer is not None:
            sd = optimizer.state_dict()
            sd["state"] = {i: dict(entry) for i, entry in enumerate(state["opt"])}
            optimizer.load_state_dict(sd)

    @staticmethod
    def _rebuild(tree: Pytree, by_path: Dict[tuple, Any], path: tuple = ()) -> Pytree:
        if isinstance(tree, Mapping):
            return {k: SpmdGPipe._rebuild(v, by_path, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(SpmdGPipe._rebuild(v, by_path, path + (i,))
                              for i, v in enumerate(tree))
        return by_path[path]

    def _check_structure(self, params: Any) -> None:
        if not isinstance(params, dict) or "blocks" not in params:
            raise ValueError(
                "params must be the dict returned by SpmdGPipe.init "
                "(keys 'blocks' and, when pre/post are set, 'pre'/'post'); "
                f"got {type(params).__name__} with keys "
                f"{sorted(params) if isinstance(params, dict) else 'n/a'}"
            )
        checks = [("pre", self.pre), ("post", self.post)]
        if self._loss_is_layer:
            checks.append(("loss", self.loss_fn))
        for key, layer in checks:
            if (layer is not None) != (key in params):
                raise ValueError(
                    f"engine {'defines' if layer is not None else 'has no'} "
                    f"{key!r} layer but params "
                    f"{'lacks' if layer is not None else 'contains'} a "
                    f"{key!r} entry — params must come from THIS engine's "
                    "init (pre/post configuration must match)"
                )
        for key, keys in (("post", self._tie_post), ("loss", self._tie_loss)):
            entry = params.get(key)
            if not (keys and isinstance(entry, dict)):
                continue
            dup = [k for k in keys if k in entry]
            if dup:
                raise ValueError(
                    f"params[{key!r}] contains tied pre-param entr"
                    f"{'ies' if len(dup) > 1 else 'y'} {dup}: the engine "
                    "splices these from params['pre'] at apply time "
                    "(meta['tie_pre']), and a duplicated tensor would be "
                    "updated twice by an optimizer.  Drop them — e.g. "
                    "assemble imported weights with "
                    "models.generation.spmd_params_from_flat"
                )
        for key, layer in self._layers():
            want = self._tree(key, layer)
            got_paths = [p for p, _ in _items(params[key])]
            want_items = _items(want)
            if sorted(map(str, got_paths)) != sorted(str(p) for p, _ in want_items):
                raise ValueError(
                    f"params[{key!r}] has leaves {sorted(map(str, got_paths))}, "
                    f"the engine's {key} layer {sorted(str(p) for p, _ in want_items)}: "
                    "params were initialized for a different pipeline "
                    "configuration"
                )

    def _check_leading(self, params: dict, want: Tuple[int, ...], what: str) -> None:
        for leaf in _leaves(params["blocks"]):
            got = tuple(leaf.shape[:len(want)])
            if got != want:
                raise ValueError(
                    f"block param leaf has leading dims {got}, expected "
                    f"{want} (= {what}); params were initialized for a "
                    "different pipeline configuration"
                )
            break  # leading-dim layout is uniform; one leaf suffices

    def _check_global(self, params: Any) -> None:
        self._check_structure(params)
        v = self.virtual_stages
        self._check_leading(params, (self.n_stages,) if v == 1 else (self.n_stages, v),
                            "(n_stages,)" if v == 1 else "(n_stages, virtual_stages)")
        for key, _ in self._layers():
            self._check_spec_shapes(params[key], broadcast_specs(self._specs[key],
                                                                 params[key]))

    def _check_params(self, params: Any) -> None:
        """Validation of this rank's params tree (:meth:`place`'s result)
        before the step: structure, this stage's ``[1, ...]`` slice of the
        blocks (``[1, v, ...]`` interleaved; the chunk dim cut over dp
        where fsdp shards it), and every leaf on this rank's device."""
        self._check_structure(params)
        want, what = (1,), "this rank's slice of (n_stages,)"
        if self.virtual_stages > 1:
            first = _leaves(self._fsdp_dims)[0] if self.fsdp else -1
            v = self.virtual_stages // (self._dp if first == 1 else 1)
            want, what = (1, v), "this rank's slice of (n_stages, virtual_stages)"
        self._check_leading(params, want, what + ": pass the tree through SpmdGPipe.place")
        for key, _ in self._layers():
            for path, a in _items(params[key]):
                if a.device != self.mesh.device:
                    raise ValueError(
                        f"params[{key!r}] leaf {path} is on {a.device}, this rank's "
                        f"device is {self.mesh.device}: pass the tree through "
                        "SpmdGPipe.place")

    def _check_spec_shapes(self, blocks: Pytree, specs: Pytree) -> None:
        """Every sharded dim must divide by its mesh-axis size — checked
        eagerly for a didactic error."""

        def chk(a, spec):
            if len(tuple(spec)) > len(a.shape):
                raise ValueError(
                    f"partition spec {spec} names {len(tuple(spec))} "
                    f"dims but the param has shape {tuple(a.shape)} "
                    f"({len(a.shape)} dims); trim the rule's spec"
                )
            for i, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                for a_ in axes:
                    if a_ not in self.mesh.shape:
                        raise ValueError(
                            f"partition spec {spec} mentions mesh axis "
                            f"{a_!r} which this mesh (axes "
                            f"{list(self.mesh.axis_names)}) does not "
                            "have; fix the param_specs declaration or add "
                            "the axis to the mesh"
                        )
                size = 1
                for a_ in axes:
                    size *= self.mesh.shape[a_]
                if a.shape[i] % size != 0:
                    raise ValueError(
                        f"param dim {i} of shape {tuple(a.shape)} is sharded over "
                        f"mesh axes {axes} (size {size}) but is not "
                        "divisible by it; adjust the model dims"
                    )

        _tree_map(chk, blocks, specs)

    def _check_batch(self, x: Pytree, target: Optional[Pytree] = None, *,
                     ragged_ok: bool = False) -> int:
        """The number of padding rows a ragged batch needs (0 when already
        divisible); ``ragged_ok`` callers pad and mask instead of raising."""
        b = microbatch.batch_size(x)
        pad = (-b) % (self.chunks * self._rows)
        if pad and not ragged_ok:
            raise ValueError(
                f"batch size {b} must be divisible by chunks*dp*ep = "
                f"{self.chunks}*{self._dp}*{self._ep} = {self.chunks * self._rows} here: "
                "ragged batches need a row-decomposable loss to weight the "
                "padding out — set loss_reduction='mean' or 'sum' (or use "
                "the MPMD GPipe engine, whose scheduler runs ragged "
                "micro-batches natively)"
            )
        if self.sp_axis:
            trees = [("input", x)] + ([("target", target)] if target is not None else [])
            for what, tree in trees:
                for leaf in _leaves(tree):
                    if leaf.ndim < 2 or leaf.shape[1] % self._sp != 0:
                        raise ValueError(
                            f"sequence parallelism shards data dim 1 over "
                            f"{self.sp_axis}={self._sp}; got {what} leaf shape "
                            f"{tuple(leaf.shape)}"
                        )
        return pad

    # ------------------------------------------------------------------ #
    # data layout                                                        #
    # ------------------------------------------------------------------ #

    def _local_microbatches(self, tree: Pytree, seq: bool = True) -> List[Pytree]:
        """This lane's ``m`` micro-batches of a padded global batch: ``[B]
        -> [m, B/m]`` (micro-batch major), row lane ``d`` of the ``dp *
        ep`` lanes (``d = dp_index * ep + ep_index``) keeping rows ``[d*b,
        (d+1)*b)`` of each (``b = B / (m * dp * ep)``), and, under an sp
        axis (``seq``), sp lane ``r`` positions ``[r*s, (r+1)*s)`` of dim 1
        (``s = S / sp``): the reference's data spec ``P(None, (dp, ep),
        sp)``."""
        m, dp, d = self.chunks, self._rows, self._row_lane
        sp, r = (self._sp, self._sp_lane) if seq else (1, 0)
        dev = self.mesh.device

        def part(a, i):
            b = a.shape[0] // (m * dp)
            a = a.reshape(m, dp * b, *a.shape[1:])[i, d * b:(d + 1) * b]
            if sp > 1:
                s = a.shape[1] // sp
                a = a[:, r * s:(r + 1) * s]
            return a.to(dev)

        return [_tree_map(lambda a: part(a, i), tree) for i in range(m)]

    # ------------------------------------------------------------------ #
    # cells                                                              #
    # ------------------------------------------------------------------ #

    def _run_block(self, blocks: Pytree, x: torch.Tensor,
                   key: Optional[Tuple[_rng.Key, int]] = None) -> torch.Tensor:
        """The stage's block on ``x``; with a cell ``key`` (the
        micro-batch's key and the whole-model index of the block's first
        layer) each of its layers runs under its own key."""
        p = _tree_map(lambda a: a[0], blocks)
        if key is None:
            return _call(self.block, self._names["blocks"], p, x)
        mb, first = key
        mapping = {name: _get(p, path) for path, name in _items(self._names["blocks"])}
        layers = list(self.block) if isinstance(self.block, nn.Sequential) else [self.block]
        with _reparametrize_module(self.block, mapping):
            for li, layer in enumerate(layers):
                with _rng.scope(mb.fold(first + li)):
                    x = layer(x)
        return x

    def _cell_key(self, i: int, g: int) -> Optional[Tuple[_rng.Key, int]]:
        """The key of micro-batch ``i``'s cell at global (virtual) stage
        ``g``: ``fold_in(rng, i)``, and its layers at their index in the
        whole model ``[pre, every block's layers, post]``, as the MPMD
        ``GPipe`` numbers them; so every schedule (fill-drain, 1F1B,
        zero-bubble, interleaved over the same global blocks) draws the
        same masks."""
        if self._key is None:
            return None
        return self._key.fold(i), 1 + g * self._per

    def _end_key(self, i: int, post: bool) -> Optional[_rng.Key]:
        """``pre``'s key for micro-batch ``i`` (layer 0), or ``post``'s for
        its ``i``-th call (the layer after the last block)."""
        if self._key is None:
            return None
        layer = 1 + self.n_stages * self.virtual_stages * self._per if post else 0
        return self._key.fold(i).fold(layer)

    def _run_pre(self, leaves: dict, x: Pytree, train: bool, i: int = 0) -> torch.Tensor:
        with _rng.scope(self._end_key(i, False) if train else None):
            return _call(self.pre, self._names["pre"], leaves["pre"], x)

    def _tied(self, own: Pytree, pre: Pytree, keys: Tuple[str, ...]) -> Pytree:
        """Splice tied pre-param entries into a post/loss layer's tree:
        the same tensor, so autograd sums both paths' gradients into the
        pre leaf."""
        if not keys:
            return own
        return dict(own, **{k: pre[k] for k in keys})

    def _run_post(self, leaves: dict, y: torch.Tensor, i: Optional[int] = None
                  ) -> torch.Tensor:
        p = self._tied(leaves["post"], leaves.get("pre", ()), self._tie_post)
        names = self._names["post"]
        if self._tie_post:
            names = dict(names, **{k: k for k in self._tie_post})
        with _rng.scope(None if i is None else self._end_key(i, True)):
            return _call(self.post, names, p, y)

    def _loss_call(self, leaves: dict, y: Any, tgt: Any) -> torch.Tensor:
        """The engine's one loss entry point: a plain ``loss_fn(y, tgt)``
        callable, or a parametric loss layer with its own params."""
        if self._loss_is_layer:
            p = self._tied(leaves["loss"], leaves.get("pre", ()), self._tie_loss)
            names = self._names["loss"]
            if self._tie_loss:
                names = dict(names, **{k: k for k in self._tie_loss})
            return _call(self.loss_fn, names, p, y, tgt)
        return self.loss_fn(y, tgt)

    def _masked_loss_sum(self, leaves: dict, y: Any, tgt: Any,
                         mask: torch.Tensor) -> torch.Tensor:
        """``Σ_rows mask · loss_fn(row)``: a loss layer with ``row_loss``
        (``[B]`` per-row losses) in one call, any other loss one batch-1
        row at a time.  Padded rows add zero to value and gradient."""
        if self._loss_is_layer and hasattr(self.loss_fn, "row_loss"):
            p = self._tied(leaves["loss"], leaves.get("pre", ()), self._tie_loss)
            names = self._names["loss"]
            if self._tie_loss:
                names = dict(names, **{k: k for k in self._tie_loss})
            mapping = {name: _get(p, path) for path, name in _items(names)}
            from torch.nn.utils.stateless import _reparametrize_module

            with _reparametrize_module(self.loss_fn, mapping):
                rows = self.loss_fn.row_loss(y, tgt).float()
            return (rows * mask).sum()
        b = mask.shape[0]
        rows = torch.stack([
            self._loss_call(leaves, _tree_map(lambda a: a[r:r + 1], y),
                            _tree_map(lambda a: a[r:r + 1], tgt)).float()
            for r in range(b)])
        return (rows * mask).sum()

    def _mask_mean_scale(self, mask_local: torch.Tensor) -> torch.Tensor:
        """The scale turning a lane-local masked row-loss sum into a value
        whose dp and ep means are the global masked mean: dp·ep over the
        real row count (summed over dp and ep from the mask itself)."""
        axes = tuple(a for a in (self.dp_axis, self.ep_axis) if a)
        n_real = self.mesh.all_reduce(mask_local.sum().float(), axes, kind="loss") \
            if axes else mask_local.sum().float()
        return self._rows / n_real

    def _cell_forward(self, blocks: Pytree, h: torch.Tensor, ckpt: bool,
                      need_grad: bool, i: int, g: Optional[int] = None
                      ) -> Tuple[torch.Tensor, _Cell]:
        """Micro-batch ``i``'s cell forward at global stage ``g`` (default
        this stage): the block on a leaf copy of the input, without a
        graph when checkpointed (recomputed by :meth:`_cell_backward`);
        under ``'offload'`` its saved tensors go to host memory."""
        g = self._stage if g is None else g
        self._where = (g, i, self._block_name())
        key = self._cell_key(i, g)
        x = h.detach()
        if need_grad:
            x.requires_grad_()
        with aux_scale(1.0 / self.chunks):
            if ckpt:
                keep = contextlib.nullcontext() if self._remat is None else \
                    self._remat.forward((g, i))
                with torch.no_grad(), _ckpt.phase(checkpointing=True), keep:
                    y = self._run_block(blocks, x, key)
                return y, _Cell(h, x, None, True, i, g, key)
            if self._offload is None:
                y = self._run_block(blocks, x, key)
            else:
                with self._offload.cell(i, self.mesh.device, [x, *_leaves(blocks)]):
                    y = self._run_block(blocks, x, key)
        return y.detach(), _Cell(h, x, y, False, i, g, key)

    def _cell_backward(self, blocks: Pytree, cell: _Cell, gy: torch.Tensor
                       ) -> Optional[torch.Tensor]:
        """Apply ``gy`` to the cell's output (recomputing it first when
        checkpointed; under ``'offload'`` its saved tensors fetched back,
        the next cell's on their way); returns its input's gradient, if
        it takes one."""
        self._where = (cell.stage, cell.i, self._block_name())
        if self._offload is not None:
            dev = self.mesh.device
            self._offload.before_backward(cell.i, dev, cell.i - 1 if cell.i else None, dev)
        y = self._recompute(blocks, cell) if cell.ckpt else cell.y
        torch.autograd.backward(y, gy)
        cell.y = None
        return cell.x.grad if cell.x.requires_grad else None

    def _block_name(self, layer: Optional[nn.Module] = None, what: str = "block") -> str:
        """``block 'stage'`` (or ``what`` and ``layer``'s name): a failing
        cell's note."""
        layer = self.block if layer is None else layer
        return f"{what} {getattr(layer, 'name', type(layer).__name__)!r}"

    def _recompute(self, blocks: Pytree, cell: _Cell) -> torch.Tensor:
        """A checkpointed cell's output again, with its graph (and its
        key: the same masks)."""
        take = contextlib.nullcontext() if self._remat is None else \
            self._remat.recompute((cell.stage, cell.i))
        with aux_scale(1.0 / self.chunks), _ckpt.phase(recomputing=True), take:
            return self._run_block(blocks, cell.x, cell.key)

    def _stage_input(self, leaves: dict, x_mb: List[Pytree], i: int) -> torch.Tensor:
        """Stage 0: ``pre`` of micro-batch ``i`` (its graph kept for the
        pre gradients) or the micro-batch itself; later stages: the
        previous stage's activation."""
        if self._stage > 0:
            return self.mesh.recv(self.mesh.rank_of(self._stage - 1, self._lane),
                                  _ACT * _TAG + i)
        if self.pre is None:
            return x_mb[i]
        self._where = (0, i, self._block_name(self.pre, "pre layer"))
        with aux_scale(1.0 / self.chunks):
            return self._run_pre(leaves, x_mb[i], True, i)

    def _need_input_grad(self, h: torch.Tensor) -> bool:
        return torch.is_floating_point(h) and (self._stage > 0 or self.pre is not None)

    def _send_input_grad(self, cell: _Cell, g: Optional[torch.Tensor], i: int) -> None:
        if g is None:
            return
        if self._stage > 0:
            self.mesh.send(g, self.mesh.rank_of(self._stage - 1, self._lane),
                           _GRAD * _TAG + i)
        elif cell.h.requires_grad:   # stage 0: into pre's parameters
            torch.autograd.backward(cell.h, g)

    # ------------------------------------------------------------------ #
    # the step                                                           #
    # ------------------------------------------------------------------ #

    def _leaf_copy(self, params: dict) -> dict:
        """Leaves sharing ``params``' storage that collect gradients."""
        out = {}
        for key, _ in self._layers():
            out[key] = _tree_map(lambda a: a.detach().requires_grad_(a.is_floating_point()),
                                 params[key])
        return out

    def _head_slices(self, leaves: dict, outs: Optional[List[torch.Tensor]],
                     tgt: Pytree, mask: Optional[torch.Tensor],
                     mean_scale: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                                  Optional[List[torch.Tensor]]]:
        """The fill-drain loss side.  With a decomposable loss and a lane
        batch that divides by n (n > 1), the head and loss are sharded
        over pp: the last stage sends slice s of its gathered outputs to
        stage s, every stage runs the head and loss on its slice and
        returns the slice's gradient.  Otherwise the last stage runs them
        on the whole lane batch.  Returns this rank's loss term and, on
        the last stage, the micro-batch output gradients."""
        n, j, mesh = self.n_stages, self._stage, self.mesh
        last = mesh.rank_of(n - 1, self._lane)
        m = self.chunks
        B = microbatch.batch_size(tgt)
        sharded = self.loss_reduction is not None and B % n == 0 and n > 1
        if not sharded:
            if j != n - 1:
                return torch.zeros((), device=mesh.device), None
            g = torch.cat(outs, 0).requires_grad_()
            loss = self._loss_over(leaves, g, tgt, mask, mean_scale, 1)
            loss.backward()
            return loss.detach(), list(g.grad.chunk(m, 0))
        per = B // n
        if j == n - 1:
            gathered = torch.cat(outs, 0)
            for s in range(n - 1):
                mesh.send(gathered[s * per:(s + 1) * per], mesh.rank_of(s, self._lane),
                          _SLICE * _TAG)
            mine = gathered[(n - 1) * per:].detach()
        else:
            mine = mesh.recv(last, _SLICE * _TAG)
        mine.requires_grad_()
        sl = slice(j * per, (j + 1) * per)
        loss = self._loss_over(
            leaves, mine, _tree_map(lambda a: a[sl], tgt),
            None if mask is None else mask[sl], mean_scale, n)
        loss.backward()
        if j != n - 1:
            mesh.send(mine.grad, last, _SLICE_GRAD * _TAG)
            return loss.detach(), None
        grads = [mesh.recv(mesh.rank_of(s, self._lane), _SLICE_GRAD * _TAG)
                 for s in range(n - 1)] + [mine.grad]
        return loss.detach(), list(torch.cat(grads, 0).chunk(m, 0))

    def _loss_over(self, leaves: dict, y: torch.Tensor, tgt: Pytree,
                   mask: Optional[torch.Tensor], mean_scale: Optional[torch.Tensor],
                   n_slices: int) -> torch.Tensor:
        """Head and loss of ``y`` (a slice of ``n_slices``), as the
        reference's fill-drain ``loss_of``."""
        if self.post is not None:
            with aux_scale(1.0 / n_slices):
                y = self._run_post(leaves, y, self._stage)
        if mask is not None:
            l = self._masked_loss_sum(leaves, y, tgt, mask)
            return l * mean_scale if self.loss_reduction == "mean" else l
        l = self._loss_call(leaves, y, tgt).float()
        return l / n_slices if self.loss_reduction == "mean" and n_slices > 1 else l

    def _cell_mb_loss(self, leaves: dict, y: torch.Tensor, tgt_i: Pytree,
                      mask_i: Optional[torch.Tensor],
                      mean_scale: Optional[torch.Tensor], i: int) -> torch.Tensor:
        """Per-micro-batch head + loss for a final 1F1B cell (aux scale
        1/m); with ``mask_i`` the masked row sum scaled so the sum over
        cells and the dp mean give the exact loss over the real rows."""
        if self.post is not None:
            with aux_scale(1.0 / self.chunks):
                y = self._run_post(leaves, y, i)
        if mask_i is not None:
            s = self._masked_loss_sum(leaves, y, tgt_i, mask_i)
            if self.loss_reduction == "mean":
                s = s * (self.chunks * mean_scale)
            loss_i = s
        else:
            loss_i = self._loss_call(leaves, y, tgt_i).float()
        if self.loss_reduction == "mean":
            loss_i = loss_i / self.chunks
        return loss_i

    def _fill_drain(self, leaves, x_mb, tgt_mb, mask_mb, mean_scale, stop):
        n, m, j, mesh = self.n_stages, self.chunks, self._stage, self.mesh
        blocks = leaves["blocks"]
        cells, outs = [], []
        for i in range(m):
            h = _faults.spmd_corrupt_cell_input(j, i, self._stage_input(leaves, x_mb, i))
            y, cell = self._cell_forward(blocks, h, i < stop, self._need_input_grad(h), i)
            cells.append(cell)
            if j < n - 1:
                mesh.send(y, mesh.rank_of(j + 1, self._lane), _ACT * _TAG + i)
            else:
                outs.append(y)
        tgt = microbatch.gather(tgt_mb)
        mask = torch.cat(mask_mb) if mask_mb is not None else None
        loss, gys = self._head_slices(leaves, outs, tgt, mask, mean_scale)
        for i in reversed(range(m)):
            gy = gys[i] if j == n - 1 else mesh.recv(mesh.rank_of(j + 1, self._lane),
                                                     _GRAD * _TAG + i)
            g = self._cell_backward(blocks, cells[i], gy)
            self._send_input_grad(cells[i], g, i)
            cells[i] = None
        return loss

    def _one_f_one_b(self, leaves, x_mb, tgt_mb, mask_mb, mean_scale, stop):
        n, m, j, mesh = self.n_stages, self.chunks, self._stage, self.mesh
        blocks = leaves["blocks"]
        ops = sorted([(fwd_tick(i, j, n), "F", i) for i in range(m)]
                     + [(bwd_tick(i, j, n), "B", i) for i in range(m)])
        cells: Dict[int, _Cell] = {}
        outs: Dict[int, torch.Tensor] = {}
        loss = torch.zeros((), device=mesh.device)
        for _, op, i in ops:
            if op == "F":
                h = self._stage_input(leaves, x_mb, i)
                y, cells[i] = self._cell_forward(blocks, h, i < stop,
                                                 self._need_input_grad(h), i)
                if j < n - 1:
                    mesh.send(y, mesh.rank_of(j + 1, self._lane), _ACT * _TAG + i)
                else:
                    outs[i] = y
                continue
            if j == n - 1:
                l_i, gy = self._last_cell_loss(leaves, outs.pop(i), tgt_mb, mask_mb,
                                               mean_scale, i)
                loss = loss + l_i
            else:
                gy = mesh.recv(mesh.rank_of(j + 1, self._lane), _GRAD * _TAG + i)
            cell = cells.pop(i)
            self._send_input_grad(cell, self._cell_backward(blocks, cell, gy), i)
        return loss

    def _last_cell_loss(self, leaves: dict, y: torch.Tensor, tgt_mb: List[Pytree],
                        mask_mb: Optional[List[torch.Tensor]],
                        mean_scale: Optional[torch.Tensor], i: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The explicit-gradient schedules' loss cell: micro-batch ``i``'s
        head and loss on the model's last output ``y`` (post/loss
        gradients accumulated), its loss and ``y``'s gradient."""
        y = y.requires_grad_()
        l_i = self._cell_mb_loss(leaves, y, tgt_mb[i],
                                 None if mask_mb is None else mask_mb[i], mean_scale, i)
        l_i.backward()
        return l_i.detach(), y.grad

    # interleaved: rank j's chunk c is global block c*n + j --------------- #

    def _chunk_trees(self, blocks: Pytree) -> List[Pytree]:
        """Per chunk ``c`` of this stage, ``[1, ...]`` leaves viewing
        ``blocks[:, c]`` (no copy) that collect that chunk's gradients;
        :meth:`_chunk_grads` stacks them back."""
        return [_tree_map(lambda a: a[:, c].detach().requires_grad_(a.requires_grad), blocks)
                for c in range(self.virtual_stages)]

    @staticmethod
    def _chunk_grads(blocks: Pytree, chunks: List[Pytree]) -> None:
        for path, a in _items(blocks):
            if a.requires_grad:
                parts = [_get(ch, path) for ch in chunks]
                a.grad = torch.stack([torch.zeros_like(t) if t.grad is None else t.grad
                                      for t in parts], 1)

    def _hand(self, t: torch.Tensor, stage: int, kind: int, c: int, i: int) -> None:
        """Send ``t`` to ``stage`` of this dp lane, tagged by kind, chunk
        and micro-batch; to this rank's own stage (n=1) it stays here."""
        tag = kind * _TAG + c * self.chunks + i
        if stage == self._stage:
            self._loopback[tag] = t.detach()
        else:
            self.mesh.send(t, self.mesh.rank_of(stage, self._lane), tag)

    def _take(self, stage: int, kind: int, c: int, i: int) -> torch.Tensor:
        """What :meth:`_hand` sent this rank from ``stage`` under that tag."""
        tag = kind * _TAG + c * self.chunks + i
        if stage == self._stage:
            return self._loopback.pop(tag)
        return self.mesh.recv(self.mesh.rank_of(stage, self._lane), tag)

    def _interleaved(self, leaves, x_mb, tgt_mb, mask_mb, mean_scale, stop):
        """This rank's column of :func:`~torchgpipe_tpu_torch.parallel.interleaved.interleaved_tables`,
        tick by tick.  Chunk ``c``'s output on the last stage goes to
        chunk ``c+1`` on stage 0, its gradient the other way; the loss
        seeds at the last stage's last chunk, ``pre`` runs at stage 0's
        chunk 0."""
        from torchgpipe_tpu_torch.parallel.interleaved import BWD, FWD, interleaved_tables

        n, v, j = self.n_stages, self.virtual_stages, self._stage
        tb = interleaved_tables(n, self.chunks, v)
        chunks = self._chunk_trees(leaves["blocks"])
        cells: Dict[Tuple[int, int], _Cell] = {}
        outs: Dict[int, torch.Tensor] = {}
        loss = torch.zeros((), device=self.mesh.device)
        for t in range(tb.ticks):
            k, c, i = int(tb.kind[t, j]), int(tb.chunk[t, j]), int(tb.mb[t, j])
            if k == FWD:
                h = (self._stage_input(leaves, x_mb, i) if j == 0 and c == 0
                     else self._take(j - 1 if j else n - 1, _ACT, c, i))
                need = torch.is_floating_point(h) and (j > 0 or c > 0 or self.pre is not None)
                y, cells[c, i] = self._cell_forward(chunks[c], h, i < stop, need, i, c * n + j)
                if j < n - 1:
                    self._hand(y, j + 1, _ACT, c, i)
                elif c < v - 1:
                    self._hand(y, 0, _ACT, c + 1, i)
                else:
                    outs[i] = y
            elif k == BWD:
                if j == n - 1 and c == v - 1:
                    l_i, gy = self._last_cell_loss(leaves, outs.pop(i), tgt_mb, mask_mb,
                                                   mean_scale, i)
                    loss = loss + l_i
                else:
                    gy = self._take(j + 1 if j < n - 1 else 0, _GRAD, c, i)
                cell = cells.pop((c, i))
                g = self._cell_backward(chunks[c], cell, gy)
                if g is None:
                    continue
                if j > 0:
                    self._hand(g, j - 1, _GRAD, c, i)
                elif c > 0:
                    self._hand(g, n - 1, _GRAD, c - 1, i)
                elif cell.h.requires_grad:   # stage 0, chunk 0: into pre's parameters
                    torch.autograd.backward(cell.h, g)
        self._chunk_grads(leaves["blocks"], chunks)
        return loss

    def _zero_bubble(self, leaves, x_mb, tgt_mb, mask_mb, mean_scale, stop):
        """This rank's column of :func:`~torchgpipe_tpu_torch.parallel.zerobubble.zero_bubble_tables`.
        A B cell computes only its input's gradient
        (``torch.autograd.grad``, the graph retained) and sends it
        upstream at once; the W cell after it computes the block's (and,
        on stage 0, ``pre``'s) weight gradients from the same graph.
        ``'never'`` keeps the forward's graph from F to W; ``'always'``
        recomputes once, in B, and W uses B's graph."""
        from torchgpipe_tpu_torch.parallel.zerobubble import B, F, W, zero_bubble_tables

        n, j, mesh = self.n_stages, self._stage, self.mesh
        tb = zero_bubble_tables(n, self.chunks)
        blocks = leaves["blocks"]
        weights = [a for a in _leaves(blocks) if a.requires_grad]
        cells: Dict[int, _Cell] = {}
        outs: Dict[int, torch.Tensor] = {}
        loss = torch.zeros((), device=mesh.device)
        for t in range(tb.ticks):
            k, i = int(tb.kind[t, j]), int(tb.mb[t, j])
            if k == F:
                h = self._stage_input(leaves, x_mb, i)
                y, cells[i] = self._cell_forward(blocks, h, self.checkpoint == "always",
                                                 self._need_input_grad(h), i)
                if j < n - 1:
                    mesh.send(y, mesh.rank_of(j + 1, self._lane), _ACT * _TAG + i)
                else:
                    outs[i] = y
            elif k == B:
                if j == n - 1:
                    l_i, gy = self._last_cell_loss(leaves, outs.pop(i), tgt_mb, mask_mb,
                                                   mean_scale, i)
                    loss = loss + l_i
                else:
                    gy = mesh.recv(mesh.rank_of(j + 1, self._lane), _GRAD * _TAG + i)
                cell = cells[i]
                self._where = (j, i, self._block_name())
                if cell.ckpt:
                    cell.y = self._recompute(blocks, cell)
                cell.gy = gy
                if cell.x.requires_grad:
                    cell.g, = torch.autograd.grad(cell.y, cell.x, gy, retain_graph=True)
                    if j > 0:
                        mesh.send(cell.g, mesh.rank_of(j - 1, self._lane), _GRAD * _TAG + i)
            elif k == W:
                cell = cells.pop(i)
                self._where = (j, i, self._block_name())
                torch.autograd.backward(cell.y, cell.gy, inputs=weights)
                if j == 0 and cell.g is not None and cell.h.requires_grad:
                    torch.autograd.backward(cell.h, cell.g)   # pre's parameters
        return loss

    def train_step(self, params: dict, x: Pytree, target: Pytree,
                   rng: Optional[Any] = None) -> Tuple[torch.Tensor, dict]:
        """One pipelined forward+backward on this rank; returns ``(loss,
        grads)``: the global loss (float32, on every rank) and this rank's
        gradient tree (the layout of :meth:`place`'s: this stage's
        ``[1, ...]`` block slice, under fsdp this lane's dp shard of it,
        reduce-scattered, an expert leaf this ep lane's experts; the
        pre/post/loss trees summed over pp; every leaf averaged over dp
        and over ep, where the batch is split).

        ``x``/``target`` are the full mini-batch ``[B, ...]`` on every
        rank (each takes its dp x ep lane's rows).  A ragged ``B`` (not
        divisible by chunks·dp·ep) is accepted whenever the loss is
        row-decomposable: the batch is edge-padded and a mask weights the
        padding out of the loss and every gradient exactly.  ``params``
        is not changed.

        ``rng`` (an int seed or a 1-element integer tensor: a key of
        ``torchgpipe_tpu_torch.rng``) keys every layer of every cell: the
        block layer ``l`` of micro-batch ``i`` draws from ``fold_in(
        fold_in(rng, i), l)``, ``l`` its index in the whole model (``pre``
        0, then every stage's block layers, then ``post``), so a cell's
        recompute draws the same masks and every schedule the same loss.
        An exception raised in a cell keeps its type and gains a note
        naming the stage and micro-batch."""
        self._check_params(params)
        self._fault_check(for_train=True)
        pad = self._check_batch(x, target, ragged_ok=self.loss_reduction is not None)
        if pad and not self._warned_ragged_coupled:
            self._warned_ragged_coupled = True
            coupled = list(dict.fromkeys(
                c for lyr in (self.block, self.pre, self.post) if lyr is not None
                for c in _row_coupled(lyr)))
            if coupled:
                import warnings

                warnings.warn(
                    "ragged batch padded with duplicated edge rows, and the "
                    f"model has row-coupled auxiliary terms ({', '.join(coupled)}) "
                    "that will see those padding rows; task-loss gradients "
                    "remain exact, but pad to a divisible batch yourself if "
                    "the auxiliary terms must be padding-free (see "
                    "SpmdGPipe.train_step docstring)",
                    stacklevel=2,
                )
        mask_mb = mean_scale = None
        if pad:
            b_real = microbatch.batch_size(x)
            mask = torch.cat([torch.ones(b_real), torch.zeros(pad)])
            x, target = _pad_batch(x, pad), _pad_batch(target, pad)
            mask_mb = self._local_microbatches(mask, seq=False)
            if self.loss_reduction == "mean":
                mean_scale = self._mask_mean_scale(torch.cat(mask_mb))
        x_mb = self._local_microbatches(x)
        tgt_mb = self._local_microbatches(target)
        stop = _ckpt.checkpoint_stop(self.checkpoint, self.chunks, train=True)
        policy_offload = self.checkpoint == "offload" and self.remat_policy is not None
        if policy_offload:
            # The reference's 'offload' with an explicit policy: every cell
            # checkpointed, the policy naming what its forward keeps.
            stop = self.chunks
        leaves = self._leaf_copy(params)
        # Under fsdp every schedule runs on the full block tensors,
        # all-gathered over dp once a step.
        cells = dict(leaves, blocks=self._gather_fsdp(leaves["blocks"])) if self.fsdp \
            else leaves
        run = {"1f1b": self._one_f_one_b, "interleaved": self._interleaved,
               "zb": self._zero_bubble}.get(self.schedule, self._fill_drain)
        self._key = None if rng is None else _rng.Key(_rng.key_tensor(rng))
        self._offload = _ckpt.Offload() \
            if self.checkpoint == "offload" and not policy_offload else None
        self._remat = None if self.remat_policy is None else _ckpt.Remat(self.remat_policy)
        try:
            with self._bound(), self._annotate_cell_failure():
                loss = run(cells, x_mb, tgt_mb, mask_mb, mean_scale, stop)
        finally:
            self.mesh.flush()
            self._key = None
            if self._offload is not None:
                self.offload_stats = {"saved_bytes": self._offload.saved_bytes,
                                      "moved_bytes": self._offload.moved_bytes}
                self._offload = None
            if self._remat is not None:
                self.remat_stats = {"saved_bytes": self._remat.saved_bytes}
                self._remat = None
        return self._reduce(loss, leaves, cells["blocks"])

    def _fault_check(self, *, for_train: bool = False) -> None:
        """Refuse a ``faults.inject(nan_at=)`` plan the requested program
        has no hook for, as the reference does: the fill-drain training
        step and the non-interleaved forward poison their cells' inputs
        (``faults.spmd_corrupt_cell_input``); a chaos run that injected
        nothing would certify recovery code that never ran.  (The port
        runs its cells eagerly, so it keeps no programs to key by
        ``faults.plan_token()``.)"""
        plan = _faults.active_plan()
        bad_schedule = (self.schedule != "fill_drain" if for_train
                        else self.schedule == "interleaved")
        if plan is not None and plan.nan_at is not None and bad_schedule:
            raise NotImplementedError(
                "faults.inject(nan_at=...) is supported by the SPMD "
                "fill_drain training step and the non-interleaved "
                "apply/eval programs only (got "
                f"schedule={self.schedule!r}); these are the paths with a "
                "per-cell injection hook"
            )

    @contextlib.contextmanager
    def _annotate_cell_failure(self) -> Iterator[None]:
        """Give an exception raised in a cell the MPMD engine's (stage,
        micro-batch) note, its type kept.  The cells run eagerly here, so
        the failing cell is the one that ran (:attr:`_where`), not the
        reference's abstract re-evaluation's guess."""
        self._where = None
        try:
            yield
        except Exception as e:  # noqa: BLE001 — annotate and re-raise as is
            notes = getattr(e, "__notes__", None) or []
            if self._where is not None and not any("pipeline stage" in n for n in notes):
                stage, mb, what = self._where
                e.add_note(f"raised in pipeline stage {stage}, micro-batch {mb} ({what}; "
                           f"SPMD {self.schedule} schedule, rank {self.mesh.rank})")
            raise

    def _bound(self) -> Any:
        """The context binding this engine's ep, tp and sp axes for the
        layers it runs (:func:`~torchgpipe_tpu_torch.parallel.axes.axis_bound`);
        their host staging counts under ``'ep'``, ``'tp'`` and ``'sp'``."""
        return bind_axes(self.mesh, [self.ep_axis, self.tp_axis, self.sp_axis],
                         ["ep", "tp", "sp"])

    def _reduction(self) -> Tuple[Tuple[str, ...], Tuple[str, ...], float]:
        """``(axes of the loss and the pre/post/loss gradients, axes of the
        block gradients, scale)``: summed over pp, averaged over dp, and
        over ep and sp averaged (``loss_reduction='mean'``) or summed
        (``'sum'``), the reference's psum / pmean.  Never over tp: a
        vocab-sharded table's gradients differ from lane to lane, and a
        tp-replicated leaf's are already equal on every lane.  An expert
        leaf (sharded over ep) leaves ep out of its axes
        (:meth:`_leaf_axes`) and keeps the scale."""
        sp = tuple(a for a in (self.ep_axis, self.sp_axis) if a)
        blocks = tuple(a for a in (self.dp_axis,) if a) + sp
        scale = 1.0 / self._dp
        if self.loss_reduction == "mean":
            scale /= self._sp * self._ep
        return (self.pp_axis,) + blocks, blocks, scale

    def _leaf_axes(self, axes: Tuple[str, ...], spec: P) -> Tuple[str, ...]:
        """The reduction axes of a gradient leaf under ``spec``: the ep
        axis left out for a leaf sharded over it (the reference's
        ``_reduce_ep``: its lane-local gradient already sums every lane's
        tokens, the all-to-all's backward routed them home)."""
        if self.ep_axis and spec_mentions(spec, self.ep_axis):
            return tuple(a for a in axes if a != self.ep_axis)
        return axes

    def _reduce(self, loss: torch.Tensor, leaves: dict,
                blocks: Pytree) -> Tuple[torch.Tensor, dict]:
        """The loss and every gradient reduced as :meth:`_reduction` says,
        each pre/post/loss leaf in one reduction over its pp x dp x ep x
        sp group; under fsdp each gathered block tensor's gradient (of
        ``blocks``) reduce-scattered back to this lane's shard."""
        mesh = self.mesh
        every, block_axes, scale = self._reduction()
        loss = mesh.all_reduce(loss.float(), every, scale, kind="loss")
        grads = {}
        for key, _ in self._layers():
            if key == "blocks" and self.fsdp:
                grads[key] = _tree_map(self._reduce_fsdp, blocks, self._fsdp_dims)
                continue
            g = _tree_map(lambda a: torch.zeros_like(a) if a.grad is None else a.grad,
                          leaves[key])
            axes = block_axes if key == "blocks" else every
            grads[key] = _tree_map(
                lambda t, spec: mesh.all_reduce(t, self._leaf_axes(axes, spec), scale), g,
                broadcast_specs(self._specs[key], g))
        return loss, grads

    def _reduce_fsdp(self, a: torch.Tensor, dim: int) -> torch.Tensor:
        """A gathered block tensor's gradient as this lane's shard: summed
        over dp and cut on ``dim`` (reduce-scatter, staged under
        ``'fsdp'``), divided by dp; a replicated leaf (``dim`` -1) reduced
        as every other block gradient."""
        _, axes, scale = self._reduction()
        g = torch.zeros_like(a) if a.grad is None else a.grad
        if dim < 0:
            return self.mesh.all_reduce(g, axes, scale)
        sp = tuple(x for x in axes if x != self.dp_axis)
        g = self.mesh.reduce_scatter(g, self.dp_axis, dim, 1.0 if sp else scale)
        return self.mesh.all_reduce(g, sp, scale) if sp else g

    # ------------------------------------------------------------------ #
    # training with an optimizer                                         #
    # ------------------------------------------------------------------ #

    # ZeRO-style sharded optimizer update (optimizer state over dp) ----- #

    def _zero_level(self, zero: Any = None) -> int:
        """Normalize a ``zero=`` argument to a ZeRO LEVEL (0, 1 or 3).

        ``None`` reads the pipe's declared :attr:`zero_update`; a bool
        maps ``False -> 0`` and ``True`` to the natural level for the
        layout (3 under fsdp, else 1).  Levels and layouts must agree:
        ZeRO-1's segment math needs dp-REPLICATED params, and ZeRO-3 IS
        the fsdp storage layout's update, so ``zero=1`` under fsdp and
        ``zero=3`` without fsdp are both refused (there is no ZeRO-2:
        gradients already leave the fsdp step reduce-scattered)."""
        if zero is None:
            zero = self.zero_update
        if isinstance(zero, bool):
            level = ((3 if self.fsdp else 1) if zero else 0)
        elif isinstance(zero, int):
            level = zero
        else:
            raise ValueError(
                f"zero must be a bool or a ZeRO level int, got {zero!r}"
            )
        if level not in (0, 1, 3):
            raise ValueError(
                f"zero={level} is not a supported ZeRO level: use 0/False "
                "(replicated update), 1/True (optimizer state sharded "
                "over dp), or 3 (fully-sharded params+grads+state, "
                "requires fsdp=True).  Level 2 does not exist here: "
                "gradients already leave the fsdp step reduce-scattered, "
                "and without fsdp the grad tree is transient inside the "
                "fused step program"
            )
        if level == 1 and self.fsdp:
            raise ValueError(
                "zero=1 under fsdp is incoherent: the ZeRO-1 segment math "
                "assumes dp-REPLICATED params, but fsdp stores them "
                "sharded over dp (their optimizer state is already "
                "dp-partitioned alongside).  Use zero=3 (or zero=True, "
                "which resolves to 3 under fsdp)"
            )
        if level == 3 and not self.fsdp:
            raise ValueError(
                "zero=3 IS the fully-sharded (gather-at-use) layout's "
                "update: params, grads and optimizer state all live "
                "sharded over dp.  Construct the pipe with fsdp=True to "
                "get that storage layout (zero=1 shards optimizer state "
                "only and works with replicated params)"
            )
        return level

    def _zero_check(self, level: int = 1) -> None:
        if level == 0:
            return
        if self.dp_axis is None or self.mesh.shape[self.dp_axis] < 2:
            raise ValueError(
                "the ZeRO-sharded optimizer update partitions state over "
                "the data-parallel lanes: it needs dp_axis set and a dp "
                "mesh axis of size >= 2 (arXiv:2004.13336 — with one "
                "replica there is nothing to shard; use zero=False)"
            )

    def _flat(self, tree: dict) -> List[torch.Tensor]:
        """This rank's leaves of a params (or grads) tree, in the engine's
        order (pre, blocks, post, loss)."""
        return [a for key, _ in self._layers() for a in _leaves(tree[key])]

    def _zero_machinery(self, optimizer: Callable[..., torch.optim.Optimizer], params: dict
                        ) -> Tuple[torch.optim.Optimizer, List[torch.Tensor]]:
        """ZeRO-1's optimizer and its tensors: each of this rank's leaves
        flattened, padded to a multiple of dp, and this dp lane's segment
        of it copied out (:meth:`_zero_segment`); ``optimizer`` over the
        segments, so each lane holds 1/dp of every mirrored state leaf.
        A segment is rank-local, so no layout axis enters its shape (the
        reference's ``_zero_axes`` dims); the layout's specs
        (``meta['param_specs']``) must leave every leaf dp-replicated."""
        for key, _ in self._layers():
            specs = broadcast_specs(self._specs[key], params[key])
            for (path, _), (_, spec) in zip(_items(params[key]), _items(specs)):
                for e in spec:
                    axes_ = e if isinstance(e, tuple) else (e,)
                    if e is not None and self.dp_axis in axes_:
                        leaf = "/".join(map(str, (key,) + path))
                        raise ValueError(
                            f"zero=True needs dp-replicated parameters, but "
                            f"the layout shards leaf {leaf!r} over the dp "
                            f"axis ({spec}) — its optimizer state is already "
                            "dp-partitioned alongside the param; use "
                            "zero=False (or fsdp) for this layout"
                        )
        segments = [self._zero_segment(a) for a in self._flat(params)]
        return optimizer(segments), segments

    def _zero_segment(self, a: torch.Tensor) -> torch.Tensor:
        """This dp lane's segment of ``a`` flattened and zero-padded to a
        multiple of dp (a copy)."""
        flat = a.detach().reshape(-1)
        seg = -(-flat.numel() // self._dp)   # ceil: the dp padding
        if seg * self._dp > flat.numel():
            flat = torch.cat([flat, flat.new_zeros(seg * self._dp - flat.numel())])
        return flat[self._lane * seg:(self._lane + 1) * seg].clone()

    @staticmethod
    def _zero_state_check(opt: torch.optim.Optimizer) -> None:
        for p in opt.zero_segments:
            for leaf in opt.state.get(p, {}).values():
                if isinstance(leaf, torch.Tensor) and leaf.ndim and leaf.shape != p.shape:
                    raise ValueError(
                        "the ZeRO-sharded update supports optimizers whose "
                        "state mirrors the params leaf-for-leaf plus scalar "
                        "counters (adam/adamw/sgd-momentum shape); this "
                        f"optimizer's state has a leaf of shape {tuple(leaf.shape)} "
                        "that matches neither — use zero=False for it"
                    )

    def zero_opt_state(self, optimizer: Callable[..., torch.optim.Optimizer],
                       params: dict, zero: Any = None) -> torch.optim.Optimizer:
        """The ``torch.optim`` optimizer (``optimizer``: a factory taking
        an iterable of tensors) that holds this rank's share of the state
        at ZeRO ``zero`` (None: True, the pipe's natural level): level 0
        over this rank's leaves of ``params``; level 1 over this dp lane's
        1/dp segment of each (:meth:`_zero_machinery`), the updated
        segments all-gathered back into the leaves by
        :meth:`make_train_step`; level 3 over the fsdp storage shards
        (1/dp of each chosen block leaf), which is the plain update of the
        storage layout.  Each level is bitwise-equal to the unsharded
        update for elementwise optimizers (SGD, Adam, AdamW)."""
        level = self._zero_level(True if zero is None else zero)
        self._zero_check(level)
        if level == 1:
            opt, segments = self._zero_machinery(optimizer, params)
        else:
            segments = self._flat(params)
            opt = optimizer(segments)
        opt.zero_level, opt.zero_params, opt.zero_segments = level, self._flat(params), segments
        return opt

    def _zero_apply(self, opt: torch.optim.Optimizer, grads: List[torch.Tensor]) -> None:
        """One update of ``opt`` (:meth:`zero_opt_state`'s) from this
        rank's gradients, the parameters changed in place."""
        if opt.zero_level == 1:
            for s, g in zip(opt.zero_segments, grads):
                s.grad = self._zero_segment(g)
        else:
            for t, g in zip(opt.zero_segments, grads):
                t.grad = g
        opt.step()
        for t in opt.zero_segments:
            t.grad = None
        if opt.zero_level == 1:
            self._zero_state_check(opt)
            with torch.no_grad():
                for t, s in zip(opt.zero_params, opt.zero_segments):
                    full = torch.cat(self.mesh.all_gather(s, self.dp_axis, kind="zero"))
                    t.copy_(full[:t.numel()].view(t.shape))

    def make_train_step(self, optimizer: Callable[..., torch.optim.Optimizer], *,
                        donate: bool = True, megastep: Optional[int] = None,
                        zero: Any = None) -> Callable[..., Any]:
        """``step(params, x, target, rng=None) -> loss``: :meth:`train_step`,
        then one ``torch.optim`` update of this rank's leaves of ``params``
        (``optimizer`` is a factory taking an iterable of tensors, e.g.
        ``functools.partial(torch.optim.SGD, lr=0.1)``), in place as the
        port's ``GPipe.make_train_step`` does.  The optimizer is built at
        the first call by :meth:`zero_opt_state` at ZeRO level ``zero``
        (None: the pipe's ``zero_update``), over that call's ``params``
        tensors (``step.optimizer``); later calls must pass the same tree.
        ``donate`` changes nothing here (the update is in place).

        ``megastep=K`` (default: the pipe's ``megastep``) above 1 runs K
        steps a call: ``step(params, xs, targets, rng=None) -> (loss[K],
        finite[K])`` over ``[K, ...]``-stacked batches, inner step ``k``
        keyed ``fold_in(rng, k)``.  After each inner step the loss and
        every updated parameter and optimizer state tensor are checked on
        every rank (one all-reduce of a flag); a step that is not finite
        anywhere is undone everywhere (``gpipe.StateSnapshot``), bitwise
        what :class:`~torchgpipe_tpu_torch.resilience.guard.StepGuard`
        around K single steps leaves.  Gloo's collectives cannot be
        captured into a CUDA graph, so the K steps are a host loop in one
        call, not one captured program: the call saves the guard's
        per-step host work, not the per-step launches.

        ``step.snapshot(args)`` is the state a guard protects (this rank's
        parameters, the optimizer's state, ZeRO-1's segments), what
        ``StepGuard`` takes before each step."""
        K = self.megastep if megastep is None else int(megastep)
        if K < 1:
            raise ValueError(f"megastep must be >= 1, got {K}")
        level = self._zero_level(zero)
        self._zero_check(level)

        def prepare(params: dict) -> None:
            tensors = self._flat(params)
            if step.optimizer is None:
                step.tensors = tensors
                step.optimizer = self.zero_opt_state(optimizer, params, zero=level)
                step.optimizers.append(step.optimizer)
            elif len(tensors) != len(step.tensors) or any(
                    a is not b for a, b in zip(tensors, step.tensors)):
                raise ValueError(
                    "this step's optimizer was built over another params tree; "
                    "pass the tree of the first call (updated in place)")

        def one(params: dict, x: Pytree, target: Pytree, rng: Optional[Any]) -> torch.Tensor:
            prepare(params)
            loss, grads = self.train_step(params, x, target, rng)
            self._zero_apply(step.optimizer, self._flat(grads))
            return loss

        def snapshot(args: Tuple, extra: Sequence[torch.Tensor] = ()) -> Any:
            from torchgpipe_tpu_torch.gpipe import StateSnapshot

            prepare(args[0])
            opt = step.optimizer
            seg = list(opt.zero_segments) if opt.zero_level == 1 else []
            return StateSnapshot(nn.Module(), step.optimizers,
                                 self._flat(args[0]) + seg + list(extra))

        if K == 1:
            def step(params: dict, x: Pytree, target: Pytree,
                     rng: Optional[Any] = None) -> torch.Tensor:
                return one(params, x, target, rng)
        else:
            def step(params: dict, xs: Pytree, targets: Pytree,
                     rng: Optional[Any] = None) -> Tuple[torch.Tensor, torch.Tensor]:
                for leaf in _leaves(xs):
                    if leaf.shape[:1] != (K,):
                        raise ValueError(
                            f"megastep={K} consumes [K, ...]-stacked batches "
                            f"(K steps in one call), got a leading dim of "
                            f"{leaf.shape[0]} — stack K per-step batches with "
                            "torch.stack, or pass megastep=1")
                    break
                from torchgpipe_tpu_torch.resilience.guard import _all_finite

                key = None if rng is None else _rng.key_tensor(rng)
                snap = snapshot((params,))
                losses, oks = [], []
                for k in range(K):
                    x, y = _tree_map(lambda a: a[k], (xs, targets))
                    snap.take()
                    loss = one(params, x, y, None if key is None else _rng.fold_in(key, k))
                    ok = _all_finite([loss, *snap.tensors()]).to(self.mesh.device)
                    # Skipped everywhere if not finite anywhere.
                    bad = self.mesh.all_reduce((~ok).float(), None, op="max", kind="loss")
                    ok = bad.to(ok.device) == 0
                    snap.select(ok, eager=True)
                    losses.append(loss)
                    oks.append(ok)
                return torch.stack(losses), torch.stack(oks)

        step.optimizer = None
        step.optimizers = []
        step.tensors = []
        step.prepare = prepare   # builds step.optimizer over a params tree
        step.pipe = self
        step.megastep = K
        step.snapshot = snapshot
        return step

    # ------------------------------------------------------------------ #
    # inference                                                          #
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _forward_outputs(self, params: dict, x_mb: List[Pytree]) -> Optional[List[Any]]:
        """The no-grad forward (fill-drain, or the interleaved forward
        tables over the n*v virtual stages); the last stage's micro-batch
        outputs (None elsewhere)."""
        n, j, mesh = self.n_stages, self._stage, self.mesh
        blocks = self._gather_fsdp(params["blocks"]) if self.fsdp else params["blocks"]
        if self.virtual_stages > 1:
            outs = self._forward_interleaved(params, blocks, x_mb)
            mesh.flush()
            return outs
        outs = []
        for i in range(self.chunks):
            if j > 0:
                h = mesh.recv(mesh.rank_of(j - 1, self._lane), _ACT * _TAG + i)
            elif self.pre is not None:
                self._where = (0, i, self._block_name(self.pre, "pre layer"))
                h = self._run_pre(params, x_mb[i], False)
            else:
                h = x_mb[i]
            self._where = (j, i, self._block_name())
            y = self._run_block(blocks, _faults.spmd_corrupt_cell_input(j, i, h))
            if j < n - 1:
                mesh.send(y, mesh.rank_of(j + 1, self._lane), _ACT * _TAG + i)
            else:
                outs.append(y)
        mesh.flush()
        return outs if j == n - 1 else None

    def _forward_interleaved(self, params: dict, blocks: Pytree,
                             x_mb: List[Pytree]) -> Optional[List[Any]]:
        """This rank's forward cells of :func:`~torchgpipe_tpu_torch.parallel.interleaved.interleaved_forward_tables`."""
        from torchgpipe_tpu_torch.parallel.interleaved import FWD, interleaved_forward_tables

        n, v, j = self.n_stages, self.virtual_stages, self._stage
        tb = interleaved_forward_tables(n, self.chunks, v)
        outs: Dict[int, torch.Tensor] = {}
        for t in range(tb.ticks):
            if int(tb.kind[t, j]) != FWD:
                continue
            c, i = int(tb.chunk[t, j]), int(tb.mb[t, j])
            if j == 0 and c == 0:
                h = self._run_pre(params, x_mb[i], False) if self.pre is not None else x_mb[i]
            else:
                h = self._take(j - 1 if j else n - 1, _ACT, c, i)
            y = self._run_block(_tree_map(lambda a: a[:, c], blocks), h)
            if j < n - 1:
                self._hand(y, j + 1, _ACT, c, i)
            elif c < v - 1:
                self._hand(y, 0, _ACT, c + 1, i)
            else:
                outs[i] = y
        return [outs[i] for i in range(self.chunks)] if j == n - 1 else None

    @torch.no_grad()
    def apply(self, params: dict, x: Pytree) -> torch.Tensor:
        """Pipelined inference forward; the gathered outputs ``[B, ...]``
        (``post`` applied) on every rank: a head that keeps its logits
        vocab-sharded (``meta['out_gather']``) gathered over tp, the
        sequence over sp.  Ragged batches are edge-padded through the
        pipeline and the padding rows sliced off."""
        self._check_params(params)
        self._fault_check()
        pad = self._check_batch(x, ragged_ok=True)
        b_real = microbatch.batch_size(x)
        out = None
        with self._bound(), self._annotate_cell_failure():
            outs = self._forward_outputs(params, self._local_microbatches(_pad_batch(x, pad)))
            if outs is not None:
                out = torch.stack([self._run_post(params, y) if self.post is not None else y
                                   for y in outs])                     # [m, b, ...]
                for axis, dim in (_declared_axes(self.post, "out_gather")
                                  if self.post is not None else []):
                    out = axis_bound(axis).all_gather(out, dim % out.ndim)
        last = self.mesh.rank_of(self.n_stages - 1, self._lane)
        out = self.mesh.broadcast(out, last, self.pp_axis)
        if self._sp > 1:
            out = torch.cat(self.mesh.all_gather(out, self.sp_axis, kind="sp"), 2)
        # The row lanes d*ep + e: ep's within each dp lane's.
        for axis, size in ((self.ep_axis, self._ep), (self.dp_axis, self._dp)):
            if axis and size > 1:
                out = torch.cat(self.mesh.all_gather(out, axis), 1)   # lanes x [m, b, ...]
        out = out.reshape(-1, *out.shape[2:])
        return out[:b_real] if pad else out

    @torch.no_grad()
    def eval_loss(self, params: dict, x: Pytree, target: Pytree) -> torch.Tensor:
        """Loss on a mini-batch without gradients: per micro-batch on the
        last stage (a decomposable loss), summed over pp, averaged over
        dp, ep and sp.  ``loss_reduction=None`` and ragged batches compute
        the loss on :meth:`apply`'s gathered outputs instead."""
        self._check_params(params)
        self._fault_check()
        pad = self._check_batch(x, target, ragged_ok=True)
        if self.loss_reduction is None or pad:
            out = self.apply(params, x)
            return self._loss_call(params, out, target.to(out.device)
                                   if isinstance(target, torch.Tensor) else target).float()
        tgt_mb = self._local_microbatches(target)
        loss = torch.zeros((), device=self.mesh.device)
        with self._bound(), self._annotate_cell_failure():
            outs = self._forward_outputs(params, self._local_microbatches(x))
            if outs is not None:
                for y, t in zip(outs, tgt_mb):
                    if self.post is not None:
                        y = self._run_post(params, y)
                    l_i = self._loss_call(params, y, t).float()
                    loss = loss + (l_i / self.chunks if self.loss_reduction == "mean" else l_i)
        every, _, _ = self._reduction()
        mean = self.loss_reduction == "mean"
        return self.mesh.all_reduce(loss, every,
                                    1.0 / (self._rows * self._sp) if mean else 1.0,
                                    kind="loss")
