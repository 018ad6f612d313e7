"""Model persistence: flat named state dicts and ``.npz`` files.

Counterpart of ``torchgpipe_tpu/utils/serialization.py`` with the
reference's key names: ``partitions.<stage>.<layer name>.params<path>``
and ``...state<path>``, where ``<path>`` is the leaf's path in the
reference's parameter (or state) tree of that layer, spelled as
``jax.tree_util.keystr`` spells it (``['w']``, ``[0]['scale']``).  A
port layer maps onto that tree as ``convert`` loads it: a transformer
layer's ``params()`` dict, a convolution's kernel as HWIO, BatchNorm's
``scale``/``bias`` as params and its buffers as state, a ``Structured``
layer's children by name, an ``nn.Sequential`` as a tuple.  So a file
the port writes loads into the reference model and back.

Leaves are numpy arrays.  numpy has no bfloat16: a bf16 tensor is
stored as its ``uint16`` bit pattern and named in the ``__dtypes__``
entry (a JSON object ``{key: "bfloat16"}``), so it round-trips bitwise;
a reference file's bf16 leaves (numpy's two-byte void) load the same way.

:func:`save` writes atomically (temp file, fsync, rename).

Sharded checkpoints (:func:`save_sharded`, :func:`restore_sharded`; the
SPMD engine's, where the reference uses orbax) are one ``.npz`` a rank,
``rank_<r>.npz``, in the same format (``__dtypes__`` for bf16), holding
the rank's pieces of a tree whose leaves are :class:`Shard` leaves (a piece
of a global array: its global shape and where the piece starts) or
whole arrays (replicated: rank 0 writes them).  Beside the arrays the
file's ``__index__`` entry records each piece's global shape and start.
A restore reads, for each leaf of its template, the slice the template
asks for from whichever ranks' files hold it, so a tree saved on one
mesh restores on another of the same global shapes (fewer dp lanes, or
one process holding the gathered tree).  ``SpmdGPipe.train_state``
gives a rank's params and optimizer state in this form.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

DTYPES_KEY = "__dtypes__"
INDEX_KEY = "__index__"
_RANK_FILE = "rank_{:05d}.npz"

Leaf = Tuple[str, torch.Tensor, Any]   # (path, tensor, layout: None or a permutation)


def _tree(layer: nn.Module, kind: str, path: str = "") -> Iterator[Leaf]:
    """``(path, tensor, permutation)`` of each leaf of ``layer``'s
    reference tree of ``kind`` (``'params'`` or ``'state'``); the
    permutation takes the port's tensor to the reference's layout."""
    from torchgpipe_tpu_torch.models.amoebanet import Structured
    from torchgpipe_tpu_torch.models.resnet import Residual
    from torchgpipe_tpu_torch.models.transformer import _Layer
    from torchgpipe_tpu_torch.ops.nn import BatchNorm, Conv2d, Dense, LayerNorm
    from torchgpipe_tpu_torch.precision import unwrap

    layer = unwrap(layer)

    def nested(d: Dict[str, Any], at: str) -> Iterator[Leaf]:
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                yield from nested(v, f"{at}[{k!r}]")
            else:
                yield f"{at}[{k!r}]", v, None

    if isinstance(layer, _Layer):
        if kind == "params":
            yield from nested(layer.params(), path)
        return
    if isinstance(layer, (Conv2d, Dense)):
        if kind == "params":
            if layer.b is not None:
                yield f"{path}['b']", layer.b, None
            yield f"{path}['w']", layer.w, (2, 3, 1, 0) if isinstance(layer, Conv2d) else None
        return
    if isinstance(layer, (BatchNorm, LayerNorm)):
        if kind == "params":
            yield from nested({"bias": layer.bias, "scale": layer.scale}, path)
        else:
            yield from nested(dict(layer.named_buffers()), path)
        return
    if isinstance(layer, Structured):
        for name in sorted(layer.parts):
            yield from _tree(layer.parts[name], kind, f"{path}[{name!r}]")
        return
    if isinstance(layer, Residual) and layer.down is not None:
        yield from _tree(layer.down, kind, path)
        return
    if isinstance(layer, nn.Sequential):
        for i, child in enumerate(layer):
            yield from _tree(child, kind, f"{path}[{i}]")
        return
    if list(layer.parameters()) or list(layer.buffers()):
        raise TypeError(
            f"{type(layer).__name__} has parameters or buffers but no "
            "reference tree layout; serialization covers the model zoo's layers"
        )


def _stages(model: Any) -> List[Tuple[int, nn.Module]]:
    """``(stage index, stage)`` of a ``GPipe`` (every stage) or of a
    ``DistributedGPipe`` (its own)."""
    if hasattr(model, "partitions"):
        return list(enumerate(model.partitions))
    return [(model.rank, model.stage)]


def _leaves(model: Any) -> Iterator[Tuple[str, torch.Tensor, Any]]:
    from torchgpipe_tpu_torch.skip import layer_name

    for j, stage in _stages(model):
        for layer in stage:
            base = f"partitions.{j}.{layer_name(layer)}"
            for kind in ("params", "state"):
                for path, t, perm in _tree(layer, kind):
                    yield f"{base}.{kind}{path}", t, perm


def state_dict(model: Any) -> Dict[str, np.ndarray]:
    """The flat named mapping of a port ``GPipe`` (or of one
    ``DistributedGPipe`` rank's stage), numpy leaves in the reference's
    layout, with the ``__dtypes__`` entry when a leaf is bf16."""
    out: Dict[str, np.ndarray] = {}
    tags: Dict[str, str] = {}
    for key, t, perm in _leaves(model):
        if key in out:
            raise ValueError(
                f"duplicate state-dict key {key!r}: layer names must be "
                "unique within a stage or the checkpoint would silently drop "
                "parameters"
            )
        t = t.detach().to("cpu")
        if perm is not None:
            t = t.permute(*perm)
        out[key], tag = _host_array(t)
        if tag:
            tags[key] = tag
    if tags:
        out[DTYPES_KEY] = np.array(json.dumps(tags))
    return out


def _host_array(t: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of a tensor (or array) as numpy, with ``"bfloat16"``
    when its bits are stored as ``uint16``."""
    if not isinstance(t, torch.Tensor):
        return np.array(t, copy=True), None
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    return t.numpy().copy(), None


def _tensor_of(arr: np.ndarray, tag: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if tag == "bfloat16" or arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


@torch.no_grad()
def load_state_dict(model: Any, d: Dict[str, np.ndarray]) -> Any:
    """Copy every identically-keyed array of ``d`` into ``model``'s
    parameters and buffers, in place, in their own dtype.  Strict:
    missing keys, unexpected keys and shape mismatches raise before
    anything is copied.  Returns ``model``."""
    remaining = dict(d)
    tags = json.loads(str(remaining.pop(DTYPES_KEY))) if DTYPES_KEY in remaining else {}
    pairs = []
    for key, t, perm in list(_leaves(model)):
        if key not in remaining:
            raise KeyError(f"state dict is missing {key!r}")
        src = _tensor_of(remaining.pop(key), tags.get(key))
        if perm is not None:
            inverse = [perm.index(i) for i in range(len(perm))]
            src = src.permute(*inverse)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: saved {tuple(src.shape)}, "
                f"model expects {tuple(t.shape)}"
            )
        pairs.append((t, src))
    if remaining:
        raise KeyError(
            f"unexpected keys in state dict: {sorted(remaining)[:5]}"
            + ("..." if len(remaining) > 5 else "")
        )
    for t, src in pairs:
        t.copy_(src.to(t.dtype))
    from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm

    for _, stage in _stages(model):
        for m in stage.modules():
            if isinstance(m, DeferredBatchNorm):
                m._tracked = int(m.tracked)   # its host mirror
    return model


def save(path: str, d: Dict[str, np.ndarray]) -> None:
    """Write a flat state dict to ``path`` (``.npz`` appended when
    missing), atomically: a temp file in the same directory, flushed and
    fsync'd, renamed over ``path``."""
    final = _abs(path)
    if not final.endswith(".npz"):
        final += ".npz"
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **d)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str) -> Dict[str, np.ndarray]:
    """Read a flat state dict written by :func:`save`."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# --------------------------------------------------------------------- #
# Sharded checkpoints (the SPMD engine, one file a rank)                #
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's piece of a global array: ``local`` (a tensor or array)
    holds ``[start[i], start[i] + local.shape[i])`` of each dim of
    ``global_shape``.  ``owner``: whether this rank writes the piece (of
    the ranks holding the same piece, one does).  ``layout`` names a
    piece that only restores into the same layout (a ZeRO-1 segment of a
    rank-local flat leaf: the mesh it was cut on); None for pieces of a
    global array, which restore into any cut of it."""

    local: Any
    global_shape: Tuple[int, ...]
    start: Tuple[int, ...]
    owner: bool = True
    layout: Optional[str] = None


def _dist() -> Tuple[int, int]:
    """``(rank, world size)`` of the ``torch.distributed`` job, ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """A barrier over the ``torch.distributed`` job's default group (none
    in a single process)."""
    import torch.distributed as dist

    if _dist()[1] > 1:
        dist.barrier()


def _from_rank0(value: Any) -> Any:
    """``value`` as rank 0 has it, on every rank (itself in one process)."""
    import torch.distributed as dist

    if _dist()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def write_shards(directory: str, tree: Any) -> Tuple[str, int]:
    """Write this rank's pieces of ``tree`` to ``<directory>/rank_<r>.npz``
    (flushed and fsync'd): each :class:`Shard` it owns, and on rank 0
    every whole leaf.  Returns ``(path, bytes of arrays written)``."""
    from torchgpipe_tpu_torch.resilience.checkpoint import _leaves

    rank, _ = _dist()
    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, Any] = {}
    tags: Dict[str, str] = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, Shard):
            if not leaf.owner:
                continue
            arr, tag = _host_array(leaf.local)
            rec = [list(leaf.global_shape), list(leaf.start), leaf.layout]
        else:
            if rank != 0:
                continue
            arr, tag = _host_array(leaf)
            rec = [list(arr.shape), [0] * arr.ndim, None]
        arrays[key], index[key] = arr, rec
        if tag:
            tags[key] = tag
    path = os.path.join(directory, _RANK_FILE.format(rank))
    with open(path, "wb") as f:
        np.savez(f, **arrays, **{INDEX_KEY: np.array(json.dumps(index)),
                                 DTYPES_KEY: np.array(json.dumps(tags))})
        f.flush()
        os.fsync(f.fileno())
    return path, sum(a.nbytes for a in arrays.values())


class _Pieces:
    """The rank files of a sharded checkpoint, their indexes read up
    front and their arrays read on demand (each at most once)."""

    def __init__(self, directory: str) -> None:
        names = sorted(n for n in os.listdir(directory) if re.fullmatch(r"rank_\d+\.npz", n))
        if not names:
            raise FileNotFoundError(f"no rank files under {directory}")
        self.files = [np.load(os.path.join(directory, n)) for n in names]
        self.index: Dict[str, List[Tuple[int, Any]]] = {}
        self.tags: List[Dict[str, str]] = []
        for i, f in enumerate(self.files):
            for key, rec in json.loads(str(f[INDEX_KEY])).items():
                self.index.setdefault(key, []).append((i, rec))
            self.tags.append(json.loads(str(f[DTYPES_KEY])))

    def close(self) -> None:
        for f in self.files:
            f.close()

    def array(self, i: int, key: str) -> torch.Tensor:
        return _tensor_of(self.files[i][key], self.tags[i].get(key))

    def read(self, key: str, want_global: Tuple[int, ...], start: Tuple[int, ...],
             shape: Tuple[int, ...], layout: Optional[str]) -> torch.Tensor:
        """The ``shape`` slice at ``start`` of global array ``key`` (of
        ``want_global``), assembled from the pieces that overlap it."""
        from torchgpipe_tpu_torch.resilience.checkpoint import CheckpointError

        recs = self.index.get(key, [])
        if not recs:
            raise CheckpointError(f"checkpoint is missing key {key!r}")
        mine = [(i, r) for i, r in recs if r[2] == layout]
        if not mine:
            raise CheckpointError(
                f"{key!r} was saved under {recs[0][1][2] or 'a global layout'}; it cannot "
                f"be restored into {layout or 'a global layout'}")
        out: Optional[torch.Tensor] = None
        covered, seen = 0, set()
        for i, (gshape, pstart, _) in mine:
            if tuple(gshape) != tuple(want_global):
                raise CheckpointError(
                    f"shape mismatch for {key!r}: saved global {tuple(gshape)}, "
                    f"template expects {tuple(want_global)}")
            piece = self.files[i][key].shape
            span = tuple(pstart), tuple(piece)
            lo = [max(a, b) for a, b in zip(start, pstart)]
            hi = [min(a + n, b + m) for a, n, b, m in zip(start, shape, pstart, piece)]
            if span in seen or any(h <= l for l, h in zip(lo, hi)):
                continue
            seen.add(span)
            arr = self.array(i, key)
            if out is None:
                out = torch.empty(shape, dtype=arr.dtype)
            src = tuple(slice(l - p, h - p) for l, h, p in zip(lo, hi, pstart))
            dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, start))
            out[dst] = arr[src]
            covered += int(np.prod([h - l for l, h in zip(lo, hi)]))
        if out is None or covered != int(np.prod(shape)):
            raise CheckpointError(
                f"the rank files do not cover {key!r}[{start} + {shape}]")
        return out


def read_shards(directory: str, template: Any) -> Any:
    """``template``'s structure with each leaf read from the rank files
    under ``directory``: a :class:`Shard` leaf its slice (``local``'s shape
    at ``start``), any other leaf the whole array; a tensor leaf comes
    back as a tensor of its dtype on its device, an array as an array of
    its dtype."""
    from torchgpipe_tpu_torch.resilience.checkpoint import _leaves, _rebuild

    pieces = _Pieces(directory)
    try:
        leaves = []
        for key, leaf in _leaves(template):
            if isinstance(leaf, Shard):
                like, got = leaf.local, pieces.read(
                    key, leaf.global_shape, leaf.start, tuple(leaf.local.shape), leaf.layout)
            else:
                shape = tuple(np.shape(leaf))
                like, got = leaf, pieces.read(key, shape, (0,) * len(shape), shape, None)
            if isinstance(like, torch.Tensor):
                leaves.append(got.to(device=like.device, dtype=like.dtype))
            else:
                leaves.append(got.numpy().astype(np.asarray(like).dtype))
        return _rebuild(template, leaves)
    finally:
        pieces.close()


def save_sharded(path: str, tree: Any, *, overwrite: bool = True) -> None:
    """Persist ``tree`` (leaves :class:`Shard` pieces or whole arrays) as one
    file a rank under directory ``path``.  Every process of the job calls
    it.  ``overwrite=True`` (the default) writes a sibling temp directory
    first and swaps it in, so a crash mid-save leaves the previous copy
    (at worst under ``<path>.old``); the swap is filesystem surgery, done
    by rank 0 alone between barriers (before the writes, so no rank
    writes into a half-deleted temp directory, and around the swap).  The
    branch depends only on ``overwrite``, never on a per-rank probe of
    the filesystem.  ``overwrite=False`` refuses, on every rank, a
    directory in which rank 0 finds a rank file."""
    final = _abs(path)
    rank, _ = _dist()
    if overwrite:
        tmp, old = final + ".tmp", final + ".old"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        barrier()
        write_shards(tmp, tree)
        barrier()
        if rank == 0:
            shutil.rmtree(old, ignore_errors=True)
            if os.path.exists(final):
                os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        barrier()
    else:
        # Rank 0 looks and every rank acts on its answer: all raise or all write.
        taken = rank == 0 and os.path.isdir(final) and any(
            f.startswith("rank_") for f in os.listdir(final))
        if _from_rank0(taken):
            raise FileExistsError(f"{final} holds a sharded checkpoint already (overwrite=False)")
        if rank == 0:
            os.makedirs(final, exist_ok=True)
        barrier()
        write_shards(final, tree)


def restore_sharded(path: str, template: Any) -> Any:
    """Restore a tree written by :func:`save_sharded` into ``template``'s
    structure and layout (:func:`read_shards`): pass this rank's live tree
    as :class:`Shard` leaves (``SpmdGPipe.train_state``), or whole arrays for
    the gathered tree."""
    return read_shards(_abs(path), template)


def _abs(path: str) -> str:
    return os.path.abspath(os.fspath(path))


__all__ = ["DTYPES_KEY", "INDEX_KEY", "Shard", "barrier", "load", "load_state_dict",
           "read_shards", "restore_sharded", "save", "save_sharded", "state_dict",
           "write_shards"]
