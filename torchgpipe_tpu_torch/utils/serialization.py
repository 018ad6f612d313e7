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

:func:`save` writes atomically (temp file, fsync, rename).  The sharded
SPMD checkpoints (``save_sharded``, ``restore_sharded``) are not ported
yet (ROADMAP.md, queue A item 5.4).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import not_ported

DTYPES_KEY = "__dtypes__"

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
        if t.dtype == torch.bfloat16:
            tags[key] = "bfloat16"
            t = t.contiguous().view(torch.int16)
            out[key] = t.numpy().view(np.uint16).copy()
        else:
            out[key] = t.contiguous().numpy().copy()
    if tags:
        out[DTYPES_KEY] = np.array(json.dumps(tags))
    return out


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


def save_sharded(path: str, tree: Any, *, overwrite: bool = True) -> None:
    """Sharded SPMD checkpoints: not ported yet."""
    raise not_ported("utils.serialization.save_sharded (orbax, SPMD)", "5.4")


def restore_sharded(path: str, template: Any) -> Any:
    """Sharded SPMD checkpoints: not ported yet."""
    raise not_ported("utils.serialization.restore_sharded (orbax, SPMD)", "5.4")


def _abs(path: str) -> str:
    return os.path.abspath(os.fspath(path))


__all__ = ["DTYPES_KEY", "load", "load_state_dict", "restore_sharded", "save",
           "save_sharded", "state_dict"]
