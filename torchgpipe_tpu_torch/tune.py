"""Serving memory accounting: the KV pool's bytes and the slot cap.

Counterpart of ``tree_bytes``, ``serving_cache_bytes`` and
``serving_max_slots`` in ``torchgpipe_tpu/tune.py`` (``:90``, ``:1041``).
The reference measures the pool with ``jax.eval_shape``; here the bytes
come from the shapes :func:`~torchgpipe_tpu_torch.models.generation.
init_cache` and ``init_quant_cache`` allocate.  The reference's pool also
holds a 4-byte ``length`` scalar, which the port keeps on the host (its
frontiers live in the serving engine's lengths buffer), so the port's
pool has no fixed part.  The rest of the reference's tuner (probes,
planner, MFU prediction) is not ported yet (ROADMAP.md, queue A item 5.6).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total bytes of every shaped leaf: tensors and arrays in nested
    dicts, lists and tuples, or a module's parameters and buffers."""
    if isinstance(tree, torch.nn.Module):
        return tree_bytes(list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return int(np.prod(tuple(tree.shape), dtype=np.int64)) * _itemsize(tree.dtype)
    return 0


def serving_cache_bytes(
    cfg: Any,
    num_slots: int,
    max_len: int,
    *,
    kv_quant: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> int:
    """Bytes of a ``(num_slots, max_len)`` serving KV-cache pool: per
    layer a K and a V buffer ``[num_slots, max_len, kv_heads, head_dim]``
    in ``dtype`` (``cfg.dtype`` by default), or int8 with two float32
    scale buffers ``[num_slots, kv_heads, max_len]``."""
    rows = num_slots * max_len * cfg.kv_heads
    if kv_quant:
        per_layer = 2 * rows * cfg.head_dim + 2 * rows * 4
    else:
        per_layer = 2 * rows * cfg.head_dim * _itemsize(dtype or cfg.dtype)
    return cfg.n_layers * per_layer


def serving_max_slots(
    cfg: Any,
    max_len: int,
    hbm_budget_bytes: int,
    *,
    kv_quant: bool = False,
    dtype: Optional[torch.dtype] = None,
    param_bytes: int = 0,
    overhead_bytes: int = 0,
) -> int:
    """Largest slot count whose KV pool fits ``hbm_budget_bytes`` after
    ``param_bytes`` (the resident weights — ``tree_bytes(model)``) and
    ``overhead_bytes`` are set aside.  The port's steps update the pool
    in place, so one copy of it is counted: the reference's
    ``serving_max_slots(..., donated=True)``.  Returns 0 when even one
    slot does not fit."""
    avail = hbm_budget_bytes - param_bytes - overhead_bytes
    per_slot = serving_cache_bytes(cfg, 1, max_len, kv_quant=kv_quant, dtype=dtype)
    return max(int(avail // per_slot), 0)


__all__ = ["serving_cache_bytes", "serving_max_slots", "tree_bytes"]
