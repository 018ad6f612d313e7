"""Slot-pooled KV caches: fixed banks, free-list allocation, recycling.

Counterpart of ``torchgpipe_tpu/serving/cache_pool.py`` (``CachePool``,
``:39``).  Request churn must never change a tensor shape: the serving
engine's programs are CUDA graphs captured once over fixed buffers.  The
pool keeps a fixed ``[num_slots, max_len, kv_heads, head_dim]`` K/V bank
per layer (the port's :class:`~torchgpipe_tpu_torch.models.generation.
KVCache`, or the int8 :class:`~torchgpipe_tpu_torch.models.generation.
QuantKVCache`, whose batch dim IS the slot dim), a host-side free list
handing slots to requests and taking them back, and a per-slot host
``lengths`` mirror of each slot's sequence frontier.

The bank is updated IN PLACE by the engine's steps (the reference
replaces it wholesale after every compiled step), so no step ever holds
two copies of the pool.

Recycling needs NO device work: a freed slot's stale rows are dead by
masking — every attention read masks cache rows ``> length``, and decode
writes land exactly at ``length``, so a recycled slot can never see its
previous tenant's K/V, int8 scales included (the bitwise slot-reuse test
in ``tests/test_torch_serving.py`` pins this).

Sizing: :func:`torchgpipe_tpu_torch.tune.serving_cache_bytes` accounts
the pool from its shapes; :func:`~torchgpipe_tpu_torch.tune.
serving_max_slots` inverts it against a memory budget — the scheduler's
admission control reads that number.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchgpipe_tpu_torch.models.generation import init_cache, init_quant_cache
from torchgpipe_tpu_torch.models.transformer import Device, TransformerConfig


class CachePool:
    """A fixed-shape KV bank + free-list slot allocator.

    ``cache`` is public: the engine's steps write it in place.  The pool
    object owns allocation bookkeeping (host-side, O(1) per event).
    ``lengths`` is the host mirror of per-slot frontiers: the engine
    advances it deterministically (it knows exactly how many tokens each
    step absorbed), so steady-state serving never fetches it back from
    the device.  The bank is allocated under ``torch.inference_mode()``,
    where the engine's steps run.
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        num_slots: int,
        max_len: int,
        *,
        kv_quant: bool = False,
        dtype: Optional[torch.dtype] = None,
        device: Device = None,
    ) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(
                f"max_len must hold a prompt plus one generated token, "
                f"got {max_len}"
            )
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.dtype = dtype
        with torch.inference_mode():
            self.cache: Any = (
                init_quant_cache(cfg, num_slots, max_len, device=device)
                if kv_quant
                else init_cache(cfg, num_slots, max_len, device=device, dtype=dtype)
            )
        self.lengths = np.zeros((num_slots,), np.int32)
        # LIFO free list: the most-recently-freed slot is reused first,
        # exercising the stale-row masking continuously.
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._owner: Dict[int, str] = {}
        # Per-slot refcounts: alloc() hands the owner one reference;
        # retain() adds more.  A slot re-enters the free list only when
        # the LAST reference releases.
        self._refs: Dict[int, int] = {}

    # ------------------------------------------------------------------ #
    # allocation                                                         #
    # ------------------------------------------------------------------ #

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        """Slots owned by a live request (pinned-only slots excluded)."""
        return len(self._owner)

    @property
    def num_pinned(self) -> int:
        """Slots kept out of the free list ONLY by extra references."""
        return self.num_slots - len(self._free) - len(self._owner)

    def alloc(self, owner: str) -> Optional[int]:
        """Hand a free slot to ``owner`` (its frontier reset to 0, one
        reference), or ``None`` when the pool is exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = owner
        self._refs[slot] = 1
        self.lengths[slot] = 0
        return slot

    def retain(self, slot: int) -> int:
        """Add a reference to an allocated/pinned slot; returns the new
        refcount."""
        if slot not in self._refs:
            raise KeyError(f"slot {slot} is not allocated")
        self._refs[slot] += 1
        return self._refs[slot]

    def refcount(self, slot: int) -> int:
        return self._refs.get(slot, 0)

    def free(self, slot: int) -> None:
        """The OWNER's release: the slot loses its request but recycles
        only when no extra references pin it.  No device work."""
        if slot not in self._owner:
            raise KeyError(f"slot {slot} is not allocated")
        del self._owner[slot]
        self.release(slot)

    def release(self, slot: int) -> None:
        """Drop one reference; at refcount 0 the slot re-enters the LIFO
        free list with its frontier zeroed."""
        refs = self._refs.get(slot)
        if refs is None:
            raise KeyError(f"slot {slot} is not allocated")
        if refs > 1:
            self._refs[slot] = refs - 1
            return
        del self._refs[slot]
        self.lengths[slot] = 0
        self._free.append(slot)

    def owner_of(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    def check_refcounts(self) -> None:
        """Structural invariants: free/referenced partition the slots,
        every owned slot is referenced, refcounts are positive.  Raises
        (never ``assert`` — the gate must stay live under ``python -O``)."""
        free = set(self._free)
        reffed = set(self._refs)
        if free & reffed:
            raise RuntimeError(
                f"slots both free and referenced: {sorted(free & reffed)}"
            )
        if free | reffed != set(range(self.num_slots)):
            raise RuntimeError(
                f"free {sorted(free)} + referenced {sorted(reffed)} do "
                f"not partition the {self.num_slots} slots"
            )
        if not set(self._owner) <= reffed:
            raise RuntimeError(
                f"owned slots {sorted(set(self._owner) - reffed)} carry "
                "no reference"
            )
        if any(n < 1 for n in self._refs.values()):
            raise RuntimeError(f"non-positive refcount: {self._refs}")

    # ------------------------------------------------------------------ #
    # accounting and the device frontier                                 #
    # ------------------------------------------------------------------ #

    def bytes(self) -> int:
        """Bytes the pool's device buffers pin (equal to the allocated
        size, from the shapes)."""
        from torchgpipe_tpu_torch.tune import serving_cache_bytes

        return serving_cache_bytes(
            self.cfg, self.num_slots, self.max_len,
            kv_quant=self.kv_quant, dtype=self.dtype,
        )

    def lengths_device(self, out: torch.Tensor,
                       staging: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Copy the host frontier mirror into ``out``, the engine's static
        int64 ``[num_slots]`` lengths buffer, which its programs read.

        The reference hands each step a SNAPSHOT of the mirror, because
        its step runs asynchronously while the host mutates the mirror.
        Here the copy goes through ``staging`` (a pinned host buffer, on
        the card) with ``non_blocking=True``: the caller must not write
        ``staging`` again before the copy has run (the engine waits on an
        event), and the programs read ``out``, which no host write
        races."""
        src = torch.from_numpy(self.lengths.astype(np.int64))
        if staging is None:
            out.copy_(src)
        else:
            staging.copy_(src)
            out.copy_(staging, non_blocking=True)
        return out


__all__ = ["CachePool"]
