"""Radix prefix-sharing KV cache: shared system prompts reuse KV slots.

Counterpart of ``torchgpipe_tpu/fleet/prefix_cache.py`` (host-side,
near-verbatim).  Thousands of requests open with the same system
prompt; recomputing its KV per request burns prefill work on tokens
whose rows already sit in the pool (RadixAttention, arXiv:2312.07104).
The page granularity is a whole slot of the
:class:`~torchgpipe_tpu_torch.serving.cache_pool.CachePool`:

* a **radix trie** indexes the prompts whose KV currently lives in a
  pool slot.  Admission consults it BEFORE prefilling: the longest
  common prefix names a **donor slot** whose rows ``[0, m)`` are
  exactly the KV a cold prefill of those tokens would write, so the
  engine COPIES them with its one ``prefix_copy`` program and prefills
  only the remainder.  At most ``prompt_len - 1`` tokens reuse: the
  last prompt token always prefills, producing the first-token logits.
* **per-slot refcounts** extend the pool's LIFO free list: inserting a
  prompt pins its slot (``pool.retain``), so a donor outlives its
  request and a referenced slot is never recycled under another tenant.
* **bounded capacity** — LRU eviction past ``max_entries``, plus
  cooperative :meth:`reclaim` under admission pressure.

The trie is host-side and O(prompt length) per operation; the only
device work reuse adds is the one captured ``prefix_copy`` program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchgpipe_tpu_torch.serving.cache_pool import CachePool


@dataclasses.dataclass
class _Entry:
    """One cached prompt: its tokens live in ``slot`` rows [0, len)."""

    tokens: Tuple[int, ...]
    slot: int
    last_used: int


class _Node:
    """Compressed radix-trie node: edges labeled with token runs."""

    __slots__ = ("edges", "entry")

    def __init__(self) -> None:
        # first token of the run -> (full run, child node)
        self.edges: Dict[int, Tuple[Tuple[int, ...], "_Node"]] = {}
        self.entry: Optional[_Entry] = None


def _common_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixPrefixCache:
    """The trie + pinning policy; attach via ``Engine(prefix_cache=)``.

    ``min_prefix_len`` guards against copying tiny prefixes (the copy
    dispatch has a fixed cost — reusing 2 tokens is not worth it);
    ``max_entries`` bounds how many pool slots the cache may pin.
    """

    def __init__(self, *, min_prefix_len: int = 4,
                 max_entries: int = 2) -> None:
        if min_prefix_len < 1:
            raise ValueError(
                f"min_prefix_len must be >= 1, got {min_prefix_len}"
            )
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}"
            )
        self.min_prefix_len = min_prefix_len
        self.max_entries = max_entries
        self._root = _Node()
        self._entries: Dict[int, _Entry] = {}   # slot -> entry
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.reused_tokens = 0
        self.evictions = 0

    # ------------------------------------------------------------------ #
    # trie mechanics                                                     #
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[_Entry]:
        return list(self._entries.values())

    def _any_entry(self, node: _Node) -> Optional[_Entry]:
        """Some entry at or below ``node`` — every one shares the path's
        prefix, so any of them is a valid donor."""
        if node.entry is not None:
            return node.entry
        for _, (_, child) in sorted(node.edges.items()):
            got = self._any_entry(child)
            if got is not None:
                return got
        return None

    def match(self, prompt: Any,
              limit: Optional[int] = None) -> Tuple[int, Optional[int]]:
        """Longest cached prefix of ``prompt``: ``(m, donor_slot)``.

        ``m`` is capped at ``limit`` (the engine passes
        ``prompt_len - 1``) and zeroed below ``min_prefix_len`` — a
        short match reports as a miss.  A hit refreshes the donor
        entry's LRU stamp."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if limit is not None:
            toks = toks[:max(limit, 0)]
        node, depth = self._root, 0
        best: Tuple[int, Optional[_Node]] = (0, None)
        while toks[depth:]:
            edge = node.edges.get(toks[depth])
            if edge is None:
                break
            run, child = edge
            k = _common_len(run, toks[depth:])
            depth += k
            if k < len(run):
                # Ended mid-edge: the prefix continues into this run —
                # any entry below ``child`` shares prompt[:depth].
                best = (depth, child)
                break
            node = child
            best = (depth, node)
        m, at = best
        if m < self.min_prefix_len or at is None:
            self.misses += 1
            return 0, None
        entry = self._any_entry(at)
        if entry is None:       # pragma: no cover — structural invariant
            self.misses += 1
            return 0, None
        self._tick += 1
        entry.last_used = self._tick
        self.hits += 1
        self.reused_tokens += m
        return m, entry.slot

    def insert(self, prompt: Any, slot: int, pool: CachePool) -> bool:
        """Index ``prompt`` as living in ``slot`` and PIN the slot
        (``pool.retain``).  Returns False (no pin) when the prompt is
        shorter than ``min_prefix_len``, the slot already donates, or an
        existing entry's prompt already covers this one (prefix of a
        cached prompt — nothing new to index).  May LRU-evict to stay
        within ``max_entries``."""
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        if len(toks) < self.min_prefix_len or slot in self._entries:
            return False
        covered, _ = self._lookup_exact_cover(toks)
        if covered:
            return False
        self._tick += 1
        entry = _Entry(tokens=toks, slot=slot, last_used=self._tick)
        self._insert_node(toks, entry)
        self._entries[slot] = entry
        pool.retain(slot)
        while len(self._entries) > self.max_entries:
            self._evict_lru(pool)
        return True

    def _lookup_exact_cover(
        self, toks: Tuple[int, ...]
    ) -> Tuple[bool, int]:
        """Is ``toks`` a prefix of (or equal to) a cached prompt?"""
        node, depth = self._root, 0
        while toks[depth:]:
            edge = node.edges.get(toks[depth])
            if edge is None:
                return False, depth
            run, child = edge
            k = _common_len(run, toks[depth:])
            depth += k
            if k == len(run):
                node = child
                continue
            # mid-edge: covered iff the whole remainder matched
            return depth == len(toks), depth
        return True, depth

    def _insert_node(self, toks: Tuple[int, ...], entry: _Entry) -> None:
        node, depth = self._root, 0
        while True:
            rest = toks[depth:]
            if not rest:
                node.entry = entry
                return
            edge = node.edges.get(rest[0])
            if edge is None:
                leaf = _Node()
                leaf.entry = entry
                node.edges[rest[0]] = (rest, leaf)
                return
            run, child = edge
            k = _common_len(run, rest)
            if k == len(run):
                node = child
                depth += k
                continue
            # split the edge at k
            mid = _Node()
            mid.edges[run[k]] = (run[k:], child)
            node.edges[rest[0]] = (run[:k], mid)
            node = mid
            depth += k

    def _remove_node(self, toks: Tuple[int, ...]) -> None:
        """Unlink the entry stored exactly at ``toks`` (path compression
        of emptied nodes is skipped — the trie is bounded by
        ``max_entries`` live prompts, so stranded interior nodes are a
        few dozen tuples at most)."""
        node, depth = self._root, 0
        parents: List[Tuple[_Node, int]] = []
        while toks[depth:]:
            edge = node.edges.get(toks[depth])
            if edge is None:
                return
            run, child = edge
            parents.append((node, toks[depth]))
            node = child
            depth += len(run)
        node.entry = None
        while parents and node.entry is None and not node.edges:
            parent, first = parents.pop()
            del parent.edges[first]
            node = parent

    # ------------------------------------------------------------------ #
    # eviction                                                           #
    # ------------------------------------------------------------------ #

    def _evict_entry(self, entry: _Entry, pool: CachePool) -> None:
        self._remove_node(entry.tokens)
        del self._entries[entry.slot]
        pool.release(entry.slot)
        self.evictions += 1

    def _evict_lru(self, pool: CachePool) -> None:
        victim = min(self._entries.values(), key=lambda e: e.last_used)
        self._evict_entry(victim, pool)

    def reclaim(self, pool: CachePool, want: int = 1) -> int:
        """Admission pressure valve: evict up to ``want`` IDLE entries —
        ones whose pin is the slot's only remaining reference, so
        eviction actually frees a slot (an entry whose request still
        runs is skipped; evicting it would free nothing).  Returns the
        number of slots freed."""
        freed = 0
        for entry in sorted(self._entries.values(),
                            key=lambda e: e.last_used):
            if freed >= want:
                break
            if pool.refcount(entry.slot) == 1 and (
                pool.owner_of(entry.slot) is None
            ):
                self._evict_entry(entry, pool)
                freed += 1
        return freed

    def clear(self, pool: CachePool) -> None:
        """Drop every entry (and its pin) — e.g. before a drain."""
        for entry in list(self._entries.values()):
            self._evict_entry(entry, pool)

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "reused_tokens": self.reused_tokens,
            "evictions": self.evictions,
        }


__all__ = ["RadixPrefixCache"]
