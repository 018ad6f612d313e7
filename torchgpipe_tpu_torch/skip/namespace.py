"""Namespaces isolate skip names so a skippable layer can be reused.

Counterpart of ``torchgpipe_tpu/skip/namespace.py`` (pure Python, copied
so the port imports nothing of the reference): UUID-identified, orderable,
hashable; ``None`` acts as the default namespace.  Keys sort, so the
stage's external stash and pop lists have one order on every run.
"""

from __future__ import annotations

import uuid
from functools import total_ordering
from typing import Any, Tuple


@total_ordering
class Namespace:
    __slots__ = ("_id",)

    def __init__(self) -> None:
        self._id = uuid.uuid4().hex

    def __repr__(self) -> str:
        return f"<Namespace {self._id[:8]}>"

    def __hash__(self) -> int:
        return hash(self._id)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Namespace):
            return self._id == other._id
        return NotImplemented

    def __lt__(self, other: object) -> bool:
        if isinstance(other, Namespace):
            return self._id < other._id
        if other is None:
            return False  # None (default namespace) sorts first
        return NotImplemented


def skip_key(ns: Any, name: str) -> Tuple:
    """Canonical (namespace, name) key; namespace may be None."""
    return (_NsKey(ns), name)


@total_ordering
class _NsKey:
    """Sortable wrapper making ``None`` and :class:`Namespace` comparable."""

    __slots__ = ("ns",)

    def __init__(self, ns: Any) -> None:
        if not (ns is None or isinstance(ns, Namespace)):
            raise TypeError("namespace must be a Namespace or None")
        self.ns = ns

    def __repr__(self) -> str:
        return repr(self.ns)

    def __hash__(self) -> int:
        return hash(self.ns)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, _NsKey):
            return self.ns == other.ns
        return NotImplemented

    def __lt__(self, other: object) -> bool:
        if not isinstance(other, _NsKey):
            return NotImplemented
        if self.ns is None:
            return other.ns is not None
        if other.ns is None:
            return False
        return self.ns < other.ns
