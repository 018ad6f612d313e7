"""Static skip routing: which (namespace, name) travels between which stages.

Counterpart of ``torchgpipe_tpu/skip/layout.py`` (``SkipLayout`` /
``inspect_skip_layout``).  Computed once at partition time from the
layers' ``stash``/``pop`` attributes.  The pipeline sends each stashed
value from its stash stage's device straight to its pop stage's device,
never through the stages between them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from torch import nn


def _keys(layer: nn.Module, attr: str) -> Tuple:
    keys = getattr(layer, attr, ())
    # A method of that name (``nn.Sequential.pop``) is no key tuple.
    return () if callable(keys) else tuple(keys or ())


def stash_keys(layer: nn.Module) -> Tuple:
    """The skip keys a layer stashes (``()`` for a plain layer)."""
    return _keys(layer, "stash")


def pop_keys(layer: nn.Module) -> Tuple:
    """The skip keys a layer pops (``()`` for a plain layer; an
    ``nn.Sequential`` layer, whose ``pop`` is a method, pops none)."""
    return _keys(layer, "pop")


class SkipLayout:
    """Routing table over partitioned layers.

    ``by_key[key] = (stash_stage, pop_stage)`` for every cross-referenced skip.
    """

    def __init__(self, by_key: Dict[Tuple, Tuple[int, int]]) -> None:
        self.by_key = dict(by_key)

    def requires_copy(self, key: Any) -> bool:
        """True if the skip crosses a stage boundary."""
        src, dst = self.by_key[key]
        return src != dst

    def external_stashes(self, stage: int) -> List:
        """Keys stashed in ``stage`` that are popped in a *later* stage."""
        return sorted(
            k for k, (src, dst) in self.by_key.items() if src == stage and dst != stage
        )

    def external_pops(self, stage: int) -> List:
        """Keys popped in ``stage`` that were stashed in an *earlier* stage."""
        return sorted(
            k for k, (src, dst) in self.by_key.items() if dst == stage and src != stage
        )

    def pop_stage(self, key: Any) -> int:
        return self.by_key[key][1]

    def stash_stage(self, key: Any) -> int:
        return self.by_key[key][0]


def inspect_skip_layout(partitions: Sequence[Sequence[nn.Module]]) -> SkipLayout:
    """Build the routing table from partitioned layers."""
    stash_at: Dict[Tuple, int] = {}
    by_key: Dict[Tuple, Tuple[int, int]] = {}
    for j, stage in enumerate(partitions):
        for layer in stage:
            for key in stash_keys(layer):
                stash_at[key] = j
            for key in pop_keys(layer):
                if key in stash_at:
                    by_key[key] = (stash_at[key], j)
    return SkipLayout(by_key)
