"""Named skip connections that travel directly from stash stage to pop stage.

Counterpart of ``torchgpipe_tpu/skip/__init__.py``.  A skippable layer is
an ``nn.Module`` with ``stash`` and ``pop`` tuples of skip keys and a
``forward(x, pops) -> (y, stashes)`` over dicts keyed by those keys; a
plain layer has neither attribute and a ``forward(x)``.  The pipeline
reads the keys to build a :class:`SkipLayout` and sends each stashed
tensor from its stash stage straight to its pop stage.  There the skip is
a detached leaf that requires grad; its ``.grad`` goes back to the stash
stage, whose backward takes both its output's and its stashes'
cotangents (:mod:`torchgpipe_tpu_torch.pipeline`).

Example (a residual that may be cut by a stage boundary)::

    ns = Namespace()
    layers = [stash("x", ns=ns), conv_a, bn_a, relu, pop_add("x", ns=ns)]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch.skip.layout import (  # noqa: F401
    SkipLayout,
    inspect_skip_layout,
    pop_keys,
    stash_keys,
)
from torchgpipe_tpu_torch.skip.namespace import Namespace, skip_key  # noqa: F401

__all__ = [
    "Namespace",
    "SkipLayout",
    "SkipSequential",
    "apply_layer",
    "call_layer",
    "inspect_skip_layout",
    "layer_name",
    "skippable",
    "stash",
    "pop_cat",
    "pop_add",
    "verify_skippables",
    "skip_key",
]


def layer_name(layer: nn.Module) -> str:
    """A layer's ``name`` attribute, else its class name."""
    return getattr(layer, "name", None) or type(layer).__name__


class Skippable(nn.Module):
    """``fn(x, pops) -> (y, stashes)`` as a skip-aware layer; ``pops`` and
    ``stashes`` are keyed by the plain names, namespaced here."""

    def __init__(
        self,
        fn: Callable,
        *,
        stash: Sequence[str] = (),
        pop: Sequence[str] = (),
        ns: Optional[Namespace] = None,
        name: str = "skippable",
    ) -> None:
        super().__init__()
        self.fn = fn
        self.name = name
        self.ns = ns
        self.stash_names = tuple(stash)
        self.stash = tuple(skip_key(ns, n) for n in stash)
        self.pop = tuple(skip_key(ns, n) for n in pop)
        self._name_of = {skip_key(ns, n): n for n in tuple(stash) + tuple(pop)}

    def forward(self, x: Any, pops: Dict) -> Tuple[Any, Dict]:
        plain_pops = {self._name_of[k]: v for k, v in pops.items()}
        y, stashes = self.fn(x, plain_pops)
        missing = set(self.stash_names) - set(stashes)
        if missing:
            raise RuntimeError(
                f"skippable layer {self.name!r} did not stash {sorted(missing)}"
            )
        undeclared = set(stashes) - set(self.stash_names)
        if undeclared:
            raise RuntimeError(
                f"skippable layer {self.name!r} stashed undeclared "
                f"{sorted(undeclared)}; declare them in stash=[...] so the "
                "layout can route them"
            )
        return y, {skip_key(self.ns, n): v for n, v in stashes.items()}


def skippable(
    fn: Callable,
    *,
    stash: Sequence[str] = (),
    pop: Sequence[str] = (),
    ns: Optional[Namespace] = None,
    name: str = "skippable",
) -> Skippable:
    """Wrap ``fn(x, pops: dict) -> (y, stashes: dict)`` into a skip-aware
    layer."""
    return Skippable(fn, stash=stash, pop=pop, ns=ns, name=name)


def stash(
    skip_name: str, *, ns: Optional[Namespace] = None, name: Optional[str] = None
) -> Skippable:
    """Identity layer that stashes its input under ``skip_name``."""

    def fn(x, pops):
        del pops
        return x, {skip_name: x}

    return skippable(fn, stash=[skip_name], ns=ns, name=name or f"stash[{skip_name}]")


def pop_cat(
    skip_name: str,
    *,
    axis: int = 1,
    ns: Optional[Namespace] = None,
    name: Optional[str] = None,
) -> Skippable:
    """Pop ``skip_name`` and concatenate it to the input along ``axis``
    (default 1, the channel axis of the port's NCHW layout, where the
    reference's NHWC default is -1)."""

    def fn(x, pops):
        return torch.cat([x, pops[skip_name]], dim=axis), {}

    return skippable(fn, pop=[skip_name], ns=ns, name=name or f"pop_cat[{skip_name}]")


def pop_add(
    skip_name: str, *, ns: Optional[Namespace] = None, name: Optional[str] = None
) -> Skippable:
    """Pop ``skip_name`` and add it to the input (residual connection)."""

    def fn(x, pops):
        return x + pops[skip_name], {}

    return skippable(fn, pop=[skip_name], ns=ns, name=name or f"pop_add[{skip_name}]")


def verify_skippables(layers: Sequence[nn.Module]) -> None:
    """Static integrity check of stash/pop matching over the whole model,
    with the reference's messages: every pop must follow a matching
    stash, and every (ns, name) must be stashed/popped exactly once."""
    msgs = []
    stashed: Dict[Tuple, str] = {}
    popped: Dict[Tuple, str] = {}
    for layer in layers:
        name = layer_name(layer)
        for key in pop_keys(layer):
            if key in popped:
                msgs.append(
                    f"'{key[1]}' is popped by both {popped[key]!r} and {name!r}; "
                    "use a different Namespace to isolate them"
                )
            elif key not in stashed:
                msgs.append(f"{name!r} pops '{key[1]}' before it is stashed")
            popped[key] = name
        for key in stash_keys(layer):
            if key in stashed:
                msgs.append(
                    f"'{key[1]}' is stashed by both {stashed[key]!r} and {name!r}; "
                    "use a different Namespace to isolate them"
                )
            stashed[key] = name
    for key, who in stashed.items():
        if key not in popped:
            msgs.append(f"no layer pops '{key[1]}' stashed by {who!r}")
    if msgs:
        raise TypeError("\n".join(msgs))


def call_layer(layer: nn.Module, x: Any, pops: Dict) -> Tuple[Any, Dict]:
    """``(y, stashes)`` of one layer given its popped skips: a skip layer
    is called as ``layer(x, pops)``, any other as ``layer(x)``."""
    if pops or stash_keys(layer):
        return layer(x, pops)
    return layer(x), {}


def apply_layer(
    layer: nn.Module, x: Any, skips: Dict,
    call: Callable[[nn.Module, Any, Dict], Tuple[Any, Dict]] = call_layer,
) -> Any:
    """Run one layer through ``call``, routing its pops and stashes
    through ``skips`` (mutated in place).  Shared by
    :class:`SkipSequential`, the pipeline stages and the balance
    profilers (which pass their own ``call``), so the convention cannot
    drift."""
    y, stashed = call(layer, x, {k: skips.pop(k) for k in pop_keys(layer)})
    skips.update(stashed)
    return y


class SkipSequential(nn.Sequential):
    """An ``nn.Sequential`` whose forward threads skips through its
    layers: the unpipelined model of a layer list with skips (the
    reference's ``layers.sequential_apply``)."""

    def forward(self, x: Any) -> Any:  # type: ignore[override]
        skips: Dict = {}
        for layer in self:
            x = apply_layer(layer, x, skips)
        return x
