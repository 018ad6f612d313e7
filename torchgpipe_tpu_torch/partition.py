"""Balance-driven partitioning of a sequential model into pipeline stages.

Counterpart of ``torchgpipe_tpu/partition.py`` with the same
``BalanceError`` messages, plus :class:`Stage`, the module a stage runs.
A layer here is an ``nn.Module``; the reference's ``layers.Layer``
protocol (``init``/``apply`` over explicit pytrees) has no counterpart in
the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch import nn

from torchgpipe_tpu_torch.rng import Key, scope
from torchgpipe_tpu_torch.skip import SkipLayout, apply_layer

_RECOMMEND = (
    "If your model is still under development, its optimal balance would change\n"
    "frequently. In this case, we highly recommend "
    "torchgpipe_tpu_torch.balance for naive automatic balancing:\n"
    "\n"
    "  from torchgpipe_tpu_torch import GPipe\n"
    "  from torchgpipe_tpu_torch.balance import balance_by_time\n"
    "\n"
    "  balance = balance_by_time(n_stages, layers, sample)\n"
    "  model = GPipe(layers, balance, ...)\n"
)


class BalanceError(ValueError):
    """Reference: torchgpipe/gpipe.py:67-68."""


def verify_module(layers: Sequence[nn.Module]) -> None:
    """Validate the sequential model: a non-empty ``nn.Sequential`` or
    list of modules in which no module appears twice (a module's
    parameters belong to exactly one stage)."""
    if not isinstance(layers, (nn.Sequential, list, tuple)) or len(layers) == 0:
        raise TypeError(
            "model must be a non-empty nn.Sequential or list/tuple of modules"
        )
    seen = set()
    for i, layer in enumerate(layers):
        if not isinstance(layer, nn.Module):
            raise TypeError(
                f"model elements must be nn.Module instances, got "
                f"{type(layer).__name__}"
            )
        if id(layer) in seen:
            raise ValueError(
                f"module {type(layer).__name__} at index {i} appears twice; "
                "each layer must be a distinct module (its parameters belong "
                "to one stage)"
            )
        seen.add(id(layer))


def split_layers(
    layers: Sequence[nn.Module], balance: Sequence[int]
) -> List[List[nn.Module]]:
    """Split layers into contiguous stages of sizes ``balance``.

    Reference: torchgpipe/gpipe.py:71-127 (``split_module``), with the same
    failure modes: balance/layer-count mismatch and non-positive entries.
    """
    balance = list(balance)
    if len(layers) != sum(balance):
        raise BalanceError(
            f"module and sum of balance have different length "
            f"(module: {len(layers)}, sum of balance: {sum(balance)})\n\n{_RECOMMEND}"
        )
    if any(x <= 0 for x in balance):
        raise BalanceError(
            f"all balance numbers must be positive integer (balance: {balance})"
        )
    layers = list(layers)
    stages: List[List[nn.Module]] = []
    i = 0
    for n in balance:
        stages.append(layers[i : i + n])
        i += n
    return stages


class Stage(nn.Sequential):
    """One pipeline stage: its layers in order, threading skips.

    ``forward(x, skips_in, key) -> (y, ext)``: ``skips_in`` holds the
    skips stashed on earlier stages that this stage pops, and ``ext`` the
    ones this stage stashes for later stages (``layout.external_*``).
    Skips stashed and popped inside the stage stay inside it.  ``key``
    (a micro-batch's :class:`~torchgpipe_tpu_torch.rng.Key`, or None)
    is folded with each layer's index in the whole model (``offset`` is
    the index of this stage's first layer), the reference's
    ``fold_in(rng, offset + li)``."""

    def __init__(self, layers: Sequence[nn.Module], index: int,
                 layout: SkipLayout, offset: int = 0) -> None:
        super().__init__(*layers)
        self.index = index
        self.offset = offset
        self.ext_stash_keys: Tuple = tuple(layout.external_stashes(index))
        self.ext_pop_keys: Tuple = tuple(layout.external_pops(index))

    def forward(  # type: ignore[override]
        self, x: Any, skips_in: Dict = None, key: Optional[Key] = None
    ) -> Tuple[Any, Dict]:
        skips = dict(skips_in or {})
        for li, layer in enumerate(self):
            if key is None:
                x = apply_layer(layer, x, skips)
                continue
            with scope(key.fold(self.offset + li)):
                x = apply_layer(layer, x, skips)
        return x, {k: skips[k] for k in self.ext_stash_keys}
