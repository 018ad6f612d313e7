"""LoRA fine-tuning helpers (Hu et al., arXiv:2106.09685).

Counterpart of ``torchgpipe_tpu/models/lora.py``.  The adapters are a
model knob (``TransformerConfig(lora_rank=r)``: each block's ``lora``
submodule holds ``A``/``B`` factors on q/k/v/o, with ``B`` zero so a
fresh model computes the base model).  This module supplies what goes
around them:

* :func:`lora_mask`: which parameters are adapters, by name;
* :func:`lora_optimizer`: freezes every other parameter of the model
  (``requires_grad=False``: no ``.grad``, no optimizer state, bitwise
  unchanged by training) and returns the ``params -> Optimizer`` factory
  that ``GPipe.make_train_step`` takes, building the inner optimizer
  over the trainable parameters it is given;
* :func:`merge_lora`: folds the adapters into the base projections
  (``w + A @ B * alpha / rank``) and drops them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import TransformerBlock, TransformerConfig

__all__ = ["lora_mask", "lora_optimizer", "merge_lora"]


def lora_mask(model: nn.Module) -> Dict[str, bool]:
    """``{parameter name: True}`` exactly for the parameters under a
    ``lora`` submodule."""
    return {name: "lora" in name.split(".") for name, _ in model.named_parameters()}


class _Frozen:
    """The optimizer of a stage with nothing to train: steps do nothing."""

    defaults: Dict[str, Any] = {}
    param_groups: List[Dict[str, Any]] = []
    state: Dict[Any, Any] = {}

    def step(self, closure: Any = None) -> None:
        return None

    def zero_grad(self, set_to_none: bool = True) -> None:
        return None


def lora_optimizer(
    inner: Callable[[List[nn.Parameter]], torch.optim.Optimizer], model: nn.Module,
) -> Callable[[Iterable[nn.Parameter]], Any]:
    """Freeze every non-adapter parameter of ``model`` and return
    ``make(params)``: ``inner`` (for example
    ``functools.partial(torch.optim.AdamW, lr=1e-3)``) over the
    parameters in ``params`` that still train, so frozen base weights
    get no ``.grad`` and no optimizer state.  Parameters outside
    ``model`` train as given (a parametric loss layer's, say).  Pass the
    factory to ``GPipe.make_train_step``, or call it on the parameters to
    step."""
    mask = lora_mask(model)
    if not any(mask.values()):
        raise ValueError(
            "params contain no 'lora' adapter leaves — every update "
            "would be zeroed and training would silently be a no-op.  "
            "Build the model with TransformerConfig(lora_rank=...) (and "
            "init, or splice fresh adapters next to imported weights)"
        )
    for name, p in model.named_parameters():
        if not mask[name]:
            p.requires_grad_(False)
            p.grad = None

    def make(params: Iterable[nn.Parameter]) -> Any:
        train = [p for p in params if p.requires_grad]
        return inner(train) if train else _Frozen()

    return make


_PAIRS = (("wq", "qa", "qb"), ("wk", "ka", "kb"), ("wv", "va", "vb"),
          ("wo", "oa", "ob"))


@torch.no_grad()
def merge_lora(cfg: TransformerConfig, model: nn.Module) -> Tuple[TransformerConfig, nn.Sequential]:
    """``(cfg', model')`` with every block's adapters folded into its
    base projections, ``w <- w + (A @ B) * (alpha / rank)`` (the product
    in the adapters' dtype, then cast to ``w``'s, as the reference), and
    removed.  ``model`` is the flat ``[embed, blocks..., head]``; the
    embedding and the head are shared with it, each block is new.
    ``cfg'`` has ``lora_rank=None``."""
    if not cfg.lora_rank:
        raise ValueError("cfg.lora_rank is not set — nothing to merge")
    layers = list(model)
    merged_cfg = dataclasses.replace(cfg, lora_rank=None)
    ls = cfg.lora_alpha / cfg.lora_rank
    out = [layers[0]]
    for block in layers[1:-1]:
        p = block.params()
        if "lora" not in p:
            raise ValueError(
                "block params carry no 'lora' subdict — already merged, "
                "or built with a different config?"
            )
        lo = p.pop("lora")
        new = TransformerBlock(merged_cfg, device=p["wq"].device)
        for name, t in new.params().items():
            t.copy_(p[name])
        for w, a, b in _PAIRS:
            getattr(new, w).copy_(p[w] + ((lo[a] @ lo[b]) * ls).to(p[w].dtype))
        out.append(new)
    out.append(layers[-1])
    return merged_cfg, nn.Sequential(*out)
