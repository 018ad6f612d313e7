"""Mixed precision: compute in a low-precision dtype over float32 master
parameters.

Counterpart of ``torchgpipe_tpu/precision.py``:

* **master parameters keep their dtype.**  :func:`apply_policy` wraps
  each leaf layer; its forward casts the layer's floating parameters
  and inputs to the compute dtype (``torch.func.functional_call`` with
  the cast parameters).  The cast is part of the autograd graph, so the
  gradients land in the masters' ``.grad`` in the masters' dtype.
* **activations flow in the compute dtype**, stage to stage and into the
  attention kernels (which take bfloat16 only).
* **normalisation runs in float32**: batch norm (plain and deferred),
  layer norm and instance norm see a float32 upcast of their input and
  return the compute dtype; their parameters are not cast and their
  running statistics stay float32.

Compound layers (a module with children and no parameters of its own,
such as a ResNet residual and its downsample chain) are not wrapped:
the policy recurses into their children and replaces them in place, as
``batchnorm.convert_deferred_batch_norm`` does.  A wrapper keeps the
leaf's ``name`` and skip declarations (``stash``/``pop``), so pipeline
partitioning, skip routing and the balance profilers see the layer
they saw before; ``convert.layers_from_jax`` loads into the wrapped
layer (:func:`unwrap`).  A wrapper's parameters are the leaf's, under
the prefix ``layer.``.

:class:`DynamicLossScale` is the reference's loss-scaling protocol as
immutable state, with a ``state_dict`` that reads back in the
reference's form, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
from torch import nn

from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
from torchgpipe_tpu_torch.ops.nn import BatchNorm, InstanceNorm, LayerNorm
from torchgpipe_tpu_torch.skip import layer_name

# The statistics layers (the reference's _NORM_KINDS: batch_norm,
# deferred_batch_norm, layer_norm, instance_norm; its rms_norm layer has
# no counterpart here: the Llama blocks norm inside their own forward).
_NORM_TYPES = (BatchNorm, DeferredBatchNorm, LayerNorm, InstanceNorm)


def _map(tree: Any, fn: Any) -> Any:
    """``fn`` of every tensor of a tuple/list/dict tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a tuple/list/dict tree in ``dtype``."""
    return _map(tree, lambda t: t.to(dtype) if t.is_floating_point() else t)


class _Policy(nn.Module):
    """A leaf layer under the policy: ``layer`` with its name and skip
    declarations."""

    def __init__(self, layer: nn.Module, dtype: torch.dtype) -> None:
        super().__init__()
        self.layer = layer
        self.dtype = dtype
        self.name = layer_name(layer)
        for attr in ("stash", "pop"):
            if hasattr(layer, attr):
                setattr(self, attr, getattr(layer, attr))

    def extra_repr(self) -> str:
        return f"dtype={self.dtype}"


class ComputeIn(_Policy):
    """Runs its layer on parameters and inputs cast to ``dtype``."""

    def forward(self, x: Any, *args: Any) -> Any:
        inputs = (_cast(x, self.dtype), *_cast(args, self.dtype))
        params = {n: _cast(p, self.dtype) for n, p in self.layer.named_parameters()}
        if not params:
            return self.layer(*inputs)
        return torch.func.functional_call(self.layer, params, inputs)


class NormIn32(_Policy):
    """Runs its statistics layer on a float32 upcast of the input and
    returns ``dtype``."""

    def forward(self, x: Any) -> Any:
        return _cast(self.layer(_cast(x, torch.float32)), self.dtype)


def unwrap(layer: nn.Module) -> nn.Module:
    """The layer a policy wrapper runs (``layer`` itself otherwise)."""
    return layer.layer if isinstance(layer, _Policy) else layer


def _convert(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    if isinstance(module, _Policy):
        return module
    if isinstance(module, _NORM_TYPES):
        return NormIn32(module, dtype)
    children = list(module.named_children())
    if children and not list(module.parameters(recurse=False)):
        for name, child in children:
            new = _convert(child, dtype)
            if new is not child:
                setattr(module, name, new)
        return module
    return ComputeIn(module, dtype)


def apply_policy(
    layers: Sequence[nn.Module], compute_dtype: torch.dtype = torch.bfloat16
) -> List[nn.Module]:
    """The layers rewritten to compute in ``compute_dtype``.  Parameters
    keep their dtypes; only the math inside ``forward`` changes.  Passing
    ``torch.float32`` returns the layers unchanged.  Compound layers get
    their wrapped children in place; applying the policy again changes
    nothing."""
    if compute_dtype == torch.float32:
        return list(layers)
    return [_convert(layer, compute_dtype) for layer in layers]


# --------------------------------------------------------------------- #
# dynamic loss scaling                                                  #
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """The mixed-precision overflow protocol, as immutable state.

    Scale the loss up before the backward so small gradients survive a
    low-precision mantissa (:meth:`scale_loss`), divide the gradients
    back down before the optimizer (:meth:`unscale`), and adapt: halve
    on a non-finite step, which the caller skips (:meth:`bad`), double
    after ``growth_interval`` good steps in a row (:meth:`ok`).  With
    the port's ``GPipe``::

        ls = DynamicLossScale()
        loss, grads, aux = pipe.value_and_grad(
            x, y, lambda o, t: ls.scale_loss(loss_fn(o, t)))
        for g, u in zip(leaves(grads), leaves(ls.unscale(grads))):
            g.copy_(u)          # the optimizer reads .grad

    :meth:`state_dict` is JSON-serialisable and field for field the
    reference's, so a checkpoint resumes mid-protocol in either package.
    """

    scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    good_steps: int = 0

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * torch.tensor(self.scale, dtype=loss.dtype)

    def unscale(self, grads: Any) -> Any:
        """``grads`` (a tuple over stages of lists of ``{name: tensor}``,
        or any tree of tuples, lists and dicts) times ``1 / scale``, each
        floating leaf in its own dtype; other leaves unchanged."""
        inv = 1.0 / self.scale
        return _map(grads, lambda g: (g * inv).to(g.dtype)
                    if g.is_floating_point() or g.is_complex() else g)

    def ok(self) -> "DynamicLossScale":
        """One finite step observed: count it, grow on the interval."""
        good = self.good_steps + 1
        if good >= self.growth_interval:
            return dataclasses.replace(
                self,
                scale=min(self.scale * self.growth_factor, self.max_scale),
                good_steps=0,
            )
        return dataclasses.replace(self, good_steps=good)

    def bad(self) -> "DynamicLossScale":
        """One overflowed (skipped) step observed: back off, reset the
        streak."""
        return dataclasses.replace(
            self,
            scale=max(self.scale * self.backoff_factor, self.min_scale),
            good_steps=0,
        )

    def state_dict(self) -> dict:
        """JSON-serialisable state (checkpoint metadata)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "DynamicLossScale":
        return cls(**d)
