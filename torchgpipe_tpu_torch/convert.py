"""Load the reference's parameters into the port's modules.

The reference keeps a Llama's parameters as a flat per-layer list
``[embed, block_0 .. block_{n-1}, head]`` of dicts (what
``layers.sequential_init(llama(cfg), ...)`` and
``models.generation.mpmd_params_for_generation`` return).  Handed over as
numpy arrays, each leaf lands in the port parameter of the same name,
with the same ``[in, out]`` layout: nothing is transposed
(:func:`params_from_jax`).

A convolutional layer list (``models.resnet``) loads per layer params
*and* states (:func:`layers_from_jax`): a conv kernel turns from the
reference's HWIO into OIHW; BatchNorm ``scale``/``bias`` land in
parameters, ``mean``/``var`` (and a deferred BatchNorm's ``sum``,
``ssq``, ``count``, ``tracked``) in buffers; a LayerNorm's ``scale``/
``bias`` in parameters.  A layer wrapped by the mixed-precision policy
(:mod:`torchgpipe_tpu_torch.precision`) loads into the layer it wraps.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
from torchgpipe_tpu_torch.models.resnet import Residual
from torchgpipe_tpu_torch.ops.nn import BatchNorm, Conv2d, Dense, LayerNorm
from torchgpipe_tpu_torch.precision import unwrap
from torchgpipe_tpu_torch.skip import layer_name
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    Llama,
    TransformerConfig,
    not_ported,
)


def _to_tensor(arr: Any) -> torch.Tensor:
    """numpy array -> CPU tensor.  ``np.asarray`` of a JAX bfloat16 array
    is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
    refuses, so it travels as its uint16 bit pattern."""
    arr = np.array(arr, copy=True)  # writable: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def params_from_jax(
    cfg: TransformerConfig, params: Sequence[Mapping[str, Any]],
    device: Device = None,
) -> Llama:
    """The port's ``llama(cfg)`` holding the reference's parameters
    (numpy arrays, one dict per layer), on ``device`` (``cuda`` unless
    named)."""
    params = list(params)
    model = Llama(cfg, device=device)
    if len(params) != len(model):
        raise ValueError(
            f"expected {len(model)} per-layer param dicts (embed, "
            f"{cfg.n_layers} blocks, head), got {len(params)}"
        )
    for i, (layer, p) in enumerate(zip(model, params)):
        ours = layer.params()
        for key, leaf in p.items():
            if isinstance(leaf, Mapping) or not hasattr(leaf, "shape"):
                raise not_ported(
                    f"layer {i} param {key!r} (LoRA / MoE / int8 weights)",
                    "2" if key == "lora" else "5",
                )
        if set(p) != set(ours):
            raise ValueError(
                f"layer {i}: reference keys {sorted(p)} != port keys "
                f"{sorted(ours)}; do the two configs agree?"
            )
        for key, dst in ours.items():
            src = _to_tensor(p[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"layer {i} param {key!r}: shape {tuple(src.shape)} != "
                    f"{tuple(dst.shape)}"
                )
            dst.copy_(src.to(dst.dtype))
    return model


def _copy(dst: torch.Tensor, src: Any, what: str, transpose=None) -> None:
    t = _to_tensor(src)
    if transpose is not None:
        t = t.permute(*transpose)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def _keys(tree: Any) -> list:
    return sorted(tree) if isinstance(tree, Mapping) else []


def _load(module: nn.Module, p: Any, s: Any, what: str) -> None:
    module = unwrap(module)
    if isinstance(module, (Conv2d, Dense)):
        want = ["b", "w"] if module.b is not None else ["w"]
        if _keys(p) != want:
            raise ValueError(f"{what}: reference params {_keys(p)} != {want}")
        _copy(module.w, p["w"], f"{what} w",
              (3, 2, 0, 1) if isinstance(module, Conv2d) else None)
        if module.b is not None:
            _copy(module.b, p["b"], f"{what} b")
        return
    if isinstance(module, LayerNorm):
        if _keys(p) != ["bias", "scale"] or len(s):
            raise ValueError(
                f"{what}: reference params {_keys(p)} / state {_keys(s)} != "
                "['bias', 'scale'] / []"
            )
        _copy(module.scale, p["scale"], f"{what} scale")
        _copy(module.bias, p["bias"], f"{what} bias")
        return
    if isinstance(module, BatchNorm):
        buffers = dict(module.named_buffers())
        if _keys(p) != ["bias", "scale"] or _keys(s) != sorted(buffers):
            raise ValueError(
                f"{what}: reference params {_keys(p)} / state {_keys(s)} != "
                f"['bias', 'scale'] / {sorted(buffers)}; deferred_batch_norm "
                "on one side only?"
            )
        _copy(module.scale, p["scale"], f"{what} scale")
        _copy(module.bias, p["bias"], f"{what} bias")
        for key, buf in buffers.items():
            _copy(buf, s[key], f"{what} {key}")
        if isinstance(module, DeferredBatchNorm):
            module._tracked = int(module.tracked)
        return
    if isinstance(module, Residual) and module.down is not None:
        _load(module.down, p, s, what)
        return
    if isinstance(module, nn.Sequential):
        if len(p) != len(module):
            raise ValueError(f"{what}: {len(p)} reference children != {len(module)}")
        state = s if len(s) else ((),) * len(module)
        for k, (child, pc, sc) in enumerate(zip(module, p, state)):
            _load(child, pc, sc, f"{what}[{k}]")
        return
    if list(module.parameters()) or list(module.buffers()) or len(p) or len(s):
        raise ValueError(
            f"{what}: cannot load reference params {type(p).__name__} into "
            f"{type(module).__name__}"
        )


@torch.no_grad()
def layers_from_jax(
    layers: Sequence[nn.Module], params: Sequence[Any], states: Sequence[Any]
) -> Sequence[nn.Module]:
    """Load the reference's per-layer ``params`` and ``states`` (numpy
    leaves, one entry per layer, as ``layers.sequential_init`` returns
    them) into the port's layers of the same model (``models.resnet``;
    the layer list must be built, or converted to deferred BatchNorm,
    as the reference's was).  Returns ``layers``."""
    layers = list(layers)
    if not len(layers) == len(params) == len(states):
        raise ValueError(
            f"expected one reference entry per layer: {len(layers)} layers, "
            f"{len(params)} params, {len(states)} states"
        )
    for i, (layer, p, s) in enumerate(zip(layers, params, states)):
        _load(layer, p, s, f"layer {i} ({layer_name(layer)})")
    return layers
