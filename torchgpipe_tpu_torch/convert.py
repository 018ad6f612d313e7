"""Load the reference's parameters into the port's modules.

The reference keeps a Llama's parameters as a flat per-layer list
``[embed, block_0 .. block_{n-1}, head]`` of dicts (what
``layers.sequential_init(llama(cfg), ...)`` and
``models.generation.mpmd_params_for_generation`` return).  Handed over as
numpy arrays, each leaf lands in the port parameter of the same name,
with the same ``[in, out]`` layout: nothing is transposed.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

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
