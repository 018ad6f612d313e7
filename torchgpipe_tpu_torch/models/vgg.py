"""Sequential VGG (Simonyan & Zisserman) for the pipeline engines.

Counterpart of ``torchgpipe_tpu/models/vgg.py`` (``build_vgg``,
``vgg16``, ``vgg19``): configuration D (VGG-16) or E (VGG-19) as a flat
layer list of 3x3 convolutions (with BatchNorm by default), ReLUs and
2x2 max pools, then a classifier of two ``head_width`` dense layers,
each after a ReLU followed by dropout, and the class head.  No skips,
so any layer boundary may cut a stage.  Images are NCHW; a layer here
takes its input width at construction, so the classifier's first
width comes from ``image_size`` (224: 7 x 7 x 512 at base width 64).
Convolutions run through cuDNN; no hand-written kernel is on this path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.ops.nn import BatchNorm, Conv2d, Dense, Dropout, Flatten, MaxPool2d, ReLU

__all__ = ["build_vgg", "vgg16", "vgg19"]

_CFGS = {
    16: [1, 1, "M", 2, 2, "M", 4, 4, 4, "M", 8, 8, 8, "M", 8, 8, 8, "M"],
    19: [1, 1, "M", 2, 2, "M", 4, 4, 4, 4, "M", 8, 8, 8, 8, "M",
         8, 8, 8, 8, "M"],
}


def build_vgg(
    depth: int = 16,
    num_classes: int = 1000,
    base_width: int = 64,
    *,
    batch_norm: bool = True,
    head_width: int = 4096,
    dropout: float = 0.5,
    image_size: int = 224,
    in_channels: int = 3,
    device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> List[nn.Module]:
    """Flat sequential VGG-``depth`` layer list (depth 16 or 19) on
    ``device``, weights He-normal from ``generator``."""
    if depth not in _CFGS:
        raise ValueError(f"depth must be one of {sorted(_CFGS)}: {depth}")
    dev = resolve_device(device)
    kw: Dict[str, Any] = dict(device=dev, generator=generator)
    layers: List[nn.Module] = []
    ch, size = in_channels, image_size
    for item in _CFGS[depth]:
        if item == "M":
            layers.append(MaxPool2d((2, 2), strides=(2, 2), name="pool"))
            size //= 2
            continue
        layers.append(Conv2d(ch, base_width * item, (3, 3), padding="SAME",
                             name="conv", **kw))
        ch = base_width * item
        if batch_norm:
            layers.append(BatchNorm(ch, name="bn", device=dev))
        layers.append(ReLU())
    layers += [
        Flatten(),
        Dense(ch * size * size, head_width, name="fc1", **kw), ReLU(),
        Dropout(dropout),
        Dense(head_width, head_width, name="fc2", **kw), ReLU(),
        Dropout(dropout),
        Dense(head_width, num_classes, name="head", **kw),
    ]
    return layers


def vgg16(num_classes: int = 1000, **kwargs: Any) -> List[nn.Module]:
    return build_vgg(16, num_classes, **kwargs)


def vgg19(num_classes: int = 1000, **kwargs: Any) -> List[nn.Module]:
    return build_vgg(19, num_classes, **kwargs)
