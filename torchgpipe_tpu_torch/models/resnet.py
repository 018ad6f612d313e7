"""ResNet as a flat sequential layer list with skip-connection residuals.

Counterpart of ``torchgpipe_tpu/models/resnet.py`` (``build_resnet``,
``bottleneck``, ``_residual``, ``resnet101``, ``resnet50``): the same
layers, names and length.  Every bottleneck block is 11 flat layers whose
identity travels through the skip subsystem under a per-block
:class:`~torchgpipe_tpu_torch.skip.Namespace`, so a stage boundary may
cut inside a block and the pipeline sends the identity across stages.

Images are NCHW at the API (the reference is NHWC); on the card the
convolutions keep ``channels_last`` memory.  Weights are drawn as the
reference's init draws them (He-normal convolutions and classifier,
unit BatchNorm scales, zero biases), from ``generator``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.ops.nn import (
    BatchNorm,
    Conv2d,
    Dense,
    GlobalAvgPool,
    MaxPool2d,
    ReLU,
)
from torchgpipe_tpu_torch.skip import Namespace, SkipSequential, skip_key, stash

__all__ = ["Residual", "bottleneck", "build_resnet", "resnet101", "resnet50"]


class Residual(nn.Module):
    """Pop the stashed identity, optionally project it (``down``: a
    strided 1x1 convolution and a BatchNorm, the reference's compound
    downsample), and add it to the input."""

    def __init__(self, ns: Namespace, down: Optional[nn.Sequential],
                 name: str = "residual") -> None:
        super().__init__()
        self.name = name
        self.key = skip_key(ns, "identity")
        self.stash: Tuple = ()
        self.pop = (self.key,)
        self.down = down

    def forward(self, x: torch.Tensor, pops: Dict) -> Tuple[torch.Tensor, Dict]:
        ident = pops[self.key]
        if self.down is not None:
            ident = self.down(ident)
        return x + ident, {}


def bottleneck(
    inplanes: int,
    planes: int,
    stride: int = 1,
    downsample: Optional[nn.Sequential] = None,
    name: str = "block",
    *,
    device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> List[nn.Module]:
    """One bottleneck block as 11 flat layers."""
    ns = Namespace()
    kw: Dict[str, Any] = dict(device=device, generator=generator)
    pad1 = ((1, 1), (1, 1))
    return [
        stash("identity", ns=ns, name=f"{name}_identity"),
        Conv2d(inplanes, planes, (1, 1), name=f"{name}_conv1", **kw),
        BatchNorm(planes, name=f"{name}_bn1", device=device),
        ReLU(f"{name}_relu1"),
        Conv2d(planes, planes, (3, 3), strides=(stride, stride), padding=pad1,
               name=f"{name}_conv2", **kw),
        BatchNorm(planes, name=f"{name}_bn2", device=device),
        ReLU(f"{name}_relu2"),
        Conv2d(planes, planes * 4, (1, 1), name=f"{name}_conv3", **kw),
        BatchNorm(planes * 4, name=f"{name}_bn3", device=device),
        Residual(ns, downsample, name=f"{name}_residual"),
        ReLU(f"{name}_relu3"),
    ]


def build_resnet(
    blocks: List[int],
    num_classes: int = 1000,
    base_width: int = 64,
    *,
    device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> SkipSequential:
    """A ResNet as one flat sequential layer list (``base_width`` scales
    the whole network down for tests; the reference's is 64).  Returns a
    :class:`~torchgpipe_tpu_torch.skip.SkipSequential`: called, it is the
    unpipelined model; ``list(...)`` of it is what ``GPipe`` takes."""
    device = resolve_device(device)
    kw: Dict[str, Any] = dict(device=device, generator=generator)
    inplanes = base_width

    def make_group(planes: int, n: int, stride: int, gname: str) -> List[nn.Module]:
        nonlocal inplanes
        downsample = None
        if stride != 1 or inplanes != planes * 4:
            downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, (1, 1), strides=(stride, stride),
                       name="conv", **kw),
                BatchNorm(planes * 4, name="bn", device=device),
            )
        out = bottleneck(inplanes, planes, stride, downsample, f"{gname}_b1", **kw)
        inplanes = planes * 4
        for i in range(1, n):
            out += bottleneck(inplanes, planes, name=f"{gname}_b{i + 1}", **kw)
        return out

    w = base_width
    layers: List[nn.Module] = [
        Conv2d(3, w, (7, 7), strides=(2, 2), padding=((3, 3), (3, 3)),
               name="conv1", **kw),
        BatchNorm(w, name="bn1", device=device),
        ReLU("relu"),
        MaxPool2d((3, 3), (2, 2), padding=((1, 1), (1, 1)), name="maxpool"),
    ]
    layers += make_group(w, blocks[0], 1, "layer1")
    layers += make_group(w * 2, blocks[1], 2, "layer2")
    layers += make_group(w * 4, blocks[2], 2, "layer3")
    layers += make_group(w * 8, blocks[3], 2, "layer4")
    layers += [
        GlobalAvgPool("avgpool"),
        Dense(w * 8 * 4, num_classes, name="fc", **kw),
    ]
    return SkipSequential(*layers)


def resnet101(num_classes: int = 1000, **kwargs: Any) -> SkipSequential:
    """Sequential ResNet-101 (blocks 3, 4, 23, 3)."""
    return build_resnet([3, 4, 23, 3], num_classes, **kwargs)


def resnet50(num_classes: int = 1000, **kwargs: Any) -> SkipSequential:
    """Sequential ResNet-50 (blocks 3, 4, 6, 3)."""
    return build_resnet([3, 4, 6, 3], num_classes, **kwargs)
