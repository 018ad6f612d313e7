"""Simplified U-Net as a flat sequential layer list with long skips.

Counterpart of ``torchgpipe_tpu/models/unet.py`` (``unet``): ``depth``
encoder levels of ``num_convs`` conv blocks (3x3 convolution, spatial
dropout 0.1, instance norm, leaky ReLU) each stash their feature map
under a per-level :class:`~torchgpipe_tpu_torch.skip.Namespace` and
halve the resolution; the mirrored decoder levels upsample, pop and
concatenate the stash, and convolve; a 1x1 convolution segments.  A
stash and its pop may land on different stages: the pipeline sends the
skip straight from one to the other.  The same layers, order and
channel widths as the reference; images are NCHW (the reference is
NHWC), so concatenation is on axis 1.  Convolutions run through cuDNN;
no hand-written kernel is on this path.  The dropouts draw from the
pipeline's per-layer keys (``GPipe(...).value_and_grad(..., rng=)``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.ops.nn import (
    Conv2d,
    Dropout2d,
    InstanceNorm,
    LeakyReLU,
    MaxPool2d,
    Upsample2d,
)
from torchgpipe_tpu_torch.skip import Namespace, SkipSequential, skippable, stash

__all__ = ["unet"]


def _conv_block(in_ch: int, out_ch: int, name: str, kw: Dict[str, Any]) -> List[nn.Module]:
    """conv -> spatial dropout -> instance norm -> leaky relu."""
    return [
        Conv2d(in_ch, out_ch, (3, 3), padding=((1, 1), (1, 1)), name=f"{name}_conv", **kw),
        Dropout2d(0.1, name=f"{name}_dropout"),
        InstanceNorm(name=f"{name}_norm"),
        LeakyReLU(0.01, name=f"{name}_relu"),
    ]


def _stacked_convs(in_ch: int, mid_ch: int, out_ch: int, num_convs: int, name: str,
                   kw: Dict[str, Any]) -> List[nn.Module]:
    if num_convs <= 0:
        return []
    if num_convs == 1:
        return _conv_block(in_ch, out_ch, f"{name}_c1", kw)
    out = _conv_block(in_ch, mid_ch, f"{name}_c1", kw)
    for i in range(num_convs - 2):
        out += _conv_block(mid_ch, mid_ch, f"{name}_c{i + 2}", kw)
    out += _conv_block(mid_ch, out_ch, f"{name}_c{num_convs}", kw)
    return out


def _pop_cat(ns: Namespace, name: str) -> nn.Module:
    """Pop the stashed encoder map, zero-pad the decoder input up to its
    spatial size if needed, and concatenate on channels."""

    def fn(x, pops):
        skip = pops["skip"]
        if x.shape[2:] != skip.shape[2:]:
            x = F.pad(x, (0, skip.shape[3] - x.shape[3], 0, skip.shape[2] - x.shape[2]))
        return torch.cat([x, skip], dim=1), {}

    return skippable(fn, pop=["skip"], ns=ns, name=name)


def unet(
    depth: int = 5,
    num_convs: int = 5,
    base_channels: int = 64,
    input_channels: int = 3,
    output_channels: int = 1,
    *,
    device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> SkipSequential:
    """The simplified U-Net on ``device`` (``cuda`` unless named), its
    convolutions He-normal from ``generator``.  Called, the returned
    :class:`~torchgpipe_tpu_torch.skip.SkipSequential` is the
    unpipelined model; ``list(...)`` of it is what ``GPipe`` takes."""
    kw: Dict[str, Any] = dict(device=resolve_device(device), generator=generator)
    namespaces = [Namespace() for _ in range(depth)]
    layers: List[nn.Module] = []
    ch = input_channels

    def convs(mid: int, out: int, name: str) -> None:
        nonlocal ch
        layers.extend(_stacked_convs(ch, mid, out, num_convs, name, kw))
        if num_convs > 0:
            ch = out

    enc_ch = []
    for i in range(depth):
        convs(base_channels * (2 ** i), base_channels * (2 ** i), f"enc{i}")
        enc_ch.append(ch)
        layers.append(stash("skip", ns=namespaces[i], name=f"enc{i}_skip"))
        layers.append(MaxPool2d((2, 2), (2, 2), name=f"enc{i}_down"))
    convs(base_channels * (2 ** depth), base_channels * (2 ** (depth - 1)), "bottleneck")
    for i in reversed(range(depth)):
        mid = int(base_channels * (2 ** (i - 1)))
        layers.append(Upsample2d(2, name=f"dec{i}_up"))
        layers.append(_pop_cat(namespaces[i], f"dec{i}_skip"))
        ch += enc_ch[i]
        convs(mid, mid, f"dec{i}")
    layers.append(Conv2d(ch, output_channels, (1, 1), name="segment", **kw))
    return SkipSequential(*layers)
