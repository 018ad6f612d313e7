"""The reference's layer library, as ``nn.Module``s, for the convolutional
models.

Counterpart of the parts of ``torchgpipe_tpu/ops/nn.py`` that ResNet
uses: ``dense`` (:34), ``conv2d`` (:55), ``batch_norm`` (:101), ``relu``
(:183), ``max_pool2d`` (:207), ``global_avg_pool`` (:296) and ``flatten``
(:300).  Parameter names are the reference's keys (``w``, ``b``;
``scale``, ``bias``; buffers ``mean``, ``var``).  Images are NCHW at the
API, torch's own convolution layout (the reference is NHWC); a conv
weight is OIHW (the reference's HWIO, transposed by ``convert``), a
dense weight ``[in, out]`` as in the reference.  On the card
convolutions run through cuDNN on ``channels_last`` memory, as the
reference's run through ``lax.conv_general_dilated``: no Pallas kernel
is involved on either side.

The reference infers input widths at ``init``; a module here takes them
at construction.  Each layer carries the reference's ``name``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.checkpoint import is_recomputing
from torchgpipe_tpu_torch.models.transformer import Device, resolve_device

__all__ = [
    "BatchNorm", "Conv2d", "Dense", "Flatten", "GlobalAvgPool", "MaxPool2d",
    "ReLU", "batch_norm", "conv2d", "dense", "flatten", "global_avg_pool",
    "max_pool2d", "relu",
]

Pad = Any  # 'SAME' | 'VALID' | ((lo, hi), (lo, hi))


def _pair(v: Any) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _kaiming(
    shape: Tuple[int, ...], fan_in: int, device: torch.device,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """``sqrt(2 / fan_in) * N(0, 1)``, the reference's ``_kaiming``."""
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x * (2.0 / fan_in) ** 0.5


def _explicit_pad(
    padding: Pad, size: Tuple[int, int], window: Tuple[int, int],
    strides: Tuple[int, int],
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((lo, hi), (lo, hi))`` for the spatial dims, as XLA resolves
    ``'SAME'`` (extra pad on the high side) and ``'VALID'``."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        out = []
        for n, k, s in zip(size, window, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple(tuple(p) for p in padding)


def _pad_args(x: torch.Tensor, pads):
    """``(x, symmetric padding)``: an asymmetric pad is applied to ``x``
    here, a symmetric one is left to the op."""
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh)), (0, 0)


class Dense(nn.Module):
    """``y = x @ w + b`` over the trailing dim (``w: [in, out]``)."""

    def __init__(
        self, in_features: int, features: int, *, use_bias: bool = True,
        name: str = "dense", device: Device = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.name = name
        dev = resolve_device(device)
        self.w = nn.Parameter(
            _kaiming((in_features, features), in_features, dev, generator)
        )
        self.b = (
            nn.Parameter(torch.zeros(features, device=dev)) if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class Conv2d(nn.Module):
    """2-D convolution over NCHW activations with an OIHW weight ``w``."""

    def __init__(
        self, in_channels: int, features: int,
        kernel_size: Any = (3, 3), *, strides: Any = (1, 1), padding: Pad = "SAME",
        use_bias: bool = False, name: str = "conv", device: Device = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.name = name
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        dev = resolve_device(device)
        kh, kw = self.kernel_size
        w = _kaiming((features, in_channels, kh, kw), kh * kw * in_channels, dev,
                     generator)
        if dev.type == "cuda":
            w = w.contiguous(memory_format=torch.channels_last)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(features, device=dev)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        pads = _explicit_pad(self.padding, x.shape[2:], self.kernel_size, self.strides)
        x, pad = _pad_args(x, pads)
        return F.conv2d(x, self.w, self.b, self.strides, pad)


class BatchNorm(nn.Module):
    """BatchNorm over all but the channel axis (1): normalises with the
    micro-batch's own biased statistics in training and with the running
    ones otherwise.  ``momentum`` is the share of the running statistics
    *kept* (the reference's 0.9; ``nn.BatchNorm2d``'s 0.1 is the share
    taken), and the running variance is the biased one, as ``jnp.var``
    gives it.  A recomputed pipeline cell updates nothing
    (``is_recomputing()``): its forward already did.  See
    :mod:`torchgpipe_tpu_torch.batchnorm` for the deferred variant."""

    def __init__(
        self, channels: int, *, momentum: float = 0.9, eps: float = 1e-5,
        name: str = "bn", device: Device = None,
    ) -> None:
        super().__init__()
        self.name = name
        self.momentum = momentum
        self.eps = eps
        dev = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(channels, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev))
        self.register_buffer("mean", torch.zeros(channels, device=dev))
        self.register_buffer("var", torch.ones(channels, device=dev))

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, self.eps)
        return F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._normalize(x)
        if self.training and not is_recomputing():
            with torch.no_grad():
                var, mean = batch_stats(x)
                keep = self.momentum
                self.mean.mul_(keep).add_(mean, alpha=1 - keep)
                self.var.mul_(keep).add_(var, alpha=1 - keep)
        return y


def reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    """Every axis but the channel axis (1)."""
    return (0,) + tuple(range(2, x.ndim))


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(var, mean)`` per channel, the variance biased (``jnp.var``)."""
    return torch.var_mean(x.detach(), dim=reduce_dims(x), correction=0)


class ReLU(nn.Module):
    def __init__(self, name: str = "relu") -> None:
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class MaxPool2d(nn.Module):
    """Max pooling over NCHW; the pad counts as ``-inf``, as the
    reference's ``reduce_window`` pads."""

    def __init__(
        self, window: Any = (2, 2), strides: Any = None, *, padding: Pad = "VALID",
        name: str = "maxpool",
    ) -> None:
        super().__init__()
        self.name = name
        self.window = _pair(window)
        self.strides = _pair(strides) if strides is not None else self.window
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _explicit_pad(self.padding, x.shape[2:], self.window, self.strides)
        (hl, hh), (wl, wh) = pads
        # torch pads symmetrically and at most half the window.
        if hl == hh and wl == wh and 2 * hl <= self.window[0] and 2 * wl <= self.window[1]:
            return F.max_pool2d(x, self.window, self.strides, (hl, wl))
        x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
        return F.max_pool2d(x, self.window, self.strides)


class GlobalAvgPool(nn.Module):
    """Mean over the spatial axes: ``[N, C, H, W] -> [N, C]``."""

    def __init__(self, name: str = "gap") -> None:
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class Flatten(nn.Module):
    """``[N, ...] -> [N, -1]``.  A 4-D NCHW input is flattened in the
    reference's NHWC element order, so a dense layer after it takes the
    reference's weights unchanged."""

    def __init__(self, name: str = "flatten") -> None:
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


# The reference's factory names.
dense = Dense
conv2d = Conv2d
batch_norm = BatchNorm
relu = ReLU
max_pool2d = MaxPool2d
global_avg_pool = GlobalAvgPool
flatten = Flatten
