"""The reference's layer library, as ``nn.Module``s, for the convolutional
models.

Counterpart of ``torchgpipe_tpu/ops/nn.py``: ``dense`` (:34),
``conv2d`` (:55), ``batch_norm`` (:101), ``layer_norm`` (:143),
``dropout`` (:162), ``relu`` (:183), ``gelu`` (:187), ``max_pool2d``
(:207), ``avg_pool2d`` (:225), ``instance_norm`` (:247),
``leaky_relu`` (:263), ``dropout2d`` (:267), ``upsample2d`` (:287),
``global_avg_pool`` (:296) and ``flatten`` (:300).  Parameter names are
the reference's keys (``w``, ``b``; ``scale``, ``bias``; buffers
``mean``, ``var``).  Images are NCHW at the
API, torch's own convolution layout (the reference is NHWC); a conv
weight is OIHW (the reference's HWIO, transposed by ``convert``), a
dense weight ``[in, out]`` as in the reference.  On the card
convolutions run through cuDNN on ``channels_last`` memory, as the
reference's run through ``lax.conv_general_dilated``: no Pallas kernel
is involved on either side.

The reference infers input widths at ``init``; a module here takes them
at construction.  Each layer carries the reference's ``name``.

The reference's dropouts draw from the per-micro-batch key the engine
hands them; here :class:`Dropout` and :class:`Dropout2d` draw from the
``torch.Generator`` they are built with (on the activations' device),
so their masks are not the reference's bits.  A pipeline refuses them
where a cell would recompute its forward (ROADMAP.md queue A item 2).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.checkpoint import is_recomputing
from torchgpipe_tpu_torch.models.transformer import Device, resolve_device

__all__ = [
    "AvgPool2d", "BatchNorm", "Conv2d", "Dense", "Dropout", "Dropout2d",
    "Flatten", "GELU", "GlobalAvgPool", "InstanceNorm", "LayerNorm",
    "LeakyReLU", "MaxPool2d", "ReLU", "Upsample2d", "avg_pool2d",
    "batch_norm", "conv2d", "dense", "dropout", "dropout2d", "flatten",
    "gelu", "global_avg_pool", "instance_norm", "layer_norm", "leaky_relu",
    "max_pool2d", "relu", "upsample2d",
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


class AvgPool2d(nn.Module):
    """Average pooling over NCHW.  The pad adds zeros to the window's
    sum; the sum is divided by the window's area, or, with
    ``count_include_pad=False`` and a padding other than ``'VALID'``, by
    the number of real elements under the window, as the reference's
    ``reduce_window`` counts them."""

    def __init__(
        self, window: Any = (2, 2), strides: Any = None, *, padding: Pad = "VALID",
        count_include_pad: bool = True, name: str = "avgpool",
    ) -> None:
        super().__init__()
        self.name = name
        self.window = _pair(window)
        self.strides = _pair(strides) if strides is not None else self.window
        self.padding = padding
        self.count_include_pad = count_include_pad

    def _sum(self, x: torch.Tensor, pads) -> torch.Tensor:
        (hl, hh), (wl, wh) = pads
        x = F.pad(x, (wl, wh, hl, hh))
        return F.avg_pool2d(x, self.window, self.strides, divisor_override=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _explicit_pad(self.padding, x.shape[2:], self.window, self.strides)
        summed = self._sum(x, pads)
        if self.count_include_pad or self.padding == "VALID":
            return summed / (self.window[0] * self.window[1])
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        return summed / self._sum(ones, pads)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing dim: ``(x - mean) * rsqrt(var + eps)
    * scale + bias`` with the biased variance (``jnp.var``)."""

    def __init__(
        self, features: int, *, eps: float = 1e-6, name: str = "ln",
        device: Device = None,
    ) -> None:
        super().__init__()
        self.name = name
        self.eps = eps
        dev = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class InstanceNorm(nn.Module):
    """InstanceNorm over the spatial axes, per sample and channel, with
    no affine parameters and no running statistics (torch's
    ``InstanceNorm2d`` defaults)."""

    def __init__(self, *, eps: float = 1e-5, name: str = "in") -> None:
        super().__init__()
        self.name = name
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(2, x.ndim))
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps)


class GELU(nn.Module):
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""

    def __init__(self, name: str = "gelu") -> None:
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh")


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01, *, name: str = "leaky_relu") -> None:
        super().__init__()
        self.name = name
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)


class Dropout(nn.Module):
    """Inverted dropout: in training, each element is kept with
    probability ``1 - rate`` (drawn from ``generator``) and scaled by
    ``1 / (1 - rate)``.  In eval mode, or at rate 0, the identity."""

    def __init__(
        self, rate: float, *, generator: Optional[torch.Generator] = None,
        name: str = "dropout",
    ) -> None:
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.name = name
        self.rate = rate
        self.generator = generator

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError(f"{self.name} needs a torch.Generator in train mode")
        keep = torch.empty(self._mask_shape(x), device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.generator).bool()
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class Dropout2d(Dropout):
    """Spatial dropout: zeroes whole feature maps, one draw per sample
    and channel of an NCHW input."""

    def __init__(
        self, rate: float, *, generator: Optional[torch.Generator] = None,
        name: str = "dropout2d",
    ) -> None:
        super().__init__(rate, generator=generator, name=name)

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape[:2]) + (1,) * (x.ndim - 2)


class Upsample2d(nn.Module):
    """Nearest-neighbour upsampling of the spatial axes by an integer
    ``scale``."""

    def __init__(self, scale: int = 2, *, name: str = "upsample") -> None:
        super().__init__()
        self.name = name
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(self.scale, dim=2)
        return x.repeat_interleave(self.scale, dim=3)


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
layer_norm = LayerNorm
dropout = Dropout
relu = ReLU
gelu = GELU
max_pool2d = MaxPool2d
avg_pool2d = AvgPool2d
instance_norm = InstanceNorm
leaky_relu = LeakyReLU
dropout2d = Dropout2d
upsample2d = Upsample2d
global_avg_pool = GlobalAvgPool
flatten = Flatten
