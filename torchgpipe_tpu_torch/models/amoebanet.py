"""AmoebaNet-D as a flat sequential list of cell layers.

Counterpart of ``torchgpipe_tpu/models/amoebanet.py`` (the genotype
tables, ``_relu_conv_bn``, ``_factorized_reduce``, ``_make_op``,
``_cell``, ``_stem``, ``_classify``, ``amoebanetd``): the same layers,
children and parameter trees, so ``convert.layers_from_jax`` loads the
reference's weights and BatchNorm states.  A cell passes the tuple
``(x, skip)`` to the next (the first cell takes ``x``), which ``GPipe``
carries across a stage cut like any activation.

Differences of layout only: activations are NCHW (the reference's are
NHWC), so a cell concatenates its states on the channel axis 1, and a
convolution weight is OIHW.  Pools, paddings and the one-pixel shift of
``_factorized_reduce`` are the reference's: ``max_pool_3x3`` is a true
max pool (torchgpipe's original aliases it to an average), the 3x3
average pool divides by the real elements under the window
(``count_include_pad=False``), and the 1x7 / 7x1 convolutions pad only
their long axis.  No hand-written kernel: convolutions run through
cuDNN on ``channels_last`` memory (``ops.nn``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.ops.nn import AvgPool2d, BatchNorm, Conv2d, Dense, MaxPool2d, ReLU

__all__ = ["Structured", "amoebanetd"]

# (input state index, op) pairs, summed two by two into a new state
# (Real et al., arXiv:1802.01548; the TPU reference's normal_concat).
NORMAL_OPERATIONS = [
    (1, "conv_1x1"), (1, "max_pool_3x3"), (1, "none"), (0, "conv_1x7_7x1"),
    (0, "conv_1x1"), (0, "conv_1x7_7x1"), (2, "max_pool_3x3"), (2, "none"),
    (1, "avg_pool_3x3"), (5, "conv_1x1"),
]
NORMAL_CONCAT = [0, 3, 4, 6]

REDUCTION_OPERATIONS = [
    (0, "max_pool_2x2"), (0, "max_pool_3x3"), (2, "none"), (1, "conv_3x3"),
    (2, "conv_1x7_7x1"), (2, "max_pool_3x3"), (3, "none"), (1, "max_pool_2x2"),
    (2, "avg_pool_3x3"), (3, "conv_1x1"),
]
REDUCTION_CONCAT = [4, 5, 6]

_Kw = Dict[str, Any]


class Structured(nn.Module):
    """A compound layer: named children (the reference's ``structured``
    params and states are dicts keyed by these names) wired by
    :meth:`forward`."""

    def __init__(self, name: str, children: Dict[str, nn.Module]) -> None:
        super().__init__()
        self.name = name
        self.parts = nn.ModuleDict(children)


def _relu_conv_bn(in_ch: int, out_ch: int, kernel=(1, 1), stride=(1, 1),
                  padding=((0, 0), (0, 0)), *, name: str = "rcb",
                  kw: _Kw) -> nn.Sequential:
    seq = nn.Sequential(ReLU(), Conv2d(in_ch, out_ch, kernel, strides=stride,
                                       padding=padding, **kw),
                        BatchNorm(out_ch, device=kw["device"]))
    seq.name = name
    return seq


class FactorizedReduce(Structured):
    """Stride-2 reduce: two 1x1 stride-2 convolutions, the second over
    the input shifted one pixel down and right (zero-filled), their
    outputs concatenated, then BatchNorm."""

    def __init__(self, in_ch: int, out_ch: int, name: str = "fact_reduce", *,
                 kw: _Kw) -> None:
        half = out_ch // 2
        super().__init__(name, {
            "conv1": Conv2d(in_ch, half, (1, 1), strides=(2, 2), padding="VALID", **kw),
            "conv2": Conv2d(in_ch, out_ch - half, (1, 1), strides=(2, 2),
                            padding="VALID", **kw),
            "bn": BatchNorm(out_ch, device=kw["device"]),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        y1 = self.parts["conv1"](x)
        x2 = F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:]
        y2 = self.parts["conv2"](x2)
        return self.parts["bn"](torch.cat([y1, y2], dim=1))


def _make_op(kind: str, channels: int, stride: int, name: str, *, kw: _Kw) -> nn.Module:
    c, s = channels, (stride, stride)
    pad1 = ((1, 1), (1, 1))
    if kind == "none":
        return nn.Identity() if stride == 1 else FactorizedReduce(c, c, name, kw=kw)
    if kind == "avg_pool_3x3":
        return AvgPool2d((3, 3), s, padding=pad1, count_include_pad=False, name=name)
    if kind == "max_pool_3x3":
        return MaxPool2d((3, 3), s, padding=pad1, name=name)
    if kind == "max_pool_2x2":
        return MaxPool2d((2, 2), s, padding="VALID", name=name)
    if kind == "conv_1x1":
        return _relu_conv_bn(c, c, (1, 1), s, name=name, kw=kw)
    q = c // 4
    if kind == "conv_3x3":
        seq = nn.Sequential(_relu_conv_bn(c, q, kw=kw),
                            _relu_conv_bn(q, q, (3, 3), s, pad1, kw=kw),
                            _relu_conv_bn(q, c, kw=kw))
    elif kind == "conv_1x7_7x1":
        seq = nn.Sequential(
            _relu_conv_bn(c, q, kw=kw),
            _relu_conv_bn(q, q, (1, 7), (1, stride), ((0, 0), (3, 3)), kw=kw),
            _relu_conv_bn(q, q, (7, 1), (stride, 1), ((3, 3), (0, 0)), kw=kw),
            _relu_conv_bn(q, c, kw=kw))
    else:
        raise ValueError(f"unknown op kind {kind!r}")
    seq.name = name
    return seq


class Cell(Structured):
    """One NAS cell.  Input ``x`` (the first cell) or ``(x, skip)``;
    output ``(concat of the chosen states, this cell's x)``."""

    def __init__(self, channels_prev_prev: int, channels_prev: int, channels: int,
                 reduction: bool, reduction_prev: bool, name: str, *, kw: _Kw) -> None:
        ops, concat = ((REDUCTION_OPERATIONS, REDUCTION_CONCAT) if reduction
                       else (NORMAL_OPERATIONS, NORMAL_CONCAT))
        children: Dict[str, nn.Module] = {
            "reduce1": _relu_conv_bn(channels_prev, channels, name="reduce1", kw=kw)}
        if reduction_prev:
            children["reduce2"] = FactorizedReduce(channels_prev_prev, channels,
                                                   "reduce2", kw=kw)
        elif channels_prev_prev != channels:
            children["reduce2"] = _relu_conv_bn(channels_prev_prev, channels,
                                                name="reduce2", kw=kw)
        else:
            children["reduce2"] = nn.Identity()
        for k, (idx, kind) in enumerate(ops):
            # Ops reading the cell's inputs (states 0, 1) stride in a
            # reduction cell.
            stride = 2 if reduction and idx < 2 else 1
            children[f"op{k}"] = _make_op(kind, channels, stride, f"op{k}_{kind}", kw=kw)
        super().__init__(name, children)
        self.indices = [i for i, _ in ops]
        self.concat = concat

    def forward(self, x: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        s1, s2 = x if isinstance(x, tuple) else (x, x)
        skip = s1
        states = [self.parts["reduce1"](s1), self.parts["reduce2"](s2)]
        for k in range(0, len(self.indices), 2):
            h1 = self.parts[f"op{k}"](states[self.indices[k]])
            h2 = self.parts[f"op{k + 1}"](states[self.indices[k + 1]])
            states.append(h1 + h2)
        return torch.cat([states[i] for i in self.concat], dim=1), skip


class Classify(Structured):
    """Global average pool of ``x`` (the tuple's first) and a linear
    head ``fc``."""

    def __init__(self, channels: int, num_classes: int, *, kw: _Kw) -> None:
        super().__init__("classify", {"fc": Dense(channels, num_classes, name="fc", **kw)})

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return self.parts["fc"](x[0].mean(dim=(2, 3)))


def amoebanetd(
    num_classes: int = 10, num_layers: int = 4, num_filters: int = 512, *,
    device: Device = None, generator: Optional[torch.Generator] = None,
) -> List[nn.Module]:
    """AmoebaNet-D as a flat cell list: the stem, two reduction stem
    cells, three groups of ``num_layers / 3`` normal cells with a
    reduction cell between groups, then the classifier
    (``num_layers + 6`` layers; AmoebaNet-D (18, 256) is
    ``amoebanetd(1000, 18, 256)``, 24 layers).  Weights are drawn as the
    reference's init draws them, from ``generator``."""
    if num_layers % 3 != 0:
        raise ValueError("num_layers must be a multiple of 3")
    repeat_normal = num_layers // 3
    kw: _Kw = dict(device=resolve_device(device), generator=generator)
    channels = num_filters // 4
    state = {"cpp": channels, "cp": channels, "c": channels, "reduction_prev": False}

    def make_cell(reduction: bool, name: str) -> Cell:
        concat = REDUCTION_CONCAT if reduction else NORMAL_CONCAT
        cell = Cell(state["cpp"], state["cp"], state["c"], reduction,
                    state["reduction_prev"], name, kw=kw)
        state["cpp"] = state["cp"]
        state["cp"] = state["c"] * len(concat)
        state["reduction_prev"] = reduction
        return cell

    def reduction_cell(name: str) -> Cell:
        state["c"] *= 2
        return make_cell(True, name)

    def normal_cells(prefix: str) -> List[nn.Module]:
        return [make_cell(False, f"{prefix}_normal{i + 1}") for i in range(repeat_normal)]

    stem = nn.Sequential(
        Conv2d(3, channels, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)), **kw),
        BatchNorm(channels, device=kw["device"]))
    stem.name = "stem"
    layers: List[nn.Module] = [stem, reduction_cell("stem2"), reduction_cell("stem3")]
    layers += normal_cells("cell1")
    layers.append(reduction_cell("cell2_reduction"))
    layers += normal_cells("cell3")
    layers.append(reduction_cell("cell4_reduction"))
    layers += normal_cells("cell5")
    layers.append(Classify(state["cp"], num_classes, kw=kw))
    return layers
