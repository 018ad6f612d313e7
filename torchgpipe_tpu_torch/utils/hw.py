"""The card's published peak rate, for MFU.

Counterpart of ``torchgpipe_tpu/utils/hw.py``, with the port's own table:
the dense bfloat16 tensor-core rate of NVIDIA cards by the name
``torch.cuda.get_device_name`` reports (the reference matches TPU
``device_kind`` strings; none of its rows applies here).  An unknown
card, the CPU or the meta device gives ``None``, so MFU is omitted,
never faked.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# Dense (no sparsity) bf16 FLOP/s per card, keyed by a substring of the
# device name, checked in order (the more specific names first).
PEAK_BF16_FLOPS = (
    ("H100 80GB HBM3", 989e12),   # H100 SXM5
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H200", 989e12),
    ("A100", 312e12),
)


def peak_bf16_flops_for_name(name: str) -> Optional[float]:
    """The table's rate for a device name, or None."""
    for key, peak in PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def chip_peak_bf16_flops(device: Any = None) -> Optional[float]:
    """Published dense bf16 peak FLOP/s of ``device`` (a CUDA device,
    its index, or None for the current one), or None when it is not a
    CUDA device, no card is present, or the card is not in the table."""
    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    return peak_bf16_flops_for_name(torch.cuda.get_device_name(device))


__all__ = ["PEAK_BF16_FLOPS", "chip_peak_bf16_flops", "peak_bf16_flops_for_name"]
