"""Per-layer cost profiling for automatic balancing.

Counterpart of ``torchgpipe_tpu/balance/profile.py``
(``profile_times``, ``profile_sizes``).  Like the reference's torch
ancestor, each layer runs in a sandbox, a deep copy, so profiling
updates no running statistic of the caller's model.  Each layer takes
one forward and one backward with unit cotangents on its output and its
stashes, its input threaded from the previous layer's output (skips
included), as the reference's ``_layer_fwd_bwd`` does.

* time: on the card each layer's forward+backward is timed with CUDA
  events (device time), on the CPU with the host clock; one warm-up
  sweep is excluded, then sweeps run until ``timeout`` seconds pass.
* memory: on the card the allocator's peak over the layer's
  forward+backward above what was allocated before it, plus
  ``param_scale`` times its parameter bytes.  On the CPU, which keeps no
  allocator counters, the reference's coarse fallback,
  ``2 bytes(output) + bytes(stashes)``, with its warning.
"""

from __future__ import annotations

import copy
import time
import warnings
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.skip import apply_layer, call_layer, layer_name


def _leaf(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    return x.requires_grad_() if x.is_floating_point() else x


def layer_fwd_bwd(
    layer: nn.Module, x: torch.Tensor, pops: Dict
) -> Tuple[torch.Tensor, Dict]:
    """One forward and one backward (unit cotangents on the output and
    the stashes) of ``layer`` in train mode; returns the detached output
    and stashes.  Gradients land in ``layer``'s own ``.grad``."""
    x = _leaf(x)
    pops = {k: _leaf(v) for k, v in pops.items()}
    with torch.enable_grad():
        y, stashed = call_layer(layer, x, pops)
        outs = [t for t in (y, *stashed.values()) if t.requires_grad]
        if outs:
            torch.autograd.backward(outs, [torch.ones_like(t) for t in outs])
    return y.detach(), {k: v.detach() for k, v in stashed.items()}


def sandbox(layer: nn.Module, device: torch.device) -> nn.Module:
    """A deep copy of ``layer`` on ``device``, in train mode."""
    return copy.deepcopy(layer).to(device).train()


def meta_sandbox(layer: nn.Module) -> nn.Module:
    """A copy of ``layer`` whose parameters and buffers are meta tensors
    (shapes only, no memory), in train mode."""
    memo: Dict[int, Any] = {}
    for t in layer.parameters():
        memo[id(t)] = nn.Parameter(torch.empty_like(t, device="meta"),
                                   requires_grad=t.requires_grad)
    for t in layer.buffers():
        memo[id(t)] = torch.empty_like(t, device="meta")
    return copy.deepcopy(layer, memo).train()


def sweep(
    layers: Sequence[nn.Module],
    sample: torch.Tensor,
    make: Callable[[nn.Module], nn.Module],
    visit: Callable[[int, nn.Module, torch.Tensor, Dict], Tuple[torch.Tensor, Dict]],
) -> None:
    """Thread ``sample`` through the layers: for each, ``visit(i,
    make(layer), x, pops)`` returns its output and stashes."""
    skips: Dict = {}
    x = sample
    for i, layer in enumerate(layers):
        x = apply_layer(make(layer), x, skips,
                        lambda layer, x, pops, i=i: visit(i, layer, x, pops))


def profile_times(
    layers: Sequence[nn.Module],
    sample: torch.Tensor,
    *,
    timeout: float = 1.0,
    device: Device = None,
) -> List[float]:
    """Per-layer forward+backward time in seconds, summed over sweeps."""
    device = resolve_device(device)
    sample = sample.to(device)
    cuda = device.type == "cuda"
    times = [0.0] * len(layers)

    def timed(i, layer, x, pops):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = layer_fwd_bwd(layer, x, pops)
            end.record()
            events.append((i, start, end))
        else:
            t0 = time.perf_counter()
            out = layer_fwd_bwd(layer, x, pops)
            times[i] += time.perf_counter() - t0
        return out

    def make(layer):
        return sandbox(layer, device)

    sweep(layers, sample, make, lambda i, l, x, p: layer_fwd_bwd(l, x, p))  # warm-up
    begin = time.perf_counter()
    while True:
        events: List = []
        sweep(layers, sample, make, timed)
        for i, start, end in events:
            end.synchronize()
            times[i] += start.elapsed_time(end) * 1e-3
        if time.perf_counter() - begin >= timeout:
            return times


def _bytes(tensors: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_sizes(
    layers: Sequence[nn.Module],
    sample: torch.Tensor,
    *,
    param_scale: float = 2.0,
    device: Device = None,
) -> List[int]:
    """Per-layer memory cost in bytes: ``param_scale`` (optimizer
    head-room: SGD ~2-3, Adam ~4-5) times the parameter bytes, plus the
    forward+backward's activation bytes."""
    device = resolve_device(device)
    sample = sample.to(device)
    cuda = device.type == "cuda"
    sizes: List[int] = []

    def sized(i, layer, x, pops):
        params = _bytes(layer.parameters())
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            y, stashed = layer_fwd_bwd(layer, x, pops)
            torch.cuda.synchronize(device)
            act = torch.cuda.max_memory_allocated(device) - before
        else:
            y, stashed = layer_fwd_bwd(layer, x, pops)
            act = 2 * _bytes([y]) + _bytes(stashed.values())
        sizes.append(int(param_scale * params) + act)
        return y, stashed

    sweep(layers, sample, lambda layer: sandbox(layer, device), sized)
    if not cuda:
        names = [layer_name(layer) for layer in layers]
        warnings.warn(
            f"no allocator statistics on {device.type} for {len(layers)}/"
            f"{len(layers)} layers ({', '.join(names[:5])}"
            f"{', ...' if len(names) > 5 else ''}): their sizes use coarse "
            "output-shape accounting that ignores intra-layer temporaries — "
            "balance_by_size partitions from these costs may understate "
            "memory-hungry layers",
            stacklevel=2,
        )
    return sizes
