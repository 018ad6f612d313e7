"""Deferred BatchNorm: mini-batch-faithful running statistics under
micro-batching.

Counterpart of ``torchgpipe_tpu/batchnorm.py``.  Plain BatchNorm inside
a pipeline updates its running statistics once per *micro*-batch;
:class:`DeferredBatchNorm` normalises each micro-batch with its own
statistics, as plain BatchNorm does, but adds the per-channel sum and
sum of squares over the ``chunks`` micro-batches of a mini-batch and
commits the running statistics once, from the whole mini-batch:
``mean = sum / count``, ``var = ssq / count - mean^2`` (biased), each
kept with ``momentum`` (the share kept, 0.9).

The accumulators are buffers (``sum``, ``ssq``, ``count``, ``tracked``)
updated in place.  The commit is decided from a host copy of
``tracked``, so deciding reads nothing back from the device.  A
recomputed pipeline cell (``is_recomputing()``) tracks nothing: its
checkpointed forward already did.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
from torch import nn

from torchgpipe_tpu_torch.checkpoint import is_recomputing
from torchgpipe_tpu_torch.ops.nn import BatchNorm, reduce_dims


class DeferredBatchNorm(BatchNorm):
    """BatchNorm whose running statistics reflect whole mini-batches of
    ``chunks`` micro-batches (the pipeline's ``chunks``)."""

    def __init__(
        self, channels: int, chunks: int, *, momentum: float = 0.9,
        eps: float = 1e-5, name: str = "deferred_bn", device: Any = None,
    ) -> None:
        super().__init__(channels, momentum=momentum, eps=eps, name=name,
                         device=device)
        self.chunks = chunks
        dev = self.mean.device
        self.register_buffer("sum", torch.zeros(channels, device=dev))
        self.register_buffer("ssq", torch.zeros(channels, device=dev))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32, device=dev))
        self.register_buffer("tracked", torch.zeros((), dtype=torch.int32, device=dev))
        self._tracked = 0   # host copy of `tracked`

    @classmethod
    def from_batch_norm(cls, bn: BatchNorm, chunks: int) -> "DeferredBatchNorm":
        """The deferred twin of ``bn``: the same ``scale``/``bias``
        parameters (shared) and a copy of its running statistics."""
        out = cls(bn.scale.numel(), chunks, momentum=bn.momentum, eps=bn.eps,
                  name=bn.name, device=bn.mean.device)
        out.scale, out.bias = bn.scale, bn.bias
        with torch.no_grad():
            out.mean.copy_(bn.mean)
            out.var.copy_(bn.var)
        out.train(bn.training)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._normalize(x)
        if self.training and not is_recomputing():
            with torch.no_grad():
                self._track(x.detach())
        return y

    def _track(self, x: torch.Tensor) -> None:
        dims = reduce_dims(x)
        self.sum.add_(x.sum(dims))
        self.ssq.add_((x * x).sum(dims))
        self.count.add_(x.numel() // x.shape[1])
        self.tracked.add_(1)
        self._tracked += 1
        if self._tracked >= self.chunks:
            self._commit(x.dtype)

    def _commit(self, dtype: torch.dtype) -> None:
        cnt = self.count.to(dtype)
        mean = self.sum / cnt
        var = self.ssq / cnt - mean * mean
        keep = self.momentum
        self.mean.mul_(keep).add_(mean, alpha=1 - keep)
        self.var.mul_(keep).add_(var, alpha=1 - keep)
        for buf in (self.sum, self.ssq, self.count, self.tracked):
            buf.zero_()
        self._tracked = 0

    def _load_from_state_dict(self, *args: Any, **kwargs: Any) -> None:
        super()._load_from_state_dict(*args, **kwargs)
        self._tracked = int(self.tracked)


def _convert(module: nn.Module, chunks: int) -> nn.Module:
    if type(module) is BatchNorm:
        return DeferredBatchNorm.from_batch_norm(module, chunks)
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        raise TypeError(
            f"deferred_batch_norm converts torchgpipe_tpu_torch.ops.nn.BatchNorm "
            f"(the reference's batch_norm), not {type(module).__name__}, whose "
            "momentum and running variance mean other things"
        )
    for name, child in module.named_children():
        new = _convert(child, chunks)
        if new is not child:
            setattr(module, name, new)
    return module


def convert_deferred_batch_norm(
    layers: Sequence[nn.Module], chunks: int
) -> List[nn.Module]:
    """Replace every :class:`~torchgpipe_tpu_torch.ops.nn.BatchNorm` with
    its deferred twin, recursing into child modules (a ResNet
    downsample's BatchNorm inside its residual layer).  Returns the new
    layer list; a compound layer gets its converted children in place,
    as the reference's torch version does.  Converting again changes
    nothing."""
    return [_convert(layer, chunks) for layer in layers]
