"""GPipe fill-drain schedule over ``nn.Module`` stages.

Counterpart of ``torchgpipe_tpu/pipeline.py`` (``clock_cycles``,
``Pipeline.run_forward``, ``Pipeline.run_train``), in torch idiom:

* A cell ``(i, j)`` runs micro-batch ``i`` through stage ``j``; cycle
  ``k`` of the forward schedule runs the cells with ``i + j == k``, and
  the backward schedule visits the cells in the exact reverse order.
* The input of a stage ``j > 0`` is a detached leaf that requires grad,
  so after ``torch.autograd.backward(y, gy)`` its ``.grad`` is the
  cotangent handed to stage ``j - 1``.
* A checkpointed cell (``i < checkpoint_stop``) runs its forward under
  ``torch.no_grad()`` keeping only its input; in the backward schedule it
  recomputes with gradients on, then takes its cotangent
  (recompute-ahead).
* The loss runs once, on the gathered mini-batch on the last stage's
  device (transparency with the unpipelined model); each micro-batch's
  output cotangent is the ``.grad`` of that output's leaf.
* Parameter gradients accumulate over micro-batches in ``.grad``, in the
  parameters' dtype, as the reference's per-stage tree adds do.
* Stage hand-offs are ``.to(device, non_blocking=True)``; kernels queue
  on each device's current stream while Python runs ahead.

Not ported (ROADMAP.md queue A item 2): the 1F1B and fused schedules,
skip connections between stages, host offload of residuals, tracing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch import checkpoint as ckpt
from torchgpipe_tpu_torch import microbatch


def clock_cycles(m: int, n: int) -> Iterator[List[Tuple[int, int]]]:
    """The GPipe fill-drain schedule: cycle ``k`` runs cells ``(i, j)``
    with ``i + j == k`` (micro-batch ``i`` on stage ``j``)."""
    for k in range(m + n - 1):
        yield [(k - j, j) for j in range(max(0, k - m + 1), min(k + 1, n))]


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return None if x is None else x.to(device, non_blocking=True)


def _as_leaf(x: Any) -> Any:
    """A stage input as a detached leaf; floating tensors require grad so
    their ``.grad`` is the cotangent to hand back."""
    if isinstance(x, tuple):
        return tuple(_as_leaf(t) for t in x)
    x = x.detach()
    return x.requires_grad_() if x.is_floating_point() else x


def _grad_of(x: Any) -> Any:
    if isinstance(x, tuple):
        return tuple(_grad_of(t) for t in x)
    return x.grad if x.requires_grad else None


def _tensors_with_grads(y: Any, gy: Any) -> Tuple[List, List]:
    ys, gs = (list(y), list(gy)) if isinstance(y, tuple) else ([y], [gy])
    pairs = [(a, b) for a, b in zip(ys, gs) if b is not None and a.requires_grad]
    return [a for a, _ in pairs], [b for _, b in pairs]


class Pipeline:
    """Fill-drain scheduling of micro-batches over ``stages`` (one
    ``nn.Sequential`` per stage, already on ``devices[j]``)."""

    def __init__(
        self, stages: Sequence[nn.Module], devices: Sequence[torch.device]
    ) -> None:
        self.stages = list(stages)
        self.devices = list(devices)

    def run_forward(self, mbatches: List[Any]) -> List[Any]:
        """All micro-batches through all stages with no gradients; the
        last stage's outputs, one per micro-batch."""
        n, m = len(self.stages), len(mbatches)
        acts: Dict[int, Any] = {}
        outs: List[Any] = [None] * m
        with torch.no_grad():
            for cycle in clock_cycles(m, n):
                for i, j in cycle:
                    x = mbatches[i] if j == 0 else acts.pop(i)
                    y = self.stages[j](_to(x, self.devices[j]))
                    if j == n - 1:
                        outs[i] = y
                    else:
                        acts[i] = y
        return outs

    def run_train(
        self,
        mbatches: List[Any],
        target: Any,
        loss_fn: Callable[..., Any],
        checkpoint_stop: int,
    ) -> Tuple[torch.Tensor, Any]:
        """Pipelined forward, loss on the gathered output, and backward.
        Returns ``(loss, aux)`` (``aux`` is what ``loss_fn`` returned
        beside the loss, or None); the parameters' ``.grad`` hold the
        mini-batch gradients."""
        n, m = len(self.stages), len(mbatches)
        acts: Dict[int, Any] = {}
        outs: List[Any] = [None] * m
        saved: Dict[Tuple[int, int], Any] = {}     # checkpointed: input only
        graphs: Dict[Tuple[int, int], Tuple[Any, Any]] = {}  # (input, output)

        # ---- forward schedule --------------------------------------------
        for cycle in clock_cycles(m, n):
            for i, j in cycle:
                x = mbatches[i] if j == 0 else acts.pop(i)
                x = _to(x, self.devices[j])
                if j > 0:
                    x = _as_leaf(x)
                if i < checkpoint_stop:
                    with torch.no_grad(), ckpt.phase(checkpointing=True):
                        y = self.stages[j](x)
                    saved[(i, j)] = x
                else:
                    with torch.enable_grad(), ckpt.phase():
                        y = self.stages[j](x)
                    graphs[(i, j)] = (x, y)
                if j == n - 1:
                    outs[i] = y
                else:
                    acts[i] = y

        # ---- loss and output cotangents -----------------------------------
        last = self.devices[-1]
        leaves = [_as_leaf(_to(o, last)) for o in outs]
        with torch.enable_grad():
            res = loss_fn(microbatch.gather(leaves), _to(target, last))
            loss, aux = res if isinstance(res, tuple) else (res, None)
            loss.backward()
        gys: Dict[Tuple[int, int], Any] = {
            (i, n - 1): _grad_of(leaf) for i, leaf in enumerate(leaves)
        }
        del leaves, outs

        # ---- backward schedule (reverse clock cycles) ---------------------
        order = [
            (i, j)
            for cycle in reversed(list(clock_cycles(m, n)))
            for i, j in reversed(cycle)
        ]
        for i, j in order:
            if (i, j) in saved:
                x = saved.pop((i, j))
                with torch.enable_grad(), ckpt.phase(recomputing=True):
                    y = self.stages[j](x)
            else:
                x, y = graphs.pop((i, j))
            ys, gs = _tensors_with_grads(y, gys.pop((i, j)))
            if ys:
                torch.autograd.backward(ys, gs)
            if j > 0:
                gys[(i, j - 1)] = _to(_grad_of(x), self.devices[j - 1])
        return loss.detach(), aux

