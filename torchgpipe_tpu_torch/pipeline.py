"""GPipe fill-drain and 1F1B schedules over ``nn.Module`` stages.

Counterpart of ``torchgpipe_tpu/pipeline.py`` (``clock_cycles``,
``one_f1b_orders``, ``Pipeline.run_forward``, ``Pipeline.run_train``,
``Pipeline.run_train_1f1b``), in torch idiom:

* A cell ``(i, j)`` runs micro-batch ``i`` through stage ``j``
  (:class:`~torchgpipe_tpu_torch.partition.Stage`).  Cycle ``k`` of the
  fill-drain forward runs the cells with ``i + j == k``, and its backward
  visits the cells in the exact reverse order.  1F1B runs each stage's
  own order (:func:`one_f1b_orders`).
* The input of a stage ``j > 0`` is a detached leaf that requires grad,
  so after the cell's ``torch.autograd.backward`` its ``.grad`` is the
  cotangent handed to stage ``j - 1``.
* Skips go from the stash stage straight to the pop stage, where each is
  a detached leaf too; its ``.grad`` goes back to the stash stage, whose
  backward takes its output's and its stashes' cotangents in one call.
  Both schedules run a pop cell's backward before its stash cell's: the
  cotangent chain from the last stage passes through every stage between.
* A checkpointed cell (``i < checkpoint_stop``) runs its forward under
  ``torch.no_grad()`` keeping only its inputs; in the backward it
  recomputes with gradients on, then takes its cotangents
  (recompute-ahead).  The recompute makes the same stashes.
* A cell's graph is freed by its backward, so under 1F1B a stage holds
  at most ``n - j`` micro-batches' graphs: on one card the dispatch
  order is what sets the peak memory.
* Fill-drain computes the loss once, on the gathered mini-batch on the
  last stage's device (transparency with the unpipelined model); 1F1B
  computes ``w_i * loss_fn(out_i, target_i)`` as each micro-batch leaves
  the last stage.
* Parameter gradients accumulate over micro-batches in ``.grad``, in the
  parameters' dtype, as the reference's per-stage tree adds do.
* Stage hand-offs are ``.to(device, non_blocking=True)``; kernels queue
  on each device's current stream while Python runs ahead.

Not ported (ROADMAP.md queue A item 2): the fused schedule, host offload
of residuals, tracing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch

from torchgpipe_tpu_torch import checkpoint as ckpt
from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch.skip import SkipLayout

Cell = Tuple[int, int]


def one_f1b_orders(m: int, n: int) -> List[List[Tuple[str, int]]]:
    """Per-stage 1F1B (PipeDream-flush) op order: stage ``j`` warms up with
    ``min(m, n - j)`` forwards, then strictly alternates bwd/fwd, then
    drains backwards."""
    orders: List[List[Tuple[str, int]]] = []
    for j in range(n):
        warm = min(m, n - j)
        ops: List[Tuple[str, int]] = [("fwd", i) for i in range(warm)]
        nf, nb = warm, 0
        while nb < m:
            ops.append(("bwd", nb))
            nb += 1
            if nf < m:
                ops.append(("fwd", nf))
                nf += 1
        orders.append(ops)
    return orders


def clock_cycles(m: int, n: int) -> Iterator[List[Cell]]:
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


def _pairs(y: Any, gy: Any) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(tensor, cotangent) pairs of ``y`` that take a backward."""
    ys, gs = (list(y), list(gy)) if isinstance(y, tuple) else ([y], [gy])
    return [(a, b) for a, b in zip(ys, gs) if b is not None and a.requires_grad]


def _split_loss(res: Any) -> Tuple[torch.Tensor, Any]:
    return res if isinstance(res, tuple) else (res, None)


class _Cells:
    """The cell bodies of one training step, shared by both schedules:
    what each cell keeps between its forward and its backward, and the
    skips and skip cotangents in flight."""

    def __init__(self, pipe: "Pipeline", checkpoint_stop: int) -> None:
        self.pipe = pipe
        self.stop = checkpoint_stop
        self.saved: Dict[Cell, Tuple] = {}    # checkpointed: inputs only
        self.graphs: Dict[Cell, Tuple] = {}   # inputs and outputs
        self.skips: Dict[Tuple[int, Any], torch.Tensor] = {}
        self.gskips: Dict[Tuple[int, Any], torch.Tensor] = {}

    def forward(self, i: int, j: int, x: Any) -> Any:
        pipe = self.pipe
        stage, dev = pipe.stages[j], pipe.devices[j]
        x = _to(x, dev)
        if j > 0:
            x = _as_leaf(x)
        skips_in = {k: _as_leaf(self.skips.pop((i, k))) for k in stage.ext_pop_keys}
        if i < self.stop:
            with torch.no_grad(), ckpt.phase(checkpointing=True):
                y, ext = stage(x, skips_in)
            self.saved[(i, j)] = (x, skips_in)
        else:
            with torch.enable_grad(), ckpt.phase():
                y, ext = stage(x, skips_in)
            self.graphs[(i, j)] = (x, skips_in, y, ext)
        for k, v in ext.items():
            self.skips[(i, k)] = _to(v.detach(), pipe.devices[pipe.layout.pop_stage(k)])
        return y

    def backward(self, i: int, j: int, gy: Any) -> Any:
        """The cell's backward from its output cotangent ``gy`` (and the
        cotangents of its stashes, which have arrived); returns its input
        cotangent on stage ``j - 1``'s device (None for stage 0)."""
        pipe = self.pipe
        stage = pipe.stages[j]
        if (i, j) in self.saved:
            x, skips_in = self.saved.pop((i, j))
            with torch.enable_grad(), ckpt.phase(recomputing=True):
                y, ext = stage(x, skips_in)
        else:
            x, skips_in, y, ext = self.graphs.pop((i, j))
        pairs = _pairs(y, gy)
        for k in stage.ext_stash_keys:
            pairs += _pairs(ext[k], self.gskips.pop((i, k), None))
        if pairs:
            torch.autograd.backward([a for a, _ in pairs], [b for _, b in pairs])
        for k, leaf in skips_in.items():
            g = _grad_of(leaf)
            if g is not None:
                self.gskips[(i, k)] = _to(g, pipe.devices[pipe.layout.stash_stage(k)])
        return _to(_grad_of(x), pipe.devices[j - 1]) if j > 0 else None


class Pipeline:
    """Scheduling of micro-batches over ``stages`` (one
    :class:`~torchgpipe_tpu_torch.partition.Stage` per stage, already on
    ``devices[j]``), routing skips by ``layout``."""

    def __init__(
        self, stages: Sequence[torch.nn.Module], devices: Sequence[torch.device],
        layout: SkipLayout,
    ) -> None:
        self.stages = list(stages)
        self.devices = list(devices)
        self.layout = layout

    def run_forward(self, mbatches: List[Any]) -> List[Any]:
        """All micro-batches through all stages with no gradients; the
        last stage's outputs, one per micro-batch."""
        n, m = len(self.stages), len(mbatches)
        acts: Dict[int, Any] = {}
        skips: Dict[Tuple[int, Any], torch.Tensor] = {}
        outs: List[Any] = [None] * m
        with torch.no_grad():
            for cycle in clock_cycles(m, n):
                for i, j in cycle:
                    stage = self.stages[j]
                    x = mbatches[i] if j == 0 else acts.pop(i)
                    skips_in = {k: skips.pop((i, k)) for k in stage.ext_pop_keys}
                    y, ext = stage(_to(x, self.devices[j]), skips_in)
                    for k, v in ext.items():
                        skips[(i, k)] = _to(v, self.devices[self.layout.pop_stage(k)])
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
        """Fill-drain forward, loss on the gathered output, and backward.
        Returns ``(loss, aux)`` (``aux`` is what ``loss_fn`` returned
        beside the loss, or None); the parameters' ``.grad`` hold the
        mini-batch gradients."""
        n, m = len(self.stages), len(mbatches)
        cells = _Cells(self, checkpoint_stop)
        acts: Dict[int, Any] = {}
        outs: List[Any] = [None] * m

        for cycle in clock_cycles(m, n):
            for i, j in cycle:
                y = cells.forward(i, j, mbatches[i] if j == 0 else acts.pop(i))
                if j == n - 1:
                    outs[i] = y
                else:
                    acts[i] = y

        last = self.devices[-1]
        leaves = [_as_leaf(_to(o, last)) for o in outs]
        with torch.enable_grad():
            loss, aux = _split_loss(loss_fn(microbatch.gather(leaves), _to(target, last)))
            loss.backward()
        gys: Dict[Cell, Any] = {(i, n - 1): _grad_of(leaf) for i, leaf in enumerate(leaves)}
        del leaves, outs

        for cycle in reversed(list(clock_cycles(m, n))):
            for i, j in reversed(cycle):
                gx = cells.backward(i, j, gys.pop((i, j)))
                if j > 0:
                    gys[(i, j - 1)] = gx
        return loss.detach(), aux

    def run_train_1f1b(
        self,
        mbatches: List[Any],
        target_mbs: List[Any],
        loss_fn: Callable[..., Any],
        checkpoint_stop: int,
        loss_weights: Sequence[float],
    ) -> Tuple[torch.Tensor, List[Any]]:
        """One-forward-one-backward schedule.  The loss of micro-batch
        ``i`` is ``loss_weights[i] * loss_fn(out_i, target_mbs[i])``,
        computed, with its output cotangent, as soon as ``out_i`` leaves
        the last stage; each stage dispatches its :func:`one_f1b_orders`
        order, an op waiting (without blocking other stages) until its
        inputs exist.  Returns ``(loss, aux_list)``, one aux (or None)
        per micro-batch."""
        n, m = len(self.stages), len(mbatches)
        orders = one_f1b_orders(m, n)
        cells = _Cells(self, checkpoint_stop)
        acts: Dict[Cell, Any] = {}
        gys: Dict[Cell, Any] = {}
        losses: List[Any] = [None] * m
        auxes: List[Any] = [None] * m
        last = self.devices[-1]

        def do_fwd(i: int, j: int) -> None:
            y = cells.forward(i, j, mbatches[i] if j == 0 else acts.pop((i, j - 1)))
            if j < n - 1:
                acts[(i, j)] = y
                return
            leaf = _as_leaf(y)
            with torch.enable_grad():
                loss, aux = _split_loss(loss_fn(leaf, _to(target_mbs[i], last)))
                wloss = loss * loss_weights[i]
                wloss.backward()
            losses[i], auxes[i] = wloss.detach(), aux
            gys[(i, j)] = _grad_of(leaf)

        def do_bwd(i: int, j: int) -> None:
            gx = cells.backward(i, j, gys.pop((i, j)))
            if j > 0:
                gys[(i, j - 1)] = gx

        ready = {
            "fwd": lambda i, j: j == 0 or (i, j - 1) in acts,
            "bwd": lambda i, j: (i, j) in gys,
        }
        run = {"fwd": do_fwd, "bwd": do_bwd}
        cursors = [0] * n
        while any(c < len(o) for c, o in zip(cursors, orders)):
            progressed = False
            for j in range(n):
                while cursors[j] < len(orders[j]):
                    kind, i = orders[j][cursors[j]]
                    if not ready[kind](i, j):
                        break
                    run[kind](i, j)
                    cursors[j] += 1
                    progressed = True
            if not progressed:  # pragma: no cover - the orders guarantee progress
                pending = [(j, orders[j][c]) for j, c in enumerate(cursors)
                           if c < len(orders[j])]
                raise RuntimeError(f"1F1B schedule deadlocked; pending {pending}")
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        return total, auxes
