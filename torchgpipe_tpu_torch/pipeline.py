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
* ``checkpoint='offload'`` (fill-drain only) runs every cell as
  ``'never'`` does, with its saved tensors in pinned host memory between
  its forward and its backward (:class:`~torchgpipe_tpu_torch.checkpoint.Offload`):
  the backward fetches each cell's tensors one cell ahead.
* ``GPipe(fused=True)`` captures :meth:`Pipeline.run_train` (or
  :meth:`Pipeline.run_forward`) whole into one CUDA graph
  (:mod:`torchgpipe_tpu_torch.gpipe`); the cells are these.
* ``rng`` (a :class:`~torchgpipe_tpu_torch.rng.Key`) is folded with
  the micro-batch index, ``fold_in(rng, i)``, and the stage folds in
  each layer's index; a checkpointed cell saves its key with its
  inputs, so its recompute draws the same dropout masks.
* Every cell's forward, and a checkpointed cell's recompute, runs under
  ``auxgrad.aux_scale(1/m)`` with ``m`` the micro-batches of this run
  (fewer than ``chunks`` for a ragged batch), so an injected auxiliary
  gradient (a MoE balance penalty) is a micro-batch mean, as the
  reference's per-cell weighting makes it.
* A cell's input passes :func:`~torchgpipe_tpu_torch.resilience.faults.corrupt_cell_input`
  first: ``faults.inject(nan_at=(j, i))`` poisons cell ``(i, j)``.
* ``tracer`` (:class:`~torchgpipe_tpu_torch.utils.tracing.Timeline`)
  records a span per cell: ``fwd`` and ``bwd`` (a recompute inside its
  backward), and ``loss``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

import torch.utils._pytree as pytree

from torchgpipe_tpu_torch import checkpoint as ckpt
from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch.auxgrad import aux_scale
from torchgpipe_tpu_torch.resilience import faults as _faults
from torchgpipe_tpu_torch.rng import Key
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
    return pytree.tree_map(
        lambda t: t.to(device, non_blocking=True) if isinstance(t, torch.Tensor) else t, x)


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


def _leaves(x: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _split_loss(res: Any) -> Tuple[torch.Tensor, Any]:
    return res if isinstance(res, tuple) else (res, None)


def loss_cotangents(outs: List[Any], target: Any, loss_fn: Callable[..., Any],
                    device: torch.device) -> Tuple[torch.Tensor, List[Any], Any]:
    """The loss of the gathered outputs on ``device`` and its backward:
    ``(loss, cotangent per output, aux)`` (the parameters of a parametric
    ``loss_fn`` get their ``.grad``)."""
    leaves = [_as_leaf(_to(o, device)) for o in outs]
    with torch.enable_grad():
        loss, aux = _split_loss(loss_fn(microbatch.gather(leaves), _to(target, device)))
        loss.backward()
    return loss.detach(), [_grad_of(leaf) for leaf in leaves], aux


def _mb_key(rng: Optional[Key], i: int) -> Optional[Key]:
    """Micro-batch ``i``'s key, the reference's ``fold_in(rng, i)``."""
    return None if rng is None else rng.fold(i)


class _Cells:
    """The cell bodies of one training step, shared by both schedules:
    what each cell keeps between its forward and its backward, and the
    skips and skip cotangents in flight."""

    def __init__(self, pipe: "Pipeline", m: int, checkpoint_stop: int,
                 offload: Optional[ckpt.Offload] = None,
                 rng: Optional[Key] = None) -> None:
        self.pipe = pipe
        self.aux = 1.0 / m     # every forward and recompute injects at 1/m
        self.stop = checkpoint_stop
        self.offload = offload
        self.rng = rng
        self.saved: Dict[Cell, Tuple] = {}    # checkpointed: inputs and key
        self.graphs: Dict[Cell, Tuple] = {}   # inputs and outputs
        self.skips: Dict[Tuple[int, Any], torch.Tensor] = {}
        self.gskips: Dict[Tuple[int, Any], torch.Tensor] = {}

    def forward(self, i: int, j: int, x: Any) -> Any:
        pipe = self.pipe
        stage, dev = pipe.stages[j], pipe.devices[j]
        start = None if pipe.tracer is None else pipe.tracer.now()
        x = _faults.corrupt_cell_input(j, i, _to(x, dev))
        if j > 0:
            x = _as_leaf(x)
        skips_in = {k: _as_leaf(self.skips.pop((i, k))) for k in stage.ext_pop_keys}
        rng_i = _mb_key(self.rng, i)
        if i < self.stop:
            with torch.no_grad(), ckpt.phase(checkpointing=True), aux_scale(self.aux):
                y, ext = stage(x, skips_in, rng_i)
            self.saved[(i, j)] = (x, skips_in, rng_i)
        else:
            hooks = contextlib.nullcontext() if self.offload is None else \
                self.offload.cell((i, j), dev, _leaves((x, *skips_in.values()))
                                  + list(stage.parameters()))
            with torch.enable_grad(), ckpt.phase(), hooks, aux_scale(self.aux):
                y, ext = stage(x, skips_in, rng_i)
            self.graphs[(i, j)] = (x, skips_in, y, ext)
        if pipe.tracer is not None:
            pipe.tracer.record("fwd", j, i, y, start=start)
        for k, v in ext.items():
            self.skips[(i, k)] = _to(v.detach(), pipe.devices[pipe.layout.pop_stage(k)])
        return y

    def backward(self, i: int, j: int, gy: Any, nxt: Optional[Cell] = None) -> Any:
        """The cell's backward from its output cotangent ``gy`` (and the
        cotangents of its stashes, which have arrived); returns its input
        cotangent on stage ``j - 1``'s device (None for stage 0).
        ``nxt`` is the cell whose backward comes next (offload fetches
        its tensors now)."""
        pipe = self.pipe
        stage = pipe.stages[j]
        start = None if pipe.tracer is None else pipe.tracer.now()
        if self.offload is not None:
            self.offload.before_backward(
                (i, j), pipe.devices[j], nxt,
                None if nxt is None else pipe.devices[nxt[1]])
        if (i, j) in self.saved:
            x, skips_in, rng_i = self.saved.pop((i, j))
            with torch.enable_grad(), ckpt.phase(recomputing=True), aux_scale(self.aux):
                y, ext = stage(x, skips_in, rng_i)
        else:
            x, skips_in, y, ext = self.graphs.pop((i, j))
        pairs = _pairs(y, gy)
        for k in stage.ext_stash_keys:
            pairs += _pairs(ext[k], self.gskips.pop((i, k), None))
        if pairs:
            torch.autograd.backward([a for a, _ in pairs], [b for _, b in pairs])
        if pipe.tracer is not None:
            # The whole cell's output, parameter gradients included: a
            # stage-0 cell hands back no input cotangent to wait on.
            pipe.tracer.record("bwd", j, i, ([p.grad for p in stage.parameters()],
                                             _grad_of(x)), start=start)
        for k, leaf in skips_in.items():
            g = _grad_of(leaf)
            if g is not None:
                self.gskips[(i, k)] = _to(g, pipe.devices[pipe.layout.stash_stage(k)])
        return _to(_grad_of(x), pipe.devices[j - 1]) if j > 0 else None


class Pipeline:
    """Scheduling of micro-batches over ``stages`` (one
    :class:`~torchgpipe_tpu_torch.partition.Stage` per stage, already on
    ``devices[j]``), routing skips by ``layout``; ``tracer`` records
    each cell."""

    def __init__(
        self, stages: Sequence[torch.nn.Module], devices: Sequence[torch.device],
        layout: SkipLayout, tracer: Any = None,
    ) -> None:
        self.stages = list(stages)
        self.devices = list(devices)
        self.layout = layout
        self.tracer = tracer

    def run_forward(self, mbatches: List[Any], rng: Optional[Key] = None) -> List[Any]:
        """All micro-batches through all stages with no gradients; the
        last stage's outputs, one per micro-batch."""
        n, m = len(self.stages), len(mbatches)
        acts: Dict[int, Any] = {}
        skips: Dict[Tuple[int, Any], torch.Tensor] = {}
        outs: List[Any] = [None] * m
        with torch.no_grad(), aux_scale(1.0 / m):
            for cycle in clock_cycles(m, n):
                for i, j in cycle:
                    stage = self.stages[j]
                    start = None if self.tracer is None else self.tracer.now()
                    x = mbatches[i] if j == 0 else acts.pop(i)
                    skips_in = {k: skips.pop((i, k)) for k in stage.ext_pop_keys}
                    y, ext = stage(_to(x, self.devices[j]), skips_in, _mb_key(rng, i))
                    if self.tracer is not None:
                        self.tracer.record("fwd", j, i, y, start=start)
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
        offload: Optional[ckpt.Offload] = None,
        rng: Optional[Key] = None,
    ) -> Tuple[torch.Tensor, Any]:
        """Fill-drain forward, loss on the gathered output, and backward.
        Returns ``(loss, aux)`` (``aux`` is what ``loss_fn`` returned
        beside the loss, or None); the parameters' ``.grad`` hold the
        mini-batch gradients (a parametric ``loss_fn``'s too).  With
        ``offload``, the cells' saved tensors wait in host memory
        (``checkpoint='offload'``)."""
        n, m = len(self.stages), len(mbatches)
        cells = _Cells(self, m, checkpoint_stop, offload, rng)
        acts: Dict[int, Any] = {}
        outs: List[Any] = [None] * m

        for cycle in clock_cycles(m, n):
            for i, j in cycle:
                y = cells.forward(i, j, mbatches[i] if j == 0 else acts.pop(i))
                if j == n - 1:
                    outs[i] = y
                else:
                    acts[i] = y

        start = None if self.tracer is None else self.tracer.now()
        loss, cots, aux = loss_cotangents(outs, target, loss_fn, self.devices[-1])
        gys: Dict[Cell, Any] = {(i, n - 1): g for i, g in enumerate(cots)}
        if self.tracer is not None:
            # Its own span (micro-batch -1), so a synchronizing tracer
            # does not charge the loss to the first backward cell.
            self.tracer.record("loss", n - 1, -1, (loss, cots), start=start)
        del cots, outs

        order = [c for cycle in reversed(list(clock_cycles(m, n))) for c in reversed(cycle)]
        for k, (i, j) in enumerate(order):
            nxt = order[k + 1] if k + 1 < len(order) else None
            gx = cells.backward(i, j, gys.pop((i, j)), nxt)
            if j > 0:
                gys[(i, j - 1)] = gx
        return loss, aux

    def run_train_1f1b(
        self,
        mbatches: List[Any],
        target_mbs: List[Any],
        loss_fn: Callable[..., Any],
        checkpoint_stop: int,
        loss_weights: Sequence[float],
        rng: Optional[Key] = None,
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
        cells = _Cells(self, m, checkpoint_stop, rng=rng)
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
            start = None if self.tracer is None else self.tracer.now()
            leaf = _as_leaf(y)
            with torch.enable_grad():
                loss, aux = _split_loss(loss_fn(leaf, _to(target_mbs[i], last)))
                wloss = loss * loss_weights[i]
                wloss.backward()
            losses[i], auxes[i] = wloss.detach(), aux
            gys[(i, j)] = _grad_of(leaf)
            if self.tracer is not None:
                self.tracer.record("loss", j, i, (losses[i], gys[(i, j)]), start=start)

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
