"""Multi-process pipeline: one rank per OS process, one stage per rank.

Counterpart of ``torchgpipe_tpu/distributed/gpipe.py``
(``DistributedGPipe``, ``DistributedGPipeDataLoader``,
``_recv_probing_peer``), over ``nn.Module`` stages:

* Each rank holds its partition as a
  :class:`~torchgpipe_tpu_torch.partition.Stage` on its device and runs
  the cell bodies of the single-process ``GPipe``
  (``pipeline._Cells``), so one rank's forward, recompute and backward
  of a micro-batch are the operations ``GPipe`` runs for that stage, in
  the same order; activations, cotangents, cross-rank skips
  (``("skip", key)``, ``("skip_grad", key)``), the micro-batch count
  (``"meta"``) and the targets travel through a transport of
  :mod:`~torchgpipe_tpu_torch.distributed.context`.
* The fill-drain schedule emerges from the ranks blocking on their
  channels.  Checkpointed cells keep their inputs and recompute ahead of
  their backward.  Micro-batch ``i`` draws its dropout masks from
  ``fold_in(rng, i)`` folded with each layer's index, as in ``GPipe``.
* ``recv_timeout`` bounds every receive; a sender that missed it and
  fails the transport's liveness probe is a
  :class:`~torchgpipe_tpu_torch.distributed.context.PeerDiedError`
  naming its rank.  A send that fails against a peer that fails the
  probe raises the same error (on two ranks, rank 0 sends before it
  receives, so a dead last rank shows first on a send).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch import rng as _rng
from torchgpipe_tpu_torch.auxgrad import aux_scale
from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
from torchgpipe_tpu_torch.checkpoint import CHECKPOINT_MODES, checkpoint_stop
from torchgpipe_tpu_torch.distributed.context import PeerDiedError
from torchgpipe_tpu_torch.models.transformer import Device, resolve_device
from torchgpipe_tpu_torch.partition import Stage, split_layers, verify_module
from torchgpipe_tpu_torch.resilience import faults as _faults
from torchgpipe_tpu_torch.pipeline import Pipeline, _Cells, _mb_key, _to, loss_cotangents
from torchgpipe_tpu_torch.skip import inspect_skip_layout, verify_skippables

Pytree = Any


def _detached(payload: Pytree) -> Pytree:
    return pytree.tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, payload)


def _recv_probing_peer(
    mailbox: Any,
    transport: Any,
    kind: Any,
    index: int,
    timeout: Optional[float],
    src_rank: int,
    workers: Sequence[str],
    recorder: Optional[Any] = None,
) -> Pytree:
    """Mailbox receive that turns a timeout into a
    :class:`~torchgpipe_tpu_torch.distributed.context.PeerDiedError` when
    the expected sender fails the transport's liveness probe (probed only
    on a timeout: no cost in the steady state).  A slow but live peer
    stays a ``TimeoutError``.  With a ``recorder`` the receive records
    ``recv_wait`` and ``recv_match``, and a failure records
    ``peer_died`` or ``recv_timeout`` and dumps the ring before raising.
    """
    name = workers[src_rank]
    t0 = 0.0
    if recorder is not None:
        depth = getattr(mailbox, "depth", None)
        t0 = recorder.clock()
        recorder.record(
            "recv_wait", channel=(kind, index), peer=name,
            detail=f"depth={depth(kind, index)}" if depth else "",
        )
    try:
        payload = mailbox.get(kind, index, timeout=timeout)
    except TimeoutError as err:
        if not _alive(transport, name):
            if recorder is not None:
                recorder.record(
                    "peer_died", channel=(kind, index), peer=name,
                    dur=recorder.clock() - t0,
                    detail=f"rank {src_rank} endpoint gone",
                )
                recorder.crash_dump(
                    f"peer_died rank={src_rank} channel={(kind, index)!r}")
            raise PeerDiedError(
                src_rank, name,
                f"no message on channel {(kind, index)!r} within "
                f"{timeout}s and its transport endpoint is gone",
            ) from err
        if recorder is not None:
            recorder.record(
                "recv_timeout", channel=(kind, index), peer=name,
                dur=recorder.clock() - t0,
                detail=f"timeout={timeout}s, peer alive",
            )
            recorder.crash_dump(
                f"recv_timeout channel={(kind, index)!r} from rank {src_rank}")
        raise
    if recorder is not None:
        recorder.record("recv_match", channel=(kind, index), peer=name,
                        dur=recorder.clock() - t0)
    return payload


def _alive(transport: Any, name: str) -> bool:
    """The transport's liveness probe (True when it has none, or when the
    probe itself fails: a broken probe must not mask the error)."""
    probe = getattr(transport, "is_alive", None)
    if probe is None:
        return True
    try:
        return bool(probe(name))
    except Exception:  # noqa: BLE001
        return True


def _send_probing_peer(transport: Any, dst_rank: int, workers: Sequence[str],
                       kind: Any, index: int, payload: Pytree) -> None:
    """``transport.send``; a send that fails with a timeout or a
    connection error to a peer that fails the liveness probe raises
    :class:`~torchgpipe_tpu_torch.distributed.context.PeerDiedError`."""
    name = workers[dst_rank]
    try:
        transport.send(name, kind, index, payload)
    except (TimeoutError, ConnectionError) as err:
        if isinstance(err, PeerDiedError) or _alive(transport, name):
            raise
        raise PeerDiedError(
            dst_rank, name,
            f"send on channel {(kind, index)!r} failed ({type(err).__name__}) "
            "and its transport endpoint is gone",
        ) from err


class DistributedGPipe:
    """The pipeline stage this rank owns.

    ``workers`` names every rank in pipeline order; ``workers[rank]`` is
    this process, whose ``mailbox`` is registered on ``transport`` (see
    :func:`~torchgpipe_tpu_torch.distributed.context.worker`).  Every
    rank builds the same ``layers`` (from one seed, or loaded from one
    checkpoint) and keeps its partition of ``balance``, moved to
    ``device`` (``cuda`` unless named).  ``checkpoint`` is
    ``'always'``, ``'except_last'`` or ``'never'``; ``'offload'`` is
    refused.  ``recv_timeout`` bounds every receive, and
    ``first_step_grace`` extends it until the first training step has
    run both legs.  ``recorder`` (a
    :class:`~torchgpipe_tpu_torch.obs.flightrec.FlightRecorder`) records
    every send, receive, cell and loop boundary, and the mailbox's
    arrivals.

    The call sequence is the reference's: every rank calls
    :meth:`forward` (rank 0 with the batch), the last rank
    :meth:`loss_grads` on the outputs, and every rank :meth:`backward`
    (the last with the cotangents).  The reference's explicit
    parameters map onto the modules: ``forward`` takes no ``params`` or
    ``state`` (its ``init`` has no counterpart: the layers own their
    weights), and ``backward`` leaves each parameter's gradient in its
    ``.grad`` (cleared by the training forward, as ``GPipe`` clears it)
    and returns ``(grads, state)``: ``grads`` a list over this rank's
    layers of ``{param name: .grad}`` (zeros where a parameter took no
    gradient), ``state`` a list over them of ``{buffer name: buffer}``,
    updated in place.
    """

    def __init__(
        self,
        layers: Sequence[nn.Module],
        rank: int,
        workers: Sequence[str],
        balance: Sequence[int],
        *,
        chunks: int,
        transport: Any,
        mailbox: Any,
        device: Device = None,
        checkpoint: str = "except_last",
        deferred_batch_norm: bool = False,
        recv_timeout: Optional[float] = None,
        first_step_grace: Optional[float] = None,
        recorder: Optional[Any] = None,
    ) -> None:
        layers = list(layers)
        verify_module(layers)
        verify_skippables(layers)
        if len(balance) != len(workers):
            raise ValueError(
                f"balance has {len(balance)} stages but workers names "
                f"{len(workers)} ranks"
            )
        if not (0 <= rank < len(workers)):
            raise ValueError(f"rank {rank} out of range for {len(workers)} workers")
        if chunks <= 0:
            raise ValueError("number of chunks must be positive integer")
        if checkpoint not in CHECKPOINT_MODES:
            raise ValueError(
                f"checkpoint is not one of {'|'.join(CHECKPOINT_MODES)}"
            )
        if checkpoint == "offload":
            raise ValueError(
                "checkpoint='offload' is not supported by the distributed "
                "MPMD engine (per-rank residual relocation is not wired "
                "into its scheduler); use the single-process GPipe or the "
                "SPMD engine for host-offloaded residuals"
            )
        if first_step_grace is not None:
            if recv_timeout is None:
                raise ValueError(
                    "first_step_grace extends recv_timeout for the "
                    "compile-heavy first step, but recv_timeout is None "
                    "(receives already wait forever); set recv_timeout "
                    "or drop the grace"
                )
            if first_step_grace <= 0:
                raise ValueError(
                    f"first_step_grace must be positive seconds "
                    f"(got {first_step_grace!r})"
                )
        if deferred_batch_norm:
            layers = convert_deferred_batch_norm(layers, chunks)

        self.layers = layers
        self.rank = rank
        self.workers = list(workers)
        self.chunks = chunks
        self.checkpoint = checkpoint
        self.transport = transport
        self.mailbox = mailbox
        self.recv_timeout = recv_timeout
        self.first_step_grace = first_step_grace
        # Flips after the first step has run both legs: from then on the
        # grace no longer applies.
        self._warmed = False
        self.recorder = recorder
        if recorder is not None and getattr(mailbox, "recorder", None) is None:
            mailbox.recorder = recorder

        parts = split_layers(layers, balance)
        self.layout = inspect_skip_layout(parts)
        self.offset = sum(balance[:rank])
        self.device = resolve_device(device)
        self.stage = Stage(parts[rank], rank, self.layout, self.offset).to(self.device)
        self.partition = list(self.stage)
        # The single-process pipeline's cell bodies, on this rank's stage.
        stages: List[Optional[nn.Module]] = [None] * len(workers)
        stages[rank] = self.stage
        self._pipe = Pipeline(stages, [self.device] * len(workers), self.layout)
        # Which rank pops / stashes each cross-stage skip key.
        self._skip_pop_rank = {k: self.layout.pop_stage(k) for k in self.stage.ext_stash_keys}
        self._skip_stash_rank = {k: self.layout.stash_stage(k) for k in self.stage.ext_pop_keys}
        self._ctx: Optional[Dict[str, Any]] = None
        if recorder is not None:
            recorder.set_meta(
                engine="distributed",
                rank=rank,
                worker=self.workers[rank],
                workers=list(self.workers),
                chunks=chunks,
                checkpoint=checkpoint,
                skips=[
                    [str(key), src, dst]
                    for key, (src, dst) in sorted(
                        self.layout.by_key.items(), key=lambda kv: str(kv[0]))
                    if src != dst
                ],
            )
            if recorder.rank is None:
                recorder.rank = rank
            if recorder.worker is None:
                recorder.worker = self.workers[rank]

    # ------------------------------------------------------------------ #

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == len(self.workers) - 1

    def parameters(self) -> Iterator[nn.Parameter]:
        """This rank's parameters (what its optimizer steps)."""
        return self.stage.parameters()

    def _effective_timeout(self) -> Optional[float]:
        """The receive deadline for the current step: ``recv_timeout``
        plus ``first_step_grace`` until the pipeline is warm."""
        if self.recv_timeout is None:
            return None
        if not self._warmed and self.first_step_grace is not None:
            return self.recv_timeout + self.first_step_grace
        return self.recv_timeout

    def _first_step_hint(self, err: TimeoutError) -> TimeoutError:
        """A first-step timeout with no grace may have measured the peer's
        one-time start-up (its kernels loading, its allocator warming);
        say so."""
        if self._warmed or self.first_step_grace is not None:
            return err
        return TimeoutError(
            f"{err} (this was the FIRST step: the wait includes the "
            "upstream rank's one-time start-up, which can exceed any "
            "steady-state deadline — pass first_step_grace=<start-up "
            "budget seconds> to extend recv_timeout for step 0 only, or "
            "recv_timeout=None to wait it out)"
        )

    def _recv(self, kind: Any, index: int, src_rank: int) -> Pytree:
        """Deadline-bounded receive from ``src_rank``, placed on this
        rank's device."""
        try:
            payload = _recv_probing_peer(
                self.mailbox, self.transport, kind, index,
                self._effective_timeout(), src_rank, self.workers,
                recorder=self.recorder,
            )
        except PeerDiedError:
            raise
        except TimeoutError as err:
            raise self._first_step_hint(err) from err
        return _to(payload, self.device)

    def _send(self, dst_rank: int, kind: Any, index: int, payload: Pytree) -> None:
        """Send with a ``send`` flight event recorded first (a send that
        then hangs leaves its enqueue on the ring)."""
        dst = self.workers[dst_rank]
        if self.recorder is not None:
            self.recorder.record("send", channel=(kind, index), peer=dst)
        try:
            _send_probing_peer(self.transport, dst_rank, self.workers, kind, index,
                               _detached(payload))
        except Exception as err:
            if self.recorder is not None:
                self.recorder.record("send_fail", channel=(kind, index), peer=dst,
                                     detail=type(err).__name__)
            raise

    @contextlib.contextmanager
    def _mode(self, train: bool) -> Iterator[None]:
        was = [m.training for m in self.stage.modules()]
        self.stage.train(train)
        try:
            yield
        finally:
            for m, t in zip(self.stage.modules(), was):
                m.training = t

    # ------------------------------------------------------------------ #

    def forward(
        self,
        batch: Optional[Pytree] = None,
        *,
        rng: Any = None,
        train: bool = True,
    ) -> Optional[List[Pytree]]:
        """Run this rank's stage over all micro-batches.  Rank 0 scatters
        ``batch`` and sends the micro-batch count to every rank (a ragged
        batch makes fewer than ``chunks``); the others pass ``batch=None``
        and receive.  ``rng`` (an int seed or a key tensor) keys the
        dropouts; ``train=False`` runs with no gradients, in eval mode.
        Returns the per-micro-batch outputs on the last rank, else None."""
        rec = self.recorder
        if rec is not None:
            rec.record("forward_begin", detail=f"train={train}")
        if self.is_first:
            if batch is None:
                raise ValueError("rank 0 must be given the input batch")
            microbatch.check(batch)
            mbatches = microbatch.scatter(batch, self.chunks)
            m = len(mbatches)
            for r in range(1, len(self.workers)):
                self._send(r, "meta", 0, m)
        else:
            if batch is not None:
                raise ValueError("only rank 0 feeds the input batch")
            mbatches = None
            m = int(self._recv("meta", 0, 0))
        if rec is not None:
            rec.record("forward_plan", detail=f"m={m}")

        key = None if rng is None else _rng.Key(_rng.key_tensor(rng).to(self.device))
        stop = checkpoint_stop(self.checkpoint, m, train=train)
        cells = _Cells(self._pipe, m, stop, rng=key) if train else None
        if train:
            for p in self.stage.parameters():
                p.grad = None
        outs: List[Pytree] = []
        with self._mode(train):
            for i in range(m):
                x = mbatches[i] if self.is_first else self._recv("forward", i, self.rank - 1)
                skips_in = {k: self._recv(("skip", k), i, self._skip_stash_rank[k])
                            for k in self.stage.ext_pop_keys}
                t_cell = rec.clock() if rec is not None else 0.0
                if train:
                    for k, v in skips_in.items():
                        cells.skips[(i, k)] = v
                    y = cells.forward(i, self.rank, x)
                    ext = {k: cells.skips.pop((i, k)) for k in self.stage.ext_stash_keys}
                else:
                    x = _faults.corrupt_cell_input(self.rank, i, _to(x, self.device))
                    with torch.no_grad(), aux_scale(1.0 / m):
                        y, ext = self.stage(x, skips_in, _mb_key(key, i))
                if rec is not None:
                    rec.record("fwd", stage=self.rank, mb=i, dur=rec.clock() - t_cell)
                for k, v in ext.items():
                    self._send(self._skip_pop_rank[k], ("skip", k), i, v)
                if self.is_last:
                    outs.append(y)
                else:
                    self._send(self.rank + 1, "forward", i, y)
        if rec is not None:
            rec.record("forward_end", detail=f"m={m}")
        if not train:
            self._warmed = True
        self._ctx = {"m": m, "cells": cells, "train": train}
        return outs if self.is_last else None

    # ------------------------------------------------------------------ #

    def loss_grads(
        self,
        outputs: Sequence[Pytree],
        target: Pytree,
        loss_fn: Callable[..., Any],
    ) -> Tuple[torch.Tensor, List[Pytree], Any]:
        """Last rank: ``(loss, cotangent per micro-batch output, aux)``.
        The loss sees the gathered output (``loss_fn(output, target)``,
        which may return ``(loss, aux)``), as ``GPipe``'s fill-drain step
        computes it; a parametric ``loss_fn`` gets its ``.grad``."""
        if not self.is_last:
            raise RuntimeError("loss_grads is only meaningful on the last rank")
        return loss_cotangents(list(outputs), target, loss_fn, self.device)

    def backward(
        self, grad_outputs: Optional[Sequence[Pytree]] = None
    ) -> Tuple[List[Dict[str, torch.Tensor]], List[Dict[str, torch.Tensor]]]:
        """Reverse schedule over the micro-batches.  The last rank passes
        the cotangents from :meth:`loss_grads`; the others pass None and
        receive theirs.  Returns ``(grads, state)`` (see the class doc);
        the gradients are also in each parameter's ``.grad``."""
        if self._ctx is None:
            raise RuntimeError("backward called before forward")
        ctx = self._ctx
        self._ctx = None
        if not ctx["train"]:
            raise RuntimeError("backward after an eval-mode forward")
        if self.is_last:
            if grad_outputs is None:
                raise RuntimeError(
                    "the last rank must pass the output cotangents "
                    "(see DistributedGPipe.loss_grads)"
                )
            grad_outputs = list(grad_outputs)
        elif grad_outputs is not None:
            raise ValueError(
                "only the last rank takes output cotangents; other ranks "
                "receive theirs from the next rank's backward"
            )
        m, cells = ctx["m"], ctx["cells"]
        rec = self.recorder
        if rec is not None:
            rec.record("backward_begin", detail=f"m={m}")
        with self._mode(True):
            for i in reversed(range(m)):
                if self.is_last:
                    gy = _to(grad_outputs[i], self.device)
                else:
                    gy = self._recv("backward", i, self.rank + 1)
                for k in self.stage.ext_stash_keys:
                    cells.gskips[(i, k)] = self._recv(("skip_grad", k), i,
                                                      self._skip_pop_rank[k])
                t_cell = rec.clock() if rec is not None else 0.0
                gx = cells.backward(i, self.rank, gy)
                if rec is not None:
                    rec.record("bwd", stage=self.rank, mb=i, dur=rec.clock() - t_cell)
                if not self.is_first:
                    self._send(self.rank - 1, "backward", i, gx)
                for k in self.stage.ext_pop_keys:
                    # Always sent (None for a skip without a gradient):
                    # the stash rank waits for it.
                    self._send(self._skip_stash_rank[k], ("skip_grad", k), i,
                               cells.gskips.pop((i, k), None))
        if rec is not None:
            rec.record("backward_end", detail=f"m={m}")
        self._warmed = True
        grads, state = [], []
        for layer in self.partition:
            named = {}
            for name, p in layer.named_parameters():
                if not p.requires_grad:
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                named[name] = p.grad
            grads.append(named)
            state.append(dict(layer.named_buffers()))
        return grads, state


class DistributedGPipeDataLoader:
    """Rank-aware loader: rank 0 yields ``(data, None)`` and sends each
    target to the last rank, which yields ``(None, target)``; middle
    ranks yield ``(None, None)``.  A target crossing a ``TcpTransport``
    arrives on the CPU."""

    def __init__(
        self,
        loader: Any,
        rank: int,
        workers: Sequence[str],
        *,
        transport: Any,
        mailbox: Any,
        num_batches: Optional[int] = None,
        recv_timeout: Optional[float] = None,
    ) -> None:
        self.loader = loader
        self.rank = rank
        self.workers = list(workers)
        self.transport = transport
        self.mailbox = mailbox
        self.recv_timeout = recv_timeout
        if loader is None and num_batches is None:
            raise ValueError("ranks without a loader need num_batches")
        self.num_batches = num_batches if num_batches is not None else len(loader)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator:
        last = len(self.workers) - 1
        if self.rank == 0:
            for step, (data, target) in enumerate(self.loader):
                if step >= self.num_batches:
                    break
                if last != 0:
                    _send_probing_peer(self.transport, last, self.workers, "target",
                                       step, target)
                    yield data, None
                else:
                    yield data, target
        elif self.rank == last:
            for step in range(self.num_batches):
                target = _recv_probing_peer(
                    self.mailbox, self.transport, "target", step,
                    self.recv_timeout, 0, self.workers,
                )
                yield None, target
        else:
            for _ in range(self.num_batches):
                yield None, None
