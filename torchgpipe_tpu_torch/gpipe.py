"""GPipe: pipeline parallelism over a sequential ``nn.Module`` list.

Counterpart of ``torchgpipe_tpu/gpipe.py``: the constructor's validation
(balance, chunks, checkpoint, schedule and ``loss_reduction``, deferred
batch norm), ``apply`` (pipelined forward with no gradients),
``value_and_grad`` (fill-drain or 1F1B forward, loss, backward) and
``make_train_step`` (one ``torch.optim`` optimizer per stage).  The
reference's ``layers.Layer`` protocol (``init``/``apply`` over explicit
parameter pytrees) has no counterpart: a layer is an ``nn.Module`` that
owns its parameters and buffers (BatchNorm's running statistics), and a
stage is a :class:`~torchgpipe_tpu_torch.partition.Stage` of them moved
to its device.  A layer with ``stash``/``pop`` keys is a skip layer
(:mod:`torchgpipe_tpu_torch.skip`).

Gradients are the parameters' own ``.grad``: cleared at the start of
``value_and_grad`` and accumulated over micro-batches in the parameters'
dtype, so an optimizer steps on the module with no second copy.  Model
state lives in buffers, updated in place by the step.

Example::

    model = GPipe(llama(cfg), balance=[34], chunks=4)
    loss, grads, aux = model.value_and_grad(tokens, tokens, causal_lm_loss)
    step = model.make_train_step(partial(torch.optim.SGD, lr=0.1), loss_fn)
    loss, aux = step(tokens, tokens)
    out = model.apply(tokens)
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
from torchgpipe_tpu_torch.checkpoint import CHECKPOINT_MODES, checkpoint_stop
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    not_ported,
    resolve_device,
)
from torchgpipe_tpu_torch.partition import Stage, split_layers, verify_module
from torchgpipe_tpu_torch.pipeline import Pipeline
from torchgpipe_tpu_torch.skip import inspect_skip_layout, verify_skippables

_SLICE = "2"  # ROADMAP.md queue A item for what the training slice leaves out

# The reference's constructor options that the port does not cover yet,
# each with the one value it takes here (the reference's default).
_UNPORTED_OPTIONS = {
    "compute_dtype": None,
    "fused": False,
    "remat_policy": None,
    "tracer": None,
    "hbm_budget_bytes": None,
    "megastep": 1,
}


def _random_module(layers: Sequence[nn.Module]) -> Optional[str]:
    """The first dropout module with ``p > 0`` (by name), or None.
    Checkpointed cells recompute their forward, so a random layer would
    need its per-micro-batch generator state replayed."""
    for i, layer in enumerate(layers):
        for name, mod in layer.named_modules():
            if isinstance(mod, nn.modules.dropout._DropoutNd) and mod.p > 0:
                return f"layer {i} ({name or type(mod).__name__})"
    return None


class GPipe(nn.Module):
    """Pipeline parallelism over a sequential layer list.

    ``balance`` splits the layers into stages; stage ``j`` lives on
    ``devices[j % len(devices)]`` (default ``[cuda]``), so an n-stage
    pipeline runs, serialized, on one card.  A mini-batch is scattered
    into ``chunks`` micro-batches (``torch.chunk`` sizes) and driven
    through the ``schedule``: ``'gpipe'`` (fill-drain, the loss on the
    gathered mini-batch) or ``'1f1b'`` (the loss per micro-batch, summed
    with ``loss_reduction`` ``'mean'`` or ``'sum'`` weights).
    ``checkpoint`` is one of ``'always'``, ``'except_last'`` (default) or
    ``'never'``.  ``deferred_batch_norm=True`` converts every
    :class:`~torchgpipe_tpu_torch.ops.nn.BatchNorm` to its deferred twin
    (:mod:`torchgpipe_tpu_torch.batchnorm`).
    """

    def __init__(
        self,
        layers: Sequence[nn.Module],
        balance: Optional[Sequence[int]] = None,
        *,
        devices: Optional[Sequence[Device]] = None,
        chunks: int = 1,
        checkpoint: str = "except_last",
        deferred_batch_norm: bool = False,
        schedule: str = "gpipe",
        loss_reduction: Optional[str] = None,
        **options: Any,
    ) -> None:
        super().__init__()
        if balance is None:
            raise ValueError(
                "balance is required — use torchgpipe_tpu_torch.balance."
                "balance_by_time, balance_by_size or balance_by_flops for "
                "automatic balancing (reference: torchgpipe/gpipe.py:34-50)"
            )
        if chunks <= 0:
            raise ValueError("number of chunks must be positive integer")
        if checkpoint not in CHECKPOINT_MODES:
            raise ValueError(
                f"checkpoint is not one of {'|'.join(CHECKPOINT_MODES)}"
            )
        if checkpoint == "offload":
            raise not_ported("GPipe(checkpoint='offload')", _SLICE)
        for name, value in options.items():
            if name not in _UNPORTED_OPTIONS:
                raise TypeError(f"GPipe got an unexpected keyword argument {name!r}")
            if value != _UNPORTED_OPTIONS[name]:
                raise not_ported(f"GPipe({name}={value!r})", _SLICE)
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError("schedule must be 'gpipe' or '1f1b'")
        if schedule == "1f1b" and loss_reduction not in ("mean", "sum"):
            raise ValueError(
                "schedule='1f1b' seeds each micro-batch's backward before "
                "the mini-batch output exists, so the loss must decompose "
                "over micro-batches: pass loss_reduction='mean' (loss_fn is "
                "a batch-mean) or 'sum' (a batch-sum)"
            )
        if schedule != "1f1b" and loss_reduction is not None:
            raise ValueError(
                "loss_reduction only applies to schedule='1f1b' (the "
                "fill-drain schedule computes the loss on the gathered "
                "mini-batch); drop it or set schedule='1f1b'"
            )

        layers = list(layers)
        verify_module(layers)
        verify_skippables(layers)
        random = _random_module(layers)
        if random is not None:
            raise not_ported(
                f"a random layer in a recomputed pipeline cell ({random}: "
                "per-micro-batch RNG replay)", _SLICE,
            )
        self._deferred_batch_norm = deferred_batch_norm
        if deferred_batch_norm:
            layers = convert_deferred_batch_norm(layers, chunks)

        self.balance = list(balance)
        self.chunks = chunks
        self.checkpoint = checkpoint
        self.schedule = schedule
        self.loss_reduction = loss_reduction
        parts = split_layers(layers, self.balance)
        self.skip_layout = inspect_skip_layout(parts)
        if devices is None:
            devices = [resolve_device(None)]
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[j % len(devices)] for j in range(len(parts))]
        self.partitions = nn.ModuleList(
            Stage(part, j, self.skip_layout).to(dev)
            for j, (part, dev) in enumerate(zip(parts, self.devices))
        )
        self._layers = layers
        self._pipeline = Pipeline(list(self.partitions), self.devices, self.skip_layout)

    # ------------------------------------------------------------------ #
    # container protocol                                                 #
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._layers)

    def __getitem__(self, index: int) -> nn.Module:
        return self._layers[index]

    def __iter__(self) -> Iterator[nn.Module]:
        return iter(self._layers)

    def extra_repr(self) -> str:
        return (
            f"balance={self.balance}, chunks={self.chunks}, "
            f"checkpoint={self.checkpoint!r}, schedule={self.schedule!r}, "
            f"devices={[str(d) for d in self.devices]}"
        )

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #

    @contextlib.contextmanager
    def _mode(self, train: bool) -> Iterator[None]:
        """Every layer in ``train`` mode for one call, then as it was
        (the reference passes ``train`` to each call)."""
        was = [m.training for m in self.modules()]
        self.train(train)
        try:
            yield
        finally:
            for m, t in zip(self.modules(), was):
                m.training = t

    def apply(self, x: microbatch.Batch) -> microbatch.Batch:  # type: ignore
        """Pipelined forward with no gradients, every layer in eval mode
        (BatchNorm reads its running statistics): scatter, schedule,
        gather.  The name is the reference's entry point; it shadows
        ``nn.Module.apply(fn)``, so a callable (as a parent module's
        ``apply(init_fn)`` passes down) goes to ``nn.Module.apply``."""
        if callable(x):
            return super().apply(x)
        with self._mode(False):
            outs = self._pipeline.run_forward(microbatch.scatter(x, self.chunks))
        return microbatch.gather(outs)

    def forward(self, x: microbatch.Batch) -> microbatch.Batch:
        return self.apply(x)

    def _split_microbatches(self, x: microbatch.Batch) -> Tuple[List, int]:
        """Scatter and the checkpoint stop.  Deferred BN commits on the
        ``chunks``-th micro-batch; a short batch would never commit and
        would bleed its sums into the next mini-batch."""
        mbatches = microbatch.scatter(x, self.chunks)
        if self._deferred_batch_norm and len(mbatches) != self.chunks:
            raise ValueError(
                f"deferred_batch_norm requires the batch to split into exactly "
                f"chunks={self.chunks} micro-batches, got {len(mbatches)} "
                f"(batch size {microbatch.batch_size(x)})"
            )
        return mbatches, checkpoint_stop(self.checkpoint, len(mbatches), train=True)

    def value_and_grad(
        self,
        x: microbatch.Batch,
        target: Any,
        loss_fn: Callable[..., Any],
        *,
        rng: Any = None,
    ) -> Tuple[torch.Tensor, Tuple[List[dict], ...], Any]:
        """Pipelined training step: forward, loss, backward.

        Under ``'gpipe'`` ``loss_fn(output, target)`` sees the gathered
        mini-batch output, so loss and gradients are those of the
        unpipelined model; it may return ``(loss, aux)``.  Under
        ``'1f1b'`` the loss is computed per micro-batch and weighted by
        ``loss_reduction``, so ``target`` must split along the batch like
        the input, and ``aux`` is a list with one value per micro-batch.
        Returns ``(loss, grads, aux)`` with ``grads`` a tuple over stages
        of lists over layers of ``{param name: param.grad}``; running
        statistics are updated in their buffers."""
        if rng is not None:
            raise not_ported(
                "value_and_grad(rng=...) (per-micro-batch RNG)", _SLICE
            )
        mbatches, stop = self._split_microbatches(x)
        for p in self.parameters():
            p.grad = None
        with self._mode(True):
            if self.schedule == "1f1b":
                loss, aux = self._run_1f1b(mbatches, target, loss_fn, stop)
            else:
                loss, aux = self._pipeline.run_train(mbatches, target, loss_fn, stop)
        grads = []
        for part in self.partitions:
            stage = []
            for layer in part:
                named = {}
                for name, p in layer.named_parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    named[name] = p.grad
                stage.append(named)
            grads.append(stage)
        return loss, tuple(grads), aux

    def _run_1f1b(
        self, mbatches: List, target: Any, loss_fn: Callable[..., Any], stop: int
    ) -> Tuple[torch.Tensor, List[Any]]:
        """The 1F1B step: the micro-batches' loss weights, and the
        target split along the batch as the input is."""
        sizes = [microbatch.batch_size(mb) for mb in mbatches]
        total = sum(sizes)
        if self.loss_reduction == "mean":
            weights = [b / total for b in sizes]
        else:
            weights = [1.0] * len(sizes)
        try:
            microbatch.check(target)
            target_ok = microbatch.batch_size(target) == total
        except (ValueError, TypeError, IndexError):
            target_ok = False
        if not target_ok:
            raise ValueError(
                "schedule='1f1b' computes the loss per micro-batch, so "
                "target must be a pytree splitting along the batch "
                f"dimension like the input (batch size {total}); got "
                f"{type(target).__name__}. Use the default schedule for "
                "non-batched targets"
            )
        target_mbs = microbatch.scatter(target, self.chunks)
        return self._pipeline.run_train_1f1b(
            mbatches, target_mbs, loss_fn, stop, weights
        )

    def init_opt_state(
        self, optimizer: Callable[[Any], torch.optim.Optimizer]
    ) -> Tuple[torch.optim.Optimizer, ...]:
        """One optimizer per stage, ``optimizer(stage parameters)``, each
        over the parameters on its stage's device (the reference's
        per-stage optax states)."""
        return tuple(optimizer(list(part.parameters())) for part in self.partitions)

    def make_train_step(
        self,
        optimizer: Callable[[Any], torch.optim.Optimizer],
        loss_fn: Callable[..., Any],
        *,
        megastep: Optional[int] = None,
    ) -> Callable[..., Tuple[torch.Tensor, Any]]:
        """Training step with the optimizer applied per stage.

        ``optimizer`` maps an iterable of parameters to a
        ``torch.optim.Optimizer``, for example
        ``functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)``; it
        is called once per stage here (:meth:`init_opt_state`).  Returns
        ``step(x, target, rng=None) -> (loss, aux)``: ``value_and_grad``,
        then every stage's ``optimizer.step()``.  The update is in place,
        so the reference's ``donate`` has no counterpart; the optimizers
        are ``step.optimizers``."""
        k = 1 if megastep is None else int(megastep)
        if k != 1:
            raise not_ported(
                f"make_train_step(megastep={k}) (K steps in one captured "
                "program)", _SLICE,
            )
        optimizers = self.init_opt_state(optimizer)

        def step(x: Any, target: Any, rng: Any = None) -> Tuple[torch.Tensor, Any]:
            loss, _, aux = self.value_and_grad(x, target, loss_fn, rng=rng)
            for opt in optimizers:
                opt.step()
            return loss, aux

        step.optimizers = optimizers  # type: ignore[attr-defined]
        return step

    def value_and_grad_with_loss_params(self, *args: Any, **kwargs: Any) -> Any:
        raise not_ported(
            "GPipe.value_and_grad_with_loss_params (parametric loss layers)", _SLICE
        )
