"""GPipe: pipeline parallelism over a sequential ``nn.Module`` list.

Counterpart of ``torchgpipe_tpu/gpipe.py`` restricted to the training
slice: the constructor's validation, ``apply`` (pipelined forward with no
gradients) and ``value_and_grad`` (fill-drain forward, loss on the
gathered mini-batch, backward).  The reference's ``layers.Layer``
protocol (``init``/``apply`` over explicit parameter pytrees) has no
counterpart: a layer is an ``nn.Module`` that owns its parameters, and a
stage is an ``nn.Sequential`` of them moved to its device.

Gradients are the parameters' own ``.grad``: cleared at the start of
``value_and_grad`` and accumulated over micro-batches in the parameters'
dtype, so an optimizer can step on the module with no second copy.

Example::

    model = GPipe(llama(cfg), balance=[34], chunks=4)
    loss, grads, aux = model.value_and_grad(tokens, tokens, causal_lm_loss)
    out = model.apply(tokens)
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from torchgpipe_tpu_torch import microbatch
from torchgpipe_tpu_torch.checkpoint import CHECKPOINT_MODES, checkpoint_stop
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    not_ported,
    resolve_device,
)
from torchgpipe_tpu_torch.partition import split_layers, verify_module
from torchgpipe_tpu_torch.pipeline import Pipeline

_SLICE = "2"  # ROADMAP.md queue A item for what the training slice leaves out

# The reference's constructor options that the slice does not cover, each
# with the one value it takes here (the reference's default).
_UNPORTED_OPTIONS = {
    "deferred_batch_norm": False,
    "compute_dtype": None,
    "fused": False,
    "schedule": "gpipe",
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
    through the fill-drain schedule; ``checkpoint`` is one of
    ``'always'``, ``'except_last'`` (default) or ``'never'``.
    """

    def __init__(
        self,
        layers: Sequence[nn.Module],
        balance: Optional[Sequence[int]] = None,
        *,
        devices: Optional[Sequence[Device]] = None,
        chunks: int = 1,
        checkpoint: str = "except_last",
        **options: Any,
    ) -> None:
        super().__init__()
        if balance is None:
            raise ValueError(
                "balance is required: automatic balancing "
                "(torchgpipe_tpu.balance) is not ported yet (ROADMAP.md, "
                "queue A item 2)"
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

        layers = list(layers)
        verify_module(layers)
        for i, layer in enumerate(layers):
            if getattr(layer, "stash", ()) or getattr(layer, "pop", ()):
                raise not_ported(
                    f"skip connections (layer {i} stashes/pops)", _SLICE
                )
        random = _random_module(layers)
        if random is not None:
            raise not_ported(
                f"a random layer in a recomputed pipeline cell ({random}: "
                "per-micro-batch RNG replay)", _SLICE,
            )

        self.balance = list(balance)
        self.chunks = chunks
        self.checkpoint = checkpoint
        parts = split_layers(layers, self.balance)
        if devices is None:
            devices = [resolve_device(None)]
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[j % len(devices)] for j in range(len(parts))]
        self.partitions = nn.ModuleList(
            nn.Sequential(*part).to(dev) for part, dev in zip(parts, self.devices)
        )
        self._layers = layers
        self._pipeline = Pipeline(list(self.partitions), self.devices)

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
            f"checkpoint={self.checkpoint!r}, "
            f"devices={[str(d) for d in self.devices]}"
        )

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #

    def apply(self, x: microbatch.Batch) -> microbatch.Batch:  # type: ignore
        """Pipelined forward with no gradients: scatter, schedule,
        gather.  The name is the reference's entry point; it shadows
        ``nn.Module.apply(fn)``, so a callable (as a parent module's
        ``apply(init_fn)`` passes down) goes to ``nn.Module.apply``."""
        if callable(x):
            return super().apply(x)
        outs = self._pipeline.run_forward(microbatch.scatter(x, self.chunks))
        return microbatch.gather(outs)

    def forward(self, x: microbatch.Batch) -> microbatch.Batch:
        return self.apply(x)

    def value_and_grad(
        self,
        x: microbatch.Batch,
        target: Any,
        loss_fn: Callable[..., Any],
        *,
        rng: Any = None,
    ) -> Tuple[torch.Tensor, Tuple[List[dict], ...], Any]:
        """Pipelined training step: forward, loss, backward.

        ``loss_fn(output, target)`` sees the gathered mini-batch output,
        so loss and gradients are those of the unpipelined model; it may
        return ``(loss, aux)``.  Returns ``(loss, grads, aux)`` with
        ``grads`` a tuple over stages of lists over layers of
        ``{param name: param.grad}``."""
        if rng is not None:
            raise not_ported(
                "value_and_grad(rng=...) (per-micro-batch RNG)", _SLICE
            )
        mbatches = microbatch.scatter(x, self.chunks)
        stop = checkpoint_stop(self.checkpoint, len(mbatches), train=True)
        for p in self.parameters():
            p.grad = None
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

    def make_train_step(self, *args: Any, **kwargs: Any) -> Any:
        raise not_ported("GPipe.make_train_step (per-stage torch.optim)", _SLICE)

    def value_and_grad_with_loss_params(self, *args: Any, **kwargs: Any) -> Any:
        raise not_ported(
            "GPipe.value_and_grad_with_loss_params (parametric loss layers)", _SLICE
        )
