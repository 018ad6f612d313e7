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

``fused=True`` runs each step (``apply``, ``value_and_grad``, and
``make_train_step``'s step with the optimizers, ``megastep`` steps at a
time) as one CUDA graph on the card: the first call with a new key
(input shapes and dtypes, the loss function, the checkpoint stop) runs
the step eagerly as the capture's warm-up and returns its result, and
captures it; every later call copies its inputs into the graph's static
buffers and replays.  A replay returns the graph's static tensors (the
next replay overwrites them) and leaves them in each parameter's
``.grad``.  The graph reads and updates the parameters, buffers and
optimizer states in place, at fixed addresses: load new values into
them with ``copy_`` (``nn.Module.load_state_dict`` does), never by
swapping tensors.  On the CPU the same step body runs eagerly.
``compute_dtype`` applies :func:`~torchgpipe_tpu_torch.precision.apply_policy`
to the layers (after the deferred batch norm conversion).

``rng=`` (an int seed or a key tensor, :mod:`torchgpipe_tpu_torch.rng`)
gives each micro-batch ``i`` the key ``fold_in(rng, i)`` and each layer
``fold_in(rng_i, layer index)``: the dropouts of ``ops.nn`` draw their
masks from it, so a checkpointed cell's recompute, the 1F1B schedule and
a captured step's replay draw the same masks.  Under ``fused=True`` the
key is one of the graph's static inputs: a replay takes a new key with
no second capture.  A parameter with ``requires_grad=False`` (frozen,
as :func:`~torchgpipe_tpu_torch.models.lora.lora_optimizer` leaves the
base weights of a LoRA model) gets no ``.grad`` and no entry in
``grads``.  ``tracer`` (:class:`~torchgpipe_tpu_torch.utils.tracing.Timeline`)
records every cell of the per-cell scheduler.

Example::

    model = GPipe(llama(cfg), balance=[34], chunks=4)
    loss, grads, aux = model.value_and_grad(tokens, tokens, causal_lm_loss)
    step = model.make_train_step(partial(torch.optim.SGD, lr=0.1), loss_fn)
    loss, aux = step(tokens, tokens)
    out = model.apply(tokens)
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from torchgpipe_tpu_torch import graphs, microbatch
from torchgpipe_tpu_torch import rng as _rng
from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
from torchgpipe_tpu_torch import checkpoint as _ckpt
from torchgpipe_tpu_torch.checkpoint import CHECKPOINT_MODES, Offload, checkpoint_stop
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    resolve_device,
)
from torchgpipe_tpu_torch.partition import Stage, split_layers, verify_module
from torchgpipe_tpu_torch.pipeline import Pipeline
from torchgpipe_tpu_torch.precision import apply_policy
from torchgpipe_tpu_torch.resilience import faults as _faults
from torchgpipe_tpu_torch.skip import inspect_skip_layout, verify_skippables

_GRAPH_CACHE = 8   # captured graphs kept per pipe (the reference's jit cache)


def _torch_dropout(layers: Sequence[nn.Module]) -> Optional[str]:
    """The first ``torch.nn`` dropout module with a non-zero rate (by
    name), or None.  It draws from the global generator, which neither a
    recomputed cell nor a graph replay can draw from again."""
    for i, layer in enumerate(layers):
        for name, mod in layer.named_modules():
            if isinstance(mod, nn.modules.dropout._DropoutNd) and mod.p > 0:
                return f"layer {i} ({name or type(mod).__name__})"
    return None


def _key(rng: Any) -> Optional[torch.Tensor]:
    return None if rng is None else _rng.key_tensor(rng)


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One device bool: every floating tensor all finite (no host sync)."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all()


def _opt_tensors(optimizers: Sequence[torch.optim.Optimizer]) -> List[torch.Tensor]:
    return [v for opt in optimizers for st in opt.state.values()
            for v in st.values() if isinstance(v, torch.Tensor)]


class StateSnapshot:
    """Copies of a module's parameters and buffers, its optimizers' state
    tensors and any ``extra`` tensors, taken before a step
    (:meth:`take`) and put back where the step was not finite
    (:meth:`select`): the skip-step of a megastep and of
    :class:`~torchgpipe_tpu_torch.resilience.guard.StepGuard`.  A copy
    keeps its address from one take to the next, so a captured graph
    reads and writes the same copies at every replay."""

    def __init__(self, module: nn.Module, optimizers: Sequence[torch.optim.Optimizer],
                 extra: Sequence[torch.Tensor] = ()) -> None:
        self.module, self.optimizers, self.extra = module, list(optimizers), list(extra)
        self._copies: Dict[int, torch.Tensor] = {}
        self._state: List[torch.Tensor] = []
        self._had: List[set] = []

    def tensors(self) -> List[torch.Tensor]:
        return (list(self.module.parameters()) + _opt_tensors(self.optimizers)
                + list(self.module.buffers()) + self.extra)

    def take(self) -> None:
        self._state = self.tensors()
        with torch.no_grad():
            for t in self._state:
                if id(t) not in self._copies:
                    self._copies[id(t)] = torch.empty_like(t)
                self._copies[id(t)].copy_(t)
        self._had = [set(opt.state) for opt in self.optimizers]

    def select(self, ok: torch.Tensor, eager: bool) -> None:
        """Every tensor of the last take becomes ``where(ok, itself,
        copy)``, on the device with no host sync.  Optimizer state that
        the step created is dropped again where ``ok`` is false, which
        only an ``eager`` caller may read on the host."""
        with torch.no_grad():
            for t in self._state:
                cond = ok if t.device == ok.device else ok.to(t.device)
                torch.where(cond, t, self._copies[id(t)], out=t)
        fresh = [(opt, p) for opt, had in zip(self.optimizers, self._had)
                 for p in opt.state if p not in had]
        if fresh and eager and not bool(ok):
            for opt, p in fresh:
                del opt.state[p]


def _check_capturable(optimizers: Sequence[torch.optim.Optimizer]) -> None:
    """An optimizer with a host-side step count (those with a
    ``capturable`` option) must keep it on the device to be captured."""
    for opt in optimizers:
        if "capturable" in opt.defaults and not all(
                g.get("capturable", False) for g in opt.param_groups):
            raise ValueError(
                f"fused=True captures the optimizer step in the CUDA graph, and "
                f"{type(opt).__name__} keeps its step count on the host unless it "
                f"is built with capturable=True: pass e.g. functools.partial("
                f"torch.optim.{type(opt).__name__}, capturable=True)"
            )


def _refuse_shared_params(partitions: Sequence[nn.Module]) -> None:
    """A parameter held by two stages (a tied embedding across a cut)
    would be stepped by each stage's optimizer: refuse it."""
    owner: Dict[int, int] = {}
    for j, part in enumerate(partitions):
        for p in part.parameters():
            i = owner.setdefault(id(p), j)
            if i != j:
                raise ValueError(
                    f"a parameter of shape {tuple(p.shape)} is held by stages {i} "
                    f"and {j} (a tied embedding and head?): each stage's "
                    "optimizer would step it and its two gradients would not "
                    "be summed; keep both layers in one stage, or untie "
                    "(tie_embeddings=False)"
                )


class _Graph:
    """One captured step: the graph, its static inputs and outputs, and
    the static gradient of each parameter (and an offload remat policy's
    pinned host buffers)."""

    def __init__(self, graph: Any, inputs: graphs.StaticTree, outputs: Any,
                 grads: List[Tuple[nn.Parameter, Optional[torch.Tensor]]],
                 host: Optional[_ckpt.HostBuffers] = None) -> None:
        self.graph, self.inputs, self.outputs, self.grads = graph, inputs, outputs, grads
        self.host = host   # an offload policy's pinned buffers, which every replay copies through


class GPipe(nn.Module):
    """Pipeline parallelism over a sequential layer list.

    ``balance`` splits the layers into stages; stage ``j`` lives on
    ``devices[j % len(devices)]`` (default ``[cuda]``), so an n-stage
    pipeline runs, serialized, on one card.  A mini-batch is scattered
    into ``chunks`` micro-batches (``torch.chunk`` sizes) and driven
    through the ``schedule``: ``'gpipe'`` (fill-drain, the loss on the
    gathered mini-batch) or ``'1f1b'`` (the loss per micro-batch, summed
    with ``loss_reduction`` ``'mean'`` or ``'sum'`` weights).
    ``checkpoint`` is one of ``'always'``, ``'except_last'`` (default),
    ``'never'`` or ``'offload'`` (``'never'`` with each cell's saved
    tensors in pinned host memory between its forward and backward).
    ``deferred_batch_norm=True`` converts every
    :class:`~torchgpipe_tpu_torch.ops.nn.BatchNorm` to its deferred twin
    (:mod:`torchgpipe_tpu_torch.batchnorm`); ``compute_dtype`` (e.g.
    ``torch.bfloat16``) computes in that dtype over the layers' own
    master parameters (:mod:`torchgpipe_tpu_torch.precision`).
    ``fused=True`` runs every step as one captured CUDA graph (all
    stages on one device, fill-drain only), and ``megastep=K`` is
    :meth:`make_train_step`'s default number of optimizer steps per
    graph.  ``remat_policy`` (``fused=True``; a
    :data:`~torchgpipe_tpu_torch.checkpoint.policies` preset) refines the
    checkpointed cells: each keeps what the policy names in its forward
    and its recompute takes it back (``remat_stats`` has the bytes).
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
        compute_dtype: Optional[torch.dtype] = None,
        fused: bool = False,
        schedule: str = "gpipe",
        loss_reduction: Optional[str] = None,
        megastep: int = 1,
        tracer: Any = None,
        hbm_budget_bytes: Optional[int] = None,
        remat_policy: Any = None,
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
        self._deferred_batch_norm = deferred_batch_norm
        if deferred_batch_norm:
            layers = convert_deferred_batch_norm(layers, chunks)
        if compute_dtype is not None:
            # After the deferred conversion, so the converted norms run
            # in float32 too (the reference's order).
            layers = apply_policy(layers, compute_dtype)
        self.compute_dtype = compute_dtype

        self.balance = list(balance)
        self.chunks = chunks
        self.checkpoint = checkpoint
        self.schedule = schedule
        self.loss_reduction = loss_reduction
        # Declared per-device memory budget in bytes, stored as the
        # reference stores it; its readers (the schedule verifier, the
        # planner) are ROADMAP.md queue A item 5.6.
        self.hbm_budget_bytes = hbm_budget_bytes
        parts = split_layers(layers, self.balance)
        self.skip_layout = inspect_skip_layout(parts)
        if devices is None:
            devices = [resolve_device(None)]
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[j % len(devices)] for j in range(len(parts))]
        offsets = [sum(self.balance[:j]) for j in range(len(parts))]
        self.partitions = nn.ModuleList(
            Stage(part, j, self.skip_layout, offsets[j]).to(dev)
            for j, (part, dev) in enumerate(zip(parts, self.devices))
        )
        _refuse_shared_params(self.partitions)
        self.tracer = tracer
        self._validate_fused(fused, schedule, checkpoint, megastep, tracer, remat_policy)
        random = _torch_dropout(layers)
        if random is not None and (fused or checkpoint in ("always", "except_last")):
            where = "a captured (fused) step" if fused else "a recomputed pipeline cell"
            raise ValueError(
                f"a random layer in {where} ({random}) must draw the same mask "
                "again, and a torch.nn dropout draws from the global generator; "
                "use torchgpipe_tpu_torch.ops.nn.Dropout / Dropout2d, which take "
                "the pipeline's per-micro-batch key (rng=)"
            )
        self.fused = fused
        self.remat_policy = remat_policy
        self.megastep = megastep
        self._layers = layers
        self._pipeline = Pipeline(list(self.partitions), self.devices, self.skip_layout,
                                  tracer)
        self._graphs: Dict[Any, _Graph] = {}
        self._graph_pool: Any = None
        # Captures made and their wall seconds (warm-up included); replays.
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        # Bytes of the last 'offload' step (checkpoint.Offload).
        self.offload_stats = {"saved_bytes": 0, "moved_bytes": 0}
        # Bytes the remat policy kept in the last step (checkpoint.Remat).
        self.remat_stats = {"saved_bytes": 0}
        # An offload policy's pinned buffers while a step is warmed up and captured.
        self._remat_host: Optional[_ckpt.HostBuffers] = None

    def _validate_fused(self, fused: bool, schedule: str, checkpoint: str,
                        megastep: Any, tracer: Any, remat_policy: Any) -> None:
        """The reference's checks of ``fused``, ``'offload'``,
        ``remat_policy`` and ``megastep`` (its messages word for word),
        then that the policy is one the port applies."""
        if fused and schedule == "1f1b":
            raise ValueError(
                "fused=True compiles the whole fill-drain step into one "
                "program; it cannot express the 1F1B schedule. Drop "
                "fused=True (1f1b runs on the per-cell scheduler) or use "
                "schedule='gpipe'"
            )
        if fused:
            if len(set(self.devices)) > 1:
                raise ValueError(
                    "fused=True requires all stages on one device (the fused "
                    "path compiles the whole step into a single program); "
                    "pass devices=[one_device] or drop fused=True for the "
                    "per-cell multi-device scheduler"
                )
            if tracer is not None:
                raise ValueError(
                    "fused=True compiles the step into one program, so a "
                    "per-cell tracer would record nothing; drop the tracer "
                    "or pass fused=False"
                )
        if checkpoint == "offload":
            if fused:
                raise ValueError(
                    "checkpoint='offload' is a per-cell scheduler feature "
                    "(residuals are program outputs the engine moves to "
                    "host memory); with fused=True pass a "
                    "remat_policy=checkpoint.policies.offload_names(...) "
                    "instead, or drop fused=True"
                )
            if schedule != "gpipe":
                raise ValueError(
                    "checkpoint='offload' supports the fill-drain "
                    "('gpipe') schedule only — 1F1B already bounds "
                    "in-flight residuals at the pipeline depth"
                )
        if remat_policy is not None and not fused:
            raise ValueError(
                "remat_policy refines the FUSED path's per-cell "
                "jax.checkpoint (GPipe(fused=True, remat_policy=...)); "
                "the per-cell scheduler's checkpointed cells keep no "
                "residuals at all (recompute-ahead), so a save policy "
                "cannot apply — drop remat_policy, or use fused=True / "
                "the SPMD engine's SpmdGPipe.remat_policy"
            )
        if remat_policy is not None and checkpoint == 'never':
            raise ValueError(
                "remat_policy has no effect under checkpoint='never' "
                "(no cell is rematerialized)"
            )
        if not (isinstance(megastep, int) and not isinstance(megastep, bool)
                and megastep >= 1):
            raise ValueError(f"megastep must be an int >= 1, got {megastep!r}")
        if megastep > 1 and not fused:
            raise ValueError(
                "megastep compiles K optimizer steps into ONE program "
                "(lax.scan over the full step), which needs the whole step "
                "to BE one program: the per-cell scheduler dispatches each "
                "cell separately across stage devices and cannot be "
                "scanned.  Pass fused=True (single-device), or use the "
                "SPMD engine (SpmdGPipe.megastep), or megastep=1"
            )
        _ckpt.check_policy(remat_policy)

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

    def apply(self, x: microbatch.Batch, *, rng: Any = None,  # type: ignore
              train: bool = False) -> microbatch.Batch:
        """Pipelined forward with no gradients: scatter, schedule,
        gather.  Every layer is in eval mode (BatchNorm reads its running
        statistics) unless ``train`` (dropouts then draw from ``rng``'s
        per-micro-batch keys).  The name is the reference's entry point;
        it shadows ``nn.Module.apply(fn)``, so a callable (as a parent
        module's ``apply(init_fn)`` passes down) goes to
        ``nn.Module.apply``."""
        if callable(x):
            return super().apply(x)

        def body(inp: Any) -> Any:
            x, key = inp
            with self._mode(train):
                outs = self._pipeline.run_forward(
                    microbatch.scatter(x, self.chunks), self._key_of(key))
            return microbatch.gather(outs)

        return self._run(("apply", train), (x, _key(rng)), body)

    def forward(self, x: microbatch.Batch) -> microbatch.Batch:
        return self.apply(x)

    def _key_of(self, key: Optional[torch.Tensor]) -> Optional[_rng.Key]:
        """The step's key on the first stage's device (a captured step
        reads it from its static input)."""
        return None if key is None else _rng.Key(key.to(self.devices[0]))

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
        of lists over layers of ``{param name: param.grad}`` (trainable
        parameters only); running statistics are updated in their
        buffers.  ``rng`` keys the dropouts (see the module doc)."""
        stop = self._split_microbatches(x)[1]
        return self._run(("value_and_grad", loss_fn, stop), (x, target, _key(rng)),
                         lambda inp: self._train_body(*inp, loss_fn))

    def _train_body(
        self, x: Any, target: Any, key: Optional[torch.Tensor],
        loss_fn: Callable[..., Any],
    ) -> Tuple[torch.Tensor, Tuple[List[dict], ...], Any]:
        """One ``value_and_grad``, as it runs eagerly and as it is
        captured."""
        mbatches, stop = self._split_microbatches(x)
        rng = self._key_of(key)
        for p in self.parameters():
            p.grad = None
        with self._mode(True):
            if self.schedule == "1f1b":
                loss, aux = self._run_1f1b(mbatches, target, loss_fn, stop, rng)
            else:
                offload = Offload() if self.checkpoint == "offload" else None
                remat = None if self.remat_policy is None else _ckpt.Remat(
                    self.remat_policy, self._remat_host)
                loss, aux = self._pipeline.run_train(
                    mbatches, target, loss_fn, stop, offload, rng, remat)
                if remat is not None:
                    self.remat_stats = {"saved_bytes": remat.saved_bytes}
                if offload is not None:
                    self.offload_stats = {"saved_bytes": offload.saved_bytes,
                                          "moved_bytes": offload.moved_bytes}
        grads = []
        for part in self.partitions:
            stage = []
            for layer in part:
                named = {}
                for name, p in layer.named_parameters():
                    if not p.requires_grad:
                        continue
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    named[name] = p.grad
                stage.append(named)
            grads.append(stage)
        return loss, tuple(grads), aux

    def _run(self, key: Tuple, inputs: Any, body: Callable[[Any], Any],
             warmup: Optional[Callable[[Any], Any]] = None) -> Any:
        """``body(inputs)``: eagerly off the card or without ``fused``;
        under ``fused`` on the card, as a replay of the graph captured
        for ``key`` and the inputs' shapes and dtypes.  The first call
        for a key runs ``warmup`` (default: ``body``) eagerly on static
        copies of the inputs, returns its result, and captures ``body``.
        A capture that fails raises: nothing drops to the eager path."""
        device = self.devices[0]
        if not self.fused or device.type != "cuda":
            return (warmup or body)(inputs)
        key = key + (graphs.tensor_key(inputs), _faults.plan_token())
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, inputs, body, warmup or body, device)
        entry.inputs.load(inputs)
        entry.graph.replay()
        for p, g in entry.grads:
            p.grad = g
        self.graph_stats["replays"] += 1
        return entry.outputs

    def _capture(self, key: Tuple, inputs: Any, body: Callable[[Any], Any],
                 warmup: Callable[[Any], Any], device: torch.device) -> Any:
        t0 = time.perf_counter()
        static = graphs.StaticTree(inputs, device)
        static.load(inputs)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        params = list(self.parameters())
        box: Dict[str, Any] = {}

        def run_warmup() -> Any:
            out = warmup(static.value)
            return out, [p.grad for p in params]

        def run_body() -> None:
            box["out"] = body(static.value)
            box["grads"] = [p.grad for p in params]

        offload = self.remat_policy is not None and self.remat_policy.offload
        host = self._remat_host = _ckpt.HostBuffers() if offload else None
        try:
            graph, (result, grads) = graphs.capture(
                run_body, device, self._graph_pool, warmup=run_warmup)
        finally:
            self._remat_host = None
        # Capture ran the body's Python without running its kernels: the
        # parameters keep the warm-up's gradients for this call's result.
        for p, g in zip(params, grads):
            p.grad = g
        while len(self._graphs) >= _GRAPH_CACHE:
            self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = _Graph(graph, static, box["out"],
                                   list(zip(params, box["grads"])), host)
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        return result

    def _run_1f1b(
        self, mbatches: List, target: Any, loss_fn: Callable[..., Any], stop: int,
        rng: Optional[_rng.Key],
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
            mbatches, target_mbs, loss_fn, stop, weights, rng
        )

    def init_opt_state(
        self, optimizer: Callable[[Any], torch.optim.Optimizer]
    ) -> Tuple[torch.optim.Optimizer, ...]:
        """One optimizer per stage, ``optimizer(stage parameters)``, each
        over the parameters on its stage's device (the reference's
        per-stage optax states)."""
        return tuple(optimizer(list(part.parameters())) for part in self.partitions)

    def megastep_boundary(self, step: int) -> bool:
        """True when ``step`` completed optimizer steps land on a
        megastep boundary: the cadence at which checkpoint and
        preemption hooks run (nothing can land inside a captured K-step
        graph)."""
        k = max(int(self.megastep or 1), 1)
        return step % k == 0

    def make_train_step(
        self,
        optimizer: Callable[[Any], torch.optim.Optimizer],
        loss_fn: Callable[..., Any],
        *,
        megastep: Optional[int] = None,
    ) -> Callable[..., Any]:
        """Training step with the optimizer applied per stage.

        ``optimizer`` maps an iterable of parameters to a
        ``torch.optim.Optimizer``, for example
        ``functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)``; it
        is called once per stage here (:meth:`init_opt_state`).  Returns
        ``step(x, target, rng=None) -> (loss, aux)``: ``value_and_grad``
        (with ``rng``), then every stage's ``optimizer.step()``.  The update is in place,
        so the reference's ``donate`` has no counterpart; the optimizers
        are ``step.optimizers`` and the pipe ``step.pipe`` (what
        :class:`~torchgpipe_tpu_torch.resilience.guard.StepGuard`
        snapshots).  Under ``fused=True`` on the card the
        whole step, optimizers included, is one CUDA graph, so an
        optimizer that keeps a step count must be built with
        ``capturable=True``.

        ``megastep=K`` (default: the pipe's ``megastep``; ``K > 1`` needs
        ``fused=True``) runs K steps per call, one graph on the card:
        ``step(xs, targets, rng=None) -> (loss[K], aux, finite[K])`` over
        ``[K, ...]``-stacked batches, ``aux`` stacked the same way; inner
        step ``k`` runs with the key ``fold_in(rng, k)``.
        Parameters and optimizer states are updated in place, not
        returned, and no ``.grad`` is left behind.  An inner step whose
        output (loss, parameters, optimizer state, buffers, aux) is not
        all finite is skipped: it leaves parameters, optimizer state and
        buffers bitwise as they were before it (pre-step snapshots,
        selected on the device, with no host sync)."""
        k = self.megastep if megastep is None else int(megastep)
        if k < 1:
            raise ValueError(f"megastep must be >= 1, got {k}")
        if k > 1 and not self.fused:
            raise ValueError(
                "make_train_step(megastep>1) needs GPipe(fused=True): "
                "the per-cell scheduler dispatches each cell separately "
                "and cannot be compiled into one scanned program; use "
                "fused=True or the SPMD engine"
            )
        optimizers = self.init_opt_state(optimizer)
        if self.fused and self.devices[0].type == "cuda":
            _check_capturable(optimizers)
        token = object()   # this step's graphs are its own

        def one(x: Any, target: Any, key: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Any]:
            loss, _, aux = self._train_body(x, target, key, loss_fn)
            for opt in optimizers:
                opt.step()
            return loss, aux

        if k == 1:
            def step(x: Any, target: Any, rng: Any = None) -> Tuple[torch.Tensor, Any]:
                stop = self._split_microbatches(x)[1]
                return self._run(("step", token, stop), (x, target, _key(rng)),
                                 lambda inp: self._guard_state(optimizers, one, *inp),
                                 warmup=lambda inp: one(*inp))
        else:
            snap = StateSnapshot(self, optimizers)

            def step(xs: Any, targets: Any, rng: Any = None) -> Tuple[Any, ...]:
                for leaf in _tensors(xs):
                    if leaf.shape[:1] != (k,):
                        raise ValueError(
                            f"megastep={k} consumes [K, ...]-stacked batches "
                            f"(K steps in one program), got a leading dim of "
                            f"{leaf.shape[0]} — stack K per-step batches with "
                            "torch.stack, or pass megastep=1"
                        )
                    break
                inner = pytree.tree_map(
                    lambda t: t[0] if isinstance(t, torch.Tensor) else t, xs)
                stop = self._split_microbatches(inner)[1]
                return self._run(
                    ("megastep", token, stop), (xs, targets, _key(rng)),
                    lambda inp: self._guard_state(
                        optimizers, self._megastep_body, k, optimizers, one, snap,
                        False, *inp),
                    warmup=lambda inp: self._megastep_body(
                        k, optimizers, one, snap, True, *inp))

        step.pipe = self  # type: ignore[attr-defined]
        step.optimizers = optimizers  # type: ignore[attr-defined]
        step.megastep = k  # type: ignore[attr-defined]
        return step

    @staticmethod
    def _guard_state(optimizers: Sequence[torch.optim.Optimizer],
                     fn: Callable[..., Any], *args: Any) -> Any:
        """``fn(*args)``, raising if it created optimizer state: a graph
        that creates state would create it again at every replay."""
        before = len(_opt_tensors(optimizers))
        out = fn(*args)
        if len(_opt_tensors(optimizers)) != before:
            raise RuntimeError(
                "the optimizer created its state inside a captured step; it "
                "must exist before the capture (the first, eager call of a "
                "fused step creates it unless every step of that call was "
                "skipped as non-finite)"
            )
        return out

    def _megastep_body(
        self, k: int, optimizers: Sequence[torch.optim.Optimizer],
        one: Callable[[Any, Any, Any], Tuple[torch.Tensor, Any]],
        snap: StateSnapshot, eager: bool, xs: Any, targets: Any,
        key: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """K inner steps with the skip-step select (:class:`StateSnapshot`):
        before each, every parameter, optimizer state tensor and buffer
        is copied into its snapshot; after it, ``where(finite, new,
        snapshot)``.  Only an eager call may find optimizer state created
        by a skipped step (the very first steps of a fresh optimizer); it
        drops that state again, which reads ``finite`` on the host."""
        losses, auxes, oks = [], [], []
        for i in range(k):
            x, target = pytree.tree_map(
                lambda t: t[i] if isinstance(t, torch.Tensor) else t, (xs, targets))
            snap.take()
            loss, aux = one(x, target, None if key is None else _rng.fold_in(key, i))
            ok = _all_finite([loss, *snap.tensors(), *_tensors(aux)])
            snap.select(ok, eager)
            losses.append(loss)
            auxes.append(aux)
            oks.append(ok)
        aux = None if auxes[0] is None else pytree.tree_map(
            lambda *ts: torch.stack(ts) if isinstance(ts[0], torch.Tensor) else list(ts),
            *auxes)
        for p in self.parameters():
            p.grad = None   # not part of the result: free them (in a graph, its pool)
        return torch.stack(losses), aux, torch.stack(oks)

    def value_and_grad_with_loss_params(
        self,
        x: microbatch.Batch,
        target: Any,
        loss_layer: nn.Module,
        *,
        rng: Any = None,
    ) -> Tuple[torch.Tensor, Tuple[List[dict], ...], dict, Any]:
        """Pipelined training step with a PARAMETRIC loss layer:
        ``loss_layer(gathered_output, target)`` (for example
        :func:`~torchgpipe_tpu_torch.models.transformer.chunked_lm_loss`,
        which owns the final norm and the head, so a model built with
        ``llama(cfg, head=False)`` never forms the ``[tokens, vocab]``
        logits) trains with the pipe.  The layer lives on the last
        stage's device.  Fill-drain only.  Returns ``(loss, grads,
        loss_grads, aux)``: ``loss_grads`` is ``{param name: .grad}`` of
        the layer's trainable parameters."""
        if self.schedule != "gpipe":
            raise ValueError(
                "value_and_grad_with_loss_params supports the fill-drain "
                f"('gpipe') schedule only (got schedule={self.schedule!r})"
            )
        if self.fused:
            raise ValueError(
                "value_and_grad_with_loss_params is not supported with "
                "fused=True (the fused program computes its loss inline); "
                "use the per-cell scheduler"
            )
        if list(loss_layer.buffers()):
            raise ValueError(
                f"parametric loss layer {type(loss_layer).__name__!r} must "
                "be stateless (its state updates would be silently dropped)"
            )
        params = [(n, p) for n, p in loss_layer.named_parameters() if p.requires_grad]
        for _, p in params:
            p.grad = None
        loss, grads, aux = self.value_and_grad(x, target, loss_layer, rng=rng)
        loss_grads = {}
        for n, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            loss_grads[n] = p.grad
        return loss, grads, loss_grads, aux
