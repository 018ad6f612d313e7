"""Guarded training steps: skip bad updates, retry transient failures.

Counterpart of ``torchgpipe_tpu/resilience/guard.py``: ``classify_error``,
``GuardPolicy``, ``GuardStats`` and ``StepGuard``.  The serving engine
also retries its steps under the first two (``Engine._dispatch``).

The classification is keyed on what a CUDA process raises:

* transient (a retry can succeed): ``ConnectionError`` and its
  subclasses, ``TimeoutError``, and ``torch.cuda.OutOfMemoryError``
  (the caching allocator's counterpart of XLA's ``RESOURCE_EXHAUSTED``:
  freed blocks return once the stream drains);
* fatal: everything else, a CUDA runtime or launch error included (the
  context is lost; no retry in the same process can succeed), and a
  :class:`~torchgpipe_tpu_torch.distributed.context.PeerDiedError`
  although it is a ``TimeoutError`` (a dead rank leaves stale channels:
  restart the workers, do not retry the step).

:class:`StepGuard` wraps a step of ``GPipe.make_train_step``, which
updates parameters, optimizer state and buffers in place, so a skipped
step cannot hand back the old ones as the reference's returns them.  The
guard snapshots them before the step
(:class:`~torchgpipe_tpu_torch.gpipe.StateSnapshot`, the megastep's own
skip-step) and puts them back, bitwise, when the step is not finite or
before a transient retry.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torchgpipe_tpu_torch.obs.registry import MetricsRegistry
from torchgpipe_tpu_torch.obs.registry import counter_property as _counter_property


def classify_error(err: BaseException) -> str:
    """``'transient'`` (retry can help) or ``'fatal'`` (re-raise now)."""
    from torchgpipe_tpu_torch.distributed.context import PeerDiedError

    if isinstance(err, PeerDiedError):
        return "fatal"
    if isinstance(err, (ConnectionError, TimeoutError, torch.cuda.OutOfMemoryError)):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Knobs for :class:`StepGuard` (defaults are the reference's)."""

    max_retries: int = 3          # transient retries per step
    backoff_base: float = 0.25    # seconds; doubles per attempt
    backoff_max: float = 8.0      # cap on a single sleep
    skip_nonfinite: bool = True   # skip-step on non-finite loss/params

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base * (2.0 ** attempt), self.backoff_max)


class GuardStats:
    """The guard's counters on a
    :class:`~torchgpipe_tpu_torch.obs.registry.MetricsRegistry`
    (``guard_steps``, ``guard_skipped``, ``guard_retries``,
    ``guard_errors{classification, error}``, ``guard_peer_died{rank}``),
    read and ``+=``-assigned as plain ints through ``steps``, ``skipped``
    and ``retries``.  One guard per shared registry."""

    def __init__(self, registry: Any = None) -> None:
        self.registry = registry or MetricsRegistry()
        self._steps = self.registry.counter(
            "guard_steps", help="successful (applied) steps")
        self._skipped = self.registry.counter(
            "guard_skipped", help="non-finite steps skipped")
        self._retries = self.registry.counter(
            "guard_retries", help="transient retries performed")
        self._errors = self.registry.counter(
            "guard_errors",
            help="step exceptions seen, by classification and type",
            labels=("classification", "error"),
        )
        self._peer_died = self.registry.counter(
            "guard_peer_died",
            help="PeerDiedError occurrences by offending rank",
            labels=("rank",),
        )

    steps = _counter_property("_steps")
    skipped = _counter_property("_skipped")
    retries = _counter_property("_retries")

    def record_error(self, classification: str, err: BaseException) -> None:
        """Count one step exception under its classification and type; a
        ``PeerDiedError`` also names its dead rank in ``guard_peer_died``."""
        self._errors.inc(classification=classification, error=type(err).__name__)
        rank = getattr(err, "rank", None)
        if rank is not None:
            self._peer_died.inc(rank=str(rank))

    def __repr__(self) -> str:
        return (f"GuardStats(steps={self.steps}, skipped={self.skipped}, "
                f"retries={self.retries})")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, GuardStats):
            return NotImplemented
        return (self.steps, self.skipped, self.retries) == (
            other.steps, other.skipped, other.retries)


def _all_finite(tree: Any) -> torch.Tensor:
    """A host bool tensor: every floating tensor of ``tree`` finite.  Each
    device reduces its own tensors; one host read per device."""
    from torchgpipe_tpu_torch.gpipe import _all_finite as device_all_finite
    from torchgpipe_tpu_torch.gpipe import _tensors

    by_device: Dict[torch.device, List[torch.Tensor]] = {}
    for t in _tensors(tree):
        if t.is_floating_point():
            by_device.setdefault(t.device, []).append(t)
    oks = [device_all_finite(ts).cpu() for ts in by_device.values()]
    return torch.stack(oks).all() if oks else torch.tensor(True)


class StepGuard:
    """Wrap a ``make_train_step`` step with the skip and retry policies.

    Example::

        step = pipe.make_train_step(partial(torch.optim.SGD, lr=0.1), loss_fn)
        guard = StepGuard(step, loss_scale=DynamicLossScale())
        for x, y in data:
            loss, aux = guard(x, y)
            # a skipped step returns its non-finite loss and leaves the
            # parameters, optimizer state and buffers as they were;
            # guard.stats.skipped counts it, guard.loss_scale backs off.

    The guard calls ``step(*args, **kwargs)`` and returns its output.
    The state it protects is ``step.pipe``'s parameters and buffers and
    ``step.optimizers``' state (as ``make_train_step`` attaches them),
    and the tensors of the arguments at ``extra_state_argnums`` (state a
    step threads through its arguments and updates in place); a callable
    without ``pipe`` protects only those.  They are copied before each
    step, so the guard holds one more copy of them.

    ``finite_of(outputs) -> tree`` sets what the finite check covers
    (default: the outputs and every protected tensor).  ``on_event(kind,
    info)`` observes the ``'skip'`` and ``'retry'`` decisions.  A
    ``megastep > 1`` step skips inside its graph and returns the
    per-step mask last; the guard folds the mask into its statistics and
    backs the loss scale off once per megastep holding a skip.  A
    transient error puts the protected state back before the retry.

    Map onto the reference: its ``guard(params, opt_state, *data) ->
    (loss, params, opt_state, *extras)`` is ``guard(*data) -> (loss,
    aux)`` here, the parameters and optimizer state being the pipe's own;
    its donated-buffer check has no counterpart.
    """

    def __init__(
        self,
        step: Callable[..., Tuple],
        *,
        loss_scale: Any = None,
        policy: Optional[GuardPolicy] = None,
        finite_of: Optional[Callable[[Tuple], Any]] = None,
        extra_state_argnums: Tuple[int, ...] = (),
        classify: Callable[[BaseException], str] = classify_error,
        sleep: Callable[[float], None] = time.sleep,
        on_event: Optional[Callable[[str, dict], None]] = None,
        registry: Any = None,
    ) -> None:
        self._step = step
        self.loss_scale = loss_scale
        self.policy = policy or GuardPolicy()
        self._finite_of = finite_of
        self.extra_state_argnums = tuple(extra_state_argnums)
        self._classify = classify
        self._sleep = sleep
        self._on_event = on_event
        self.stats = GuardStats(registry)

    def _event(self, kind: str, **info: Any) -> None:
        if self._on_event is not None:
            self._on_event(kind, info)

    def _snapshot(self, args: Tuple) -> Any:
        from torchgpipe_tpu_torch.gpipe import StateSnapshot, _tensors

        extra = [t for n in self.extra_state_argnums for t in _tensors(args[n])]
        pipe = getattr(self._step, "pipe", None)
        if pipe is None:
            return StateSnapshot(torch.nn.Module(), [], extra)
        return StateSnapshot(pipe, getattr(self._step, "optimizers", ()), extra)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        megastep = int(getattr(self._step, "megastep", 1) or 1)
        snap = self._snapshot(args)
        if megastep == 1:
            snap.take()
        out = self._call_with_retries(snap if megastep == 1 else None, args, kwargs)
        loss = out[0] if isinstance(out, tuple) else out
        if megastep > 1:
            # The graph skipped non-finite inner steps itself and returns
            # its per-step mask last: count them, whatever the policy.
            mask = out[-1].detach().cpu().bool().reshape(-1)
            skipped = int(mask.numel() - mask.sum())
            self.stats.steps += int(mask.sum())
            if skipped:
                self.stats.skipped += skipped
                if self.loss_scale is not None:
                    self.loss_scale = self.loss_scale.bad()
                self._event("skip", loss=loss, skipped=self.stats.skipped,
                            megastep=megastep, loss_scale=self._scale())
            elif self.loss_scale is not None:
                self.loss_scale = self.loss_scale.ok()
            return out
        if self.policy.skip_nonfinite:
            checked = self._finite_of(out) if self._finite_of is not None else \
                (out, snap.tensors())
            ok = _all_finite(checked)   # the guard's host read
            if not bool(ok):
                snap.select(ok, eager=True)
                self.stats.skipped += 1
                if self.loss_scale is not None:
                    self.loss_scale = self.loss_scale.bad()
                self._event("skip", loss=loss, skipped=self.stats.skipped,
                            loss_scale=self._scale())
                return out
        if self.loss_scale is not None:
            self.loss_scale = self.loss_scale.ok()
        self.stats.steps += 1
        return out

    def _scale(self) -> Optional[float]:
        return self.loss_scale.scale if self.loss_scale is not None else None

    def _call_with_retries(self, snap: Any, args: Tuple, kwargs: Dict) -> Any:
        attempt = 0
        while True:
            try:
                return self._step(*args, **kwargs)
            except Exception as err:  # noqa: BLE001 — classified below
                classification = self._classify(err)
                self.stats.record_error(classification, err)
                if classification != "transient" or attempt >= self.policy.max_retries:
                    if attempt > 0:
                        err.add_note(
                            f"StepGuard: giving up after {attempt} transient "
                            "retr" + ("y" if attempt == 1 else "ies"))
                    raise
                if snap is not None:
                    # The failed attempt may have updated some state.
                    snap.select(torch.tensor(False), eager=True)
                delay = self.policy.backoff(attempt)
                attempt += 1
                self.stats.retries += 1
                self._event("retry", attempt=attempt, delay=delay,
                            error=type(err).__name__)
                self._sleep(delay)


__all__ = ["GuardPolicy", "GuardStats", "StepGuard", "classify_error"]
