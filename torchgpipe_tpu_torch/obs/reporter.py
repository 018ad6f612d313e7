"""Per-step training-loop telemetry: one object, one call per step.

Counterpart of ``torchgpipe_tpu/obs/reporter.py``.  The counters every
long training run needs, on the shared registry so they export next to
the serving and guard metrics:

* **step wall time** — a histogram (p50/p95/p99 catch stragglers and
  first-call captures that a mean hides);
* **throughput** — items (samples or tokens) per second, windowed over
  the last ``log_every`` steps;
* **measured MFU** — ``flops_per_step * real_token_fraction /
  (dt * peak)`` when both the counted step FLOPs
  (:func:`measured_step_flops`) and the card's published peak
  (:func:`~torchgpipe_tpu_torch.utils.hw.chip_peak_bf16_flops`) are
  known; omitted on the CPU.  ``real_token_fraction`` keeps ragged-data
  MFU honest: the counted FLOPs price padded shapes, so pad arithmetic
  is scaled OUT of the numerator;
* **guard counters** — skip/retry/loss-scale read from an attached
  :class:`~torchgpipe_tpu_torch.resilience.guard.StepGuard`.

``step()`` is host-side bookkeeping only (two clock reads, a histogram
observe).  Every ``log_every`` steps one structured (JSON) line goes to
``emit``.  The serving :class:`~torchgpipe_tpu_torch.serving.engine.
Engine` ticks one per engine iteration when built with ``reporter=``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional

import torch

from torchgpipe_tpu_torch.obs.registry import MetricsRegistry


def _to_meta(x: Any) -> Any:
    """``x`` with every tensor on the meta device (shapes only) and every
    module replaced by a meta copy; lists, tuples and dicts are walked."""
    from torch import nn

    from torchgpipe_tpu_torch.balance.profile import meta_sandbox

    if isinstance(x, nn.Module):
        return meta_sandbox(x)
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta").requires_grad_(x.requires_grad)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    return x


def measured_step_flops(
    fn: Callable[..., Any],
    *args: Any,
    real_token_fraction: float = 1.0,
) -> Optional[float]:
    """Counted FLOPs of one ``fn(*args)`` step, on the meta device.

    The reference walks the step's jaxpr (matmul and convolution FLOPs);
    here ``fn`` runs once under ``torch.utils.flop_counter.
    FlopCounterMode`` with every tensor and module of ``args`` replaced
    by a meta copy (shapes only: nothing executes on a device and the
    caller's modules are not touched), which counts the same operation
    classes (matmul, convolution, attention).  ``fn`` must reach its
    model through ``args``: a module it closes over stays on its own
    device.  Attention on meta tensors takes the plain version (the
    hand-written kernels are ``autograd.Function`` classes the counter does not
    see), so its score and value products are counted as the einsum
    matmuls they are — the full ``S x S`` square, causal mask or not,
    as the reference counts it.  Returns ``None`` (never raises) when
    the step cannot run on meta tensors.

    ``real_token_fraction`` scales the count to USEFUL flops.  ONE
    scaling site only: a result scaled here goes to
    ``StepReporter(flops_per_step=...)`` WITHOUT also passing the
    reporter its own ``real_token_fraction``."""
    from torch.utils.flop_counter import FlopCounterMode

    if not 0.0 <= real_token_fraction <= 1.0:
        raise ValueError(
            f"real_token_fraction must be in [0, 1], got "
            f"{real_token_fraction}"
        )
    try:
        meta_args = [_to_meta(a) for a in args]
        with FlopCounterMode(display=False) as counter:
            fn(*meta_args)
        return float(counter.get_total_flops()) * real_token_fraction
    except Exception:  # noqa: BLE001 — a costing miss never fails the loop
        return None


class StepReporter:
    """Attach to any training loop; call :meth:`step` once per step.

    Example::

        reporter = StepReporter(items_per_step=batch, guard=guard,
                                flops_per_step=flops, log_every=50)
        for batch in data:
            loss, params, opt_state = guard(params, opt_state, *batch)
            reporter.step(loss=float(loss))
        print(reporter.line())         # final structured summary line
        reporter.registry.write_jsonl("train_metrics.jsonl")

    Construct the reporter immediately before the loop: construction is
    the timing baseline, so the FIRST :meth:`step` call's duration spans
    the whole first step — first-call captures included — and is recorded under
    ``train_first_step_seconds``, excluded from the steady-state
    histogram.
    """

    def __init__(
        self,
        *,
        registry: Optional[MetricsRegistry] = None,
        items_per_step: Optional[float] = None,
        items_label: str = "items",
        flops_per_step: Optional[float] = None,
        real_token_fraction: float = 1.0,
        peak_flops: Optional[float] = None,
        guard: Any = None,
        replan: Any = None,
        label: str = "train",
        log_every: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        emit: Callable[[str], None] = print,
    ) -> None:
        self.registry = registry or MetricsRegistry()
        self.items_per_step = items_per_step
        self.items_label = items_label
        self.flops_per_step = flops_per_step
        # Honest MFU for ragged data: ``flops_per_step`` prices the
        # counted (padded) shapes, so the measured-MFU numerator is
        # scaled by the batch's real-token fraction
        # (utils.data.real_token_fraction) — a padded run and a packed
        # run over the same documents then report comparable MFU
        # instead of the padded one billing pad arithmetic as work.
        if not 0.0 <= real_token_fraction <= 1.0:
            raise ValueError(
                f"real_token_fraction must be in [0, 1], got "
                f"{real_token_fraction}"
            )
        self.real_token_fraction = float(real_token_fraction)
        self.peak_flops = (
            peak_flops if peak_flops is not None else _default_peak()
        )
        self.guard = guard
        # Optional obs.replan.ReplanOnDrift hook: its applied-replan
        # count mirrors into the same log line as the step-time shift
        # it caused (the guard-counter treatment).
        self.replan = replan
        self.label = label
        self.log_every = int(log_every)
        self._clock = clock
        self._emit = emit
        # The construction instant is the timing baseline: the first
        # step() call's dt then covers the whole first step INCLUDING
        # warm-up (construct the reporter right before the loop).
        self._t_prev: float = clock()
        self._t_window: float = self._t_prev
        self._window_steps = 0
        self._window_items = 0.0
        self._first_seen = False
        self._last_loss: Optional[float] = None
        # Every series carries a ``run`` label (the reporter's label):
        # two reporters sharing one registry (a train and an eval loop)
        # get SEPARATE series under the same metric names instead of
        # silently merging their counts.
        self._run = {"run": label}
        run_l = ("run",)
        self._c_steps = self.registry.counter(
            "train_steps", help="training steps observed", labels=run_l)
        self._c_items = self.registry.counter(
            "train_items", help=f"{items_label} processed", labels=run_l)
        self._h_step = self.registry.histogram(
            "train_step_seconds", help="steady-state step wall time",
            labels=run_l)
        self._g_first = self.registry.gauge(
            "train_first_step_seconds",
            help="first step, reporter construction to first step() "
                 "tick (warm-up-dominated)", labels=run_l)
        self._g_tput = self.registry.gauge(
            "train_items_per_sec",
            help=f"{items_label}/s over the current log window (a "
                 "running whole-run average when log_every=0)",
            labels=run_l)
        self._g_mfu = self.registry.gauge(
            "train_measured_mfu",
            help="flops_per_step / (step time * chip peak)",
            labels=run_l)
        # Distinct names from GuardStats' guard_* COUNTERS: a shared
        # registry (StepGuard(registry=reg) + StepReporter(registry=reg))
        # must not collide these mirror gauges with the source series.
        self._g_skipped = self.registry.gauge(
            "train_guard_skipped", help="StepGuard non-finite skips",
            labels=run_l)
        self._g_retries = self.registry.gauge(
            "train_guard_retries", help="StepGuard transient retries",
            labels=run_l)
        self._g_scale = self.registry.gauge(
            "train_loss_scale", help="DynamicLossScale current scale",
            labels=run_l)
        self._g_replans = self.registry.gauge(
            "train_replans",
            help="plans applied by the attached ReplanOnDrift hook",
            labels=run_l)

    # ------------------------------------------------------------------ #

    @property
    def steps(self) -> int:
        return int(self._c_steps.value(**self._run))

    def step(self, loss: Optional[float] = None,
             items: Optional[float] = None) -> None:
        """Record one completed step.  ``loss`` (a HOST float — pass
        ``float(loss)`` only if the loop already fetched it; never force
        a sync for the reporter) and ``items`` (this step's item count,
        default ``items_per_step``) are optional."""
        now = self._clock()
        if loss is not None:
            self._last_loss = float(loss)
        n_items = items if items is not None else self.items_per_step
        dt = now - self._t_prev
        self._t_prev = now
        self._c_steps.inc(**self._run)
        if n_items:
            self._c_items.inc(n_items, **self._run)
            self._window_items += n_items
        if not self._first_seen:
            # The first observed step carries the warm-up (see the
            # __init__ baseline note) — keep it out of the steady-state
            # percentiles.  A flag, not a value sentinel: a coarse
            # injected clock can legally measure dt == 0.0.
            self._first_seen = True
            self._g_first.set(dt, **self._run)
        else:
            self._h_step.observe(dt, **self._run)
        window_dt = now - self._t_window
        if window_dt > 0 and self._window_items:
            self._g_tput.set(self._window_items / window_dt, **self._run)
        if dt > 0 and self.flops_per_step and self.peak_flops:
            useful = self.flops_per_step * self.real_token_fraction
            self._g_mfu.set(useful / (dt * self.peak_flops), **self._run)
        self._sync_guard()
        self._sync_replan()
        self._window_steps += 1
        if self.log_every and self._window_steps >= self.log_every:
            self._emit(self.line())
            self._window_steps = 0
            self._window_items = 0.0
            self._t_window = now

    def _sync_guard(self) -> None:
        if self.guard is None:
            return
        stats = getattr(self.guard, "stats", None)
        if stats is not None:
            self._g_skipped.set(float(stats.skipped), **self._run)
            self._g_retries.set(float(stats.retries), **self._run)
        scale = getattr(self.guard, "loss_scale", None)
        if scale is not None:
            self._g_scale.set(float(scale.scale), **self._run)

    def _sync_replan(self) -> None:
        if self.replan is None:
            return
        events = getattr(self.replan, "events", None)
        if events is not None:
            self._g_replans.set(float(len(events)), **self._run)

    # ------------------------------------------------------------------ #

    def summary(self) -> Dict[str, Any]:
        """Plain-dict view of the run so far (the line() payload)."""
        s = self._h_step.summary(**self._run)
        out: Dict[str, Any] = {
            "label": self.label,
            "steps": self.steps,
            "step_s_p50": s["p50"],
            "step_s_p95": s["p95"],
            "step_s_p99": s["p99"],
            f"{self.items_label}_per_sec": (
                self._g_tput.value(**self._run) or None
            ),
        }
        if self._last_loss is not None:
            out["loss"] = self._last_loss
        if self.flops_per_step and self.peak_flops:
            out["measured_mfu"] = self._g_mfu.value(**self._run) or None
            if self.real_token_fraction < 1.0:
                out["real_token_fraction"] = self.real_token_fraction
        if self.guard is not None:
            out["skipped"] = int(self._g_skipped.value(**self._run))
            out["retries"] = int(self._g_retries.value(**self._run))
            if getattr(self.guard, "loss_scale", None) is not None:
                out["loss_scale"] = self._g_scale.value(**self._run)
        if self.replan is not None:
            out["replans"] = int(self._g_replans.value(**self._run))
        first = self._g_first.value(**self._run)
        if first:
            out["first_step_s"] = first
        return out

    def line(self) -> str:
        """One structured log line (JSON under an ``OBS |`` prefix)."""
        payload = {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in self.summary().items()
            if v is not None
        }
        return f"OBS | {json.dumps(payload)}"


def _default_peak() -> Optional[float]:
    """The default MFU denominator: the current card's published bf16
    peak, None without a card (MFU is then omitted, never faked)."""
    from torchgpipe_tpu_torch.utils.hw import chip_peak_bf16_flops

    return chip_peak_bf16_flops()


__all__ = ["StepReporter", "measured_step_flops"]
