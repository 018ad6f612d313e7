"""Declarative serving SLOs with multi-window burn-rate alerting.

Counterpart of ``torchgpipe_tpu/obs/slo.py`` (host-side Python, copied
so the port imports nothing of the reference).  The serving metrics (:class:`~torchgpipe_tpu_torch.serving.metrics.
ServingMetrics` histograms on a shared
:class:`~torchgpipe_tpu_torch.obs.MetricsRegistry`) say what latency IS;
nothing says what it SHOULD be, or notices when the gap opens.  This
module is that layer:

* :class:`Objective` — one declarative target: "95% of TTFTs under
  200ms" (``kind='latency'`` over a registry histogram, priced by the
  EXACT over-threshold counters :meth:`~torchgpipe_tpu_torch.obs.registry.
  Histogram.track_threshold` maintains) or "retries under 1% of steps"
  (``kind='error_rate'`` over two counters).  ``split_by`` evaluates
  the objective independently per label value — ``replica`` for the
  fleet's evict decision, ``tenant`` for per-tenant targets through a
  :meth:`~torchgpipe_tpu_torch.obs.MetricsRegistry.labeled` view.
* :class:`SloMonitor` — the evaluator.  Each :meth:`~SloMonitor.tick`
  snapshots cumulative (bad, total) per (objective, split), computes
  the burn rate over a SHORT and a LONG window (bad fraction divided
  by the error budget — the SRE-workbook multi-window rule: the short
  window reacts, the long window stops one spike from paging), and
  emits :class:`SloEvent` transitions when BOTH windows exceed
  ``burn_threshold``.  Every evaluation lands on the registry
  (``slo_burn_rate`` gauge, ``slo_alert_active`` gauge,
  ``slo_alerts_total`` counter), so the alert state is itself
  scrapeable.
* **The act half** lives where the actuator is: the fleet
  :class:`~torchgpipe_tpu_torch.fleet.router.Router` takes ``slo=monitor``
  and, on each step, degrades a breaching replica out of
  power-of-two-choices rotation (moving its in-flight requests to
  survivors over the exact drain/restore path) and re-admits it when
  its windows come back clean — every action a registry counter AND a
  flight-recorder event.

Determinism: burn rates are ratios of EXACT event counts over
explicitly sampled windows (no reservoir estimates anywhere in the
alert path), and the clock is the registry's injectable one — tests
drive the whole breach/recovery cycle on a hand-stepped clock.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional, Sequence, Set, Tuple

from torchgpipe_tpu_torch.obs.registry import Counter, Histogram, MetricsRegistry


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative service-level objective (module docstring).

    ``kind='latency'``: ``series`` names a registry histogram of
    seconds; an observation above ``threshold`` is a bad event and the
    error budget is ``1 - target`` (target = the fraction that must be
    good, e.g. 0.95 for "p95 under threshold").

    ``kind='error_rate'``: ``series`` names the bad-event counter,
    ``total_series`` the total-event counter, and ``budget`` the
    allowed bad fraction directly.
    """

    name: str
    series: str
    kind: str = "latency"
    threshold: float = 0.0
    target: float = 0.95
    total_series: Optional[str] = None
    budget: Optional[float] = None
    split_by: str = "replica"
    # Which pool of a phase-disaggregated fleet this objective judges:
    # TTFT objectives belong to the prefill pool (first tokens sample
    # there), TPOT to the decode pool (streams finish there).  ``None``
    # judges every replica — the only sensible setting for a unified
    # fleet.  The router's evict decision filters on it (and the
    # autoscaler prices each pool by its own phase's objectives), so
    # burn blame lands on the pool that owns the latency.
    phase: Optional[str] = None

    def __post_init__(self) -> None:
        if self.phase not in (None, "prefill", "decode"):
            raise ValueError(
                f"objective phase must be None | 'prefill' | 'decode', "
                f"got {self.phase!r}"
            )
        if self.kind not in ("latency", "error_rate"):
            raise ValueError(
                f"objective kind must be 'latency' or 'error_rate', "
                f"got {self.kind!r}"
            )
        if self.kind == "latency":
            if self.threshold <= 0:
                raise ValueError(
                    f"latency objective {self.name!r} needs a positive "
                    f"threshold (seconds), got {self.threshold!r}"
                )
            if not 0.0 < self.target < 1.0:
                raise ValueError(
                    f"latency objective {self.name!r}: target must be "
                    f"in (0, 1), got {self.target!r}"
                )
        else:
            if self.total_series is None:
                raise ValueError(
                    f"error_rate objective {self.name!r} needs "
                    "total_series (the total-event counter)"
                )
            if self.budget is None or not 0.0 < self.budget < 1.0:
                raise ValueError(
                    f"error_rate objective {self.name!r}: budget must "
                    f"be in (0, 1), got {self.budget!r}"
                )

    @property
    def budget_fraction(self) -> float:
        """The allowed bad fraction — the burn rate's denominator."""
        if self.kind == "latency":
            return 1.0 - self.target
        assert self.budget is not None
        return self.budget


@dataclasses.dataclass
class SloEvent:
    """One alert-state transition (breach or recovery)."""

    objective: str
    split: str            # the split_by label value, e.g. replica name
    kind: str             # 'breach' | 'recovery'
    burn_short: float
    burn_long: float
    t: float

    def describe(self) -> str:
        return (
            f"{self.kind}: {self.objective} on {self.split or '<all>'} "
            f"(burn short={self.burn_short:.1f}x "
            f"long={self.burn_long:.1f}x)"
        )


_Sample = Tuple[float, float, float]  # (t, bad_cum, total_cum)


class SloMonitor:
    """Evaluate objectives over registry series with multi-window burn
    rates; see the module docstring.

    ``short_window``/``long_window`` are seconds on the registry's
    clock; an alert fires when the burn rate exceeds
    ``burn_threshold`` in BOTH windows and clears when either window
    is back under it (a replica out of rotation stops producing
    events, so its windows drain to burn 0 and recovery follows within
    one long window).  ``min_count`` events are required in a window
    before it can contribute — one slow request must not page.

    :meth:`tick` is cheap to CALL anywhere (the fleet router ticks it
    once per engine step) because evaluation is THROTTLED to
    ``min_interval`` seconds (default ``short_window / 10`` — ten
    evaluations per short window bounds alert latency at 10% of the
    window, while decode steps run orders of magnitude hotter than any
    burn-rate decision needs); between evaluations a tick is one clock
    read.  ``min_interval=0`` evaluates every call.
    """

    def __init__(
        self,
        registry: Any,
        objectives: Sequence[Objective],
        *,
        short_window: float = 60.0,
        long_window: float = 300.0,
        burn_threshold: float = 2.0,
        min_count: int = 3,
        min_interval: Optional[float] = None,
    ) -> None:
        if not objectives:
            raise ValueError("an SLO monitor needs at least one objective")
        if not 0 < short_window < long_window:
            raise ValueError(
                f"windows must satisfy 0 < short < long, got "
                f"{short_window!r} / {long_window!r}"
            )
        if burn_threshold <= 0:
            raise ValueError("burn_threshold must be positive")
        if min_count < 1:
            raise ValueError(
                f"min_count must be >= 1, got {min_count!r} — a burn "
                "rate over zero events is undefined (and one event "
                "should not page either)"
            )
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names!r}")
        self.registry = registry
        self.objectives = list(objectives)
        self.short_window = float(short_window)
        self.long_window = float(long_window)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self.min_interval = (
            float(min_interval) if min_interval is not None
            else self.short_window / 10.0
        )
        if self.min_interval < 0:
            raise ValueError("min_interval must be >= 0")
        self._last_eval: Optional[float] = None
        self._samples: Dict[Tuple[str, str], Deque[_Sample]] = {}
        self._active: Set[Tuple[str, str]] = set()
        self._tracked: Set[str] = set()
        base = registry.base if hasattr(registry, "base") else registry
        assert isinstance(base, MetricsRegistry)
        self._base: MetricsRegistry = base
        self._g_burn = base.gauge(
            "slo_burn_rate",
            help="error-budget burn rate per objective/split/window",
            labels=("objective", "split", "window"),
        )
        self._g_active = base.gauge(
            "slo_alert_active",
            help="1 while an objective's multi-window alert is firing",
            labels=("objective", "split"),
        )
        self._c_alerts = base.counter(
            "slo_alerts_total",
            help="multi-window burn-rate alerts fired",
            labels=("objective", "split"),
        )
        self._register_thresholds()
        # Baseline-at-attach: take one sample of every series that
        # already exists, NOW.  Without it, the first in-flight tick
        # becomes the baseline and every bad event before that tick is
        # swallowed into it — a breach that begins the instant traffic
        # starts (the induced-fault gate's exact shape) would need
        # min_count FURTHER bad events to fire.  Construct the monitor
        # after the engines (their histograms) exist and before
        # traffic; series appearing later still cold-start at their
        # first tick.
        self.tick()

    # ------------------------------------------------------------------ #
    # reading the registry                                               #
    # ------------------------------------------------------------------ #

    def _register_thresholds(self) -> None:
        """Arm exact over-threshold counting on each latency
        objective's histogram.  Counting starts at registration —
        construct the monitor before traffic (the fleet pattern builds
        engines, then the monitor, then serves); histograms that do
        not exist yet are re-tried every tick."""
        for obj in self.objectives:
            if obj.kind != "latency" or obj.name in self._tracked:
                continue
            metric = self._base.get(obj.series)
            if isinstance(metric, Histogram):
                metric.track_threshold(obj.threshold)
                self._tracked.add(obj.name)

    def _split_sums(
        self, metric: Any, split_by: str, threshold: float,
    ) -> Dict[str, Tuple[float, float]]:
        """Per-split (bad, total) sums over one histogram's series; for
        counters ``read_bad`` is ignored (callers combine two)."""
        out: Dict[str, Tuple[float, float]] = {}
        names = tuple(metric.label_names)
        idx = names.index(split_by) if split_by in names else None
        if isinstance(metric, Histogram):
            for key in metric.series():
                labels = dict(zip(names, key))
                split = key[idx] if idx is not None else ""
                bad = float(metric.count_over(threshold, **labels))
                total = float(metric.count(**labels))
                b, t = out.get(split, (0.0, 0.0))
                out[split] = (b + bad, t + total)
        else:
            for key, v in metric.series().items():
                split = key[idx] if idx is not None else ""
                b, t = out.get(split, (0.0, 0.0))
                out[split] = (b + float(v), t)
        return out

    def _cumulative(self, obj: Objective) -> Dict[str, Tuple[float, float]]:
        """Cumulative (bad, total) per split value for one objective,
        from the live registry."""
        self._register_thresholds()
        if obj.kind == "latency":
            metric = self._base.get(obj.series)
            if not isinstance(metric, Histogram) or obj.name not in self._tracked:
                return {}
            return self._split_sums(metric, obj.split_by, obj.threshold)
        bad_metric = self._base.get(obj.series)
        total_metric = self._base.get(obj.total_series or "")
        if not isinstance(bad_metric, Counter) or not isinstance(
            total_metric, Counter
        ):
            return {}
        bads = self._split_sums(bad_metric, obj.split_by, 0.0)
        totals = self._split_sums(total_metric, obj.split_by, 0.0)
        return {
            split: (bads.get(split, (0.0, 0.0))[0], tot)
            for split, (tot, _) in totals.items()
        }

    # ------------------------------------------------------------------ #
    # burn rates                                                         #
    # ------------------------------------------------------------------ #

    def _burn(self, samples: Deque[_Sample], now: float, window: float,
              budget: float) -> float:
        """Burn rate over [now - window, now]: windowed bad fraction
        over the error budget.  The baseline is the LAST sample at or
        before the window start (or the first sample the monitor ever
        took); fewer than ``min_count`` events in the window means no
        verdict (burn 0 — silence is not a breach)."""
        latest = samples[-1]
        baseline = samples[0]
        for s in samples:
            if s[0] <= now - window:
                baseline = s
            else:
                break
        d_bad = latest[1] - baseline[1]
        d_total = latest[2] - baseline[2]
        if d_total <= 0 or d_total < self.min_count:
            return 0.0
        return (d_bad / d_total) / budget

    def tick(self, now: Optional[float] = None) -> List[SloEvent]:
        """One evaluation pass: sample every objective, update burn
        gauges, return the alert-state TRANSITIONS (empty on a quiet
        tick).  Call from the serving host loop — the fleet router
        ticks it once per :meth:`~torchgpipe_tpu_torch.fleet.router.Router.
        step`."""
        t = float(now) if now is not None else float(self._base.clock())
        if (
            self._last_eval is not None
            and t - self._last_eval < self.min_interval
        ):
            return []
        self._last_eval = t
        events: List[SloEvent] = []
        for obj in self.objectives:
            budget = obj.budget_fraction
            for split, (bad, total) in sorted(self._cumulative(obj).items()):
                key = (obj.name, split)
                dq = self._samples.get(key)
                if dq is None:
                    dq = self._samples[key] = collections.deque()
                dq.append((t, bad, total))
                # Keep one sample older than the long window as the
                # baseline; everything before it is dead weight.
                while len(dq) >= 2 and dq[1][0] <= t - self.long_window:
                    dq.popleft()
                burn_s = self._burn(dq, t, self.short_window, budget)
                burn_l = self._burn(dq, t, self.long_window, budget)
                self._g_burn.set(burn_s, objective=obj.name, split=split,
                                 window="short")
                self._g_burn.set(burn_l, objective=obj.name, split=split,
                                 window="long")
                firing = (
                    burn_s >= self.burn_threshold
                    and burn_l >= self.burn_threshold
                )
                was = key in self._active
                if firing and not was:
                    self._active.add(key)
                    self._c_alerts.inc(objective=obj.name, split=split)
                    self._g_active.set(1.0, objective=obj.name, split=split)
                    events.append(SloEvent(
                        obj.name, split, "breach", burn_s, burn_l, t
                    ))
                elif not firing and was:
                    self._active.discard(key)
                    self._g_active.set(0.0, objective=obj.name, split=split)
                    events.append(SloEvent(
                        obj.name, split, "recovery", burn_s, burn_l, t
                    ))
        return events

    # ------------------------------------------------------------------ #
    # state reads                                                        #
    # ------------------------------------------------------------------ #

    def active_alerts(self) -> List[Tuple[str, str]]:
        """Currently firing (objective, split) pairs."""
        return sorted(self._active)

    def breaching(
        self, split_by: Optional[str] = None,
        phase: Optional[str] = None,
    ) -> Set[str]:
        """Split values with ANY objective currently firing.  Pass
        ``split_by="replica"`` to restrict to objectives split on that
        label — the router's evict decision does, so a per-TENANT
        objective whose tenant id happens to equal a replica name can
        never evict that replica.  ``phase`` additionally restricts to
        objectives declared for that pool (phase-less objectives always
        qualify) — a disaggregated router asks per pool, so a TTFT
        breach can only ever blame prefill replicas."""
        by_name = {o.name: o for o in self.objectives}
        return {
            split
            for name, split in self._active
            if (split_by is None or by_name[name].split_by == split_by)
            and (phase is None or by_name[name].phase in (None, phase))
        }


__all__ = ["Objective", "SloEvent", "SloMonitor"]
