"""Labeled counters, gauges and histograms behind one registry.

Counterpart of ``torchgpipe_tpu/obs/registry.py``, and the same code: it
is standard-library Python, so the port keeps its own copy instead of
importing the reference package.  The serving metrics
(:class:`~torchgpipe_tpu_torch.serving.metrics.ServingMetrics`) and the
QoS accounting (:mod:`torchgpipe_tpu_torch.serving.qos`) are built on
it.  Three primitives:

* :class:`Counter` — monotone accumulator (``inc``); also assignable so
  attribute code such as ``stats.retries += 1`` works through a
  property setter (:func:`counter_property`).
* :class:`Gauge` — last-write-wins value (``set``).
* :class:`Histogram` — streaming observations with exact count/sum and
  reservoir-sampled percentiles (``p50/p95/p99`` — the serving layer's
  TTFT/TPOT summaries).

Everything is host-side Python — no tensors, no device work — and the
``clock`` is injectable so tests drive deterministic time.  Two
exporters cover the consumption paths: ``write_jsonl`` (one JSON object
per series) and ``to_prometheus`` (the text exposition format, for
scraping).  Series written by the reference and by this copy from the
same events are equal (``tests/test_torch_serving.py``).
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import (
    Any, Callable, Dict, IO, List, Optional, Sequence, Tuple, Union,
)

LabelValues = Tuple[str, ...]

# Reservoir size for histogram percentiles: exact until this many
# observations, uniform-without-bias replacement after (Vitter's
# algorithm R with a fixed seed, so two identical runs summarize
# identically).  Exact count/sum/min/max are kept regardless.
RESERVOIR_SIZE = 4096


def _label_key(label_names: Sequence[str], labels: Dict[str, Any]) -> LabelValues:
    if set(labels) != set(label_names):
        raise ValueError(
            f"metric declares labels {tuple(label_names)!r}, got "
            f"{tuple(sorted(labels))!r}"
        )
    return tuple(str(labels[n]) for n in label_names)


class _Metric:
    """Shared series bookkeeping: one value (or reservoir) per distinct
    label-value tuple; unlabeled metrics use the empty tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 lock: Optional[threading.Lock] = None) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = lock or threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> LabelValues:
        return _label_key(self.label_names, labels)


class Counter(_Metric):
    """Monotone accumulator.  ``set`` exists only so re-based legacy
    attribute APIs (``stats.steps += 1`` through a property) keep their
    exact semantics; new code should ``inc``."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 lock: Optional[threading.Lock] = None) -> None:
        super().__init__(name, help, label_names, lock)
        self._series: Dict[LabelValues, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def series(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._series)


class Gauge(Counter):
    """Last-write-wins value; ``inc`` still works (e.g. live occupancy
    adjusted up and down)."""

    kind = "gauge"


class _Reservoir:
    """Exact count/sum/min/max plus a bounded uniform sample of the
    observations (algorithm R, deterministic seed) for percentiles."""

    def __init__(self, capacity: int = RESERVOIR_SIZE,
                 thresholds: Sequence[float] = ()) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.capacity = capacity
        self.sample: List[float] = []
        self._rng = random.Random(0x0B5)
        # EXACT over-threshold counts (one compare per observation per
        # tracked threshold) — the SLO layer's "bad event" tallies,
        # which a bounded reservoir cannot reconstruct.  Keys are the
        # thresholds registered via Histogram.track_threshold.
        self.over: Dict[float, int] = {float(t): 0 for t in thresholds}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        for t in self.over:
            if v > t:
                self.over[t] += 1
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if len(self.sample) < self.capacity:
            self.sample.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.sample[j] = v

    def percentile(self, q: float) -> Optional[float]:
        if not self.sample:
            return None
        ordered = sorted(self.sample)
        if len(ordered) == 1:
            return ordered[0]
        pos = (len(ordered) - 1) * q
        lo, hi = int(pos), min(int(pos) + 1, len(ordered) - 1)
        frac = pos - lo
        return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


class Histogram(_Metric):
    """Streaming observations with percentile summaries (see
    :class:`_Reservoir` for the exact-vs-sampled contract)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 lock: Optional[threading.Lock] = None,
                 capacity: int = RESERVOIR_SIZE) -> None:
        super().__init__(name, help, label_names, lock)
        self._capacity = capacity
        self._series: Dict[LabelValues, _Reservoir] = {}
        self._thresholds: List[float] = []

    def _res(self, labels: Dict[str, Any]) -> _Reservoir:
        key = self._key(labels)
        res = self._series.get(key)
        if res is None:
            res = self._series[key] = _Reservoir(
                self._capacity, self._thresholds
            )
        return res

    # Read paths use a THROWAWAY empty reservoir for unseen label sets
    # (never _res, which inserts): a percentile query before the first
    # observation — ServingMetrics.snapshot() does this on every idle
    # snapshot — must not leave a phantom zero-count series behind for
    # the exporters to emit forever.
    def _peek(self, labels: Dict[str, Any]) -> _Reservoir:
        return self._series.get(self._key(labels)) or _Reservoir(0)

    def observe(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._res(labels).observe(value)

    def track_threshold(self, threshold: float) -> None:
        """Start EXACT over-threshold counting for every series of this
        histogram (one compare per observation).  Only observations
        AFTER registration count — attach the SLO monitor before
        traffic, not after — and registration is idempotent.  The
        bounded reservoir cannot answer "how many observations exceeded
        t" exactly; this can, which is what windowed burn rates need
        (an SLO monitor's burn rates)."""
        t = float(threshold)
        with self._lock:
            if t not in self._thresholds:
                self._thresholds.append(t)
                for res in self._series.values():
                    res.over.setdefault(t, 0)

    def count_over(self, threshold: float, **labels: Any) -> int:
        """Observations strictly above a TRACKED threshold for one
        series (0 for an unseen series).  Raises didactically for a
        threshold :meth:`track_threshold` never registered — silently
        returning 0 would read as a perfect SLI."""
        t = float(threshold)
        with self._lock:
            if t not in self._thresholds:
                raise ValueError(
                    f"threshold {t!r} is not tracked on {self.name!r} — "
                    "call track_threshold(threshold) before the "
                    "observations you want counted"
                )
            return self._peek(labels).over.get(t, 0)

    def count(self, **labels: Any) -> int:
        with self._lock:
            return self._peek(labels).count

    def sum(self, **labels: Any) -> float:
        with self._lock:
            return self._peek(labels).total

    def percentile(self, q: float, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._peek(labels).percentile(q)

    def summary(self, **labels: Any) -> Dict[str, Optional[float]]:
        """``{count, sum, mean, min, max, p50, p95, p99}`` for one series."""
        with self._lock:
            r = self._peek(labels)
            mean = r.total / r.count if r.count else None
            return {
                "count": float(r.count), "sum": r.total, "mean": mean,
                "min": r.vmin, "max": r.vmax,
                "p50": r.percentile(0.50),
                "p95": r.percentile(0.95),
                "p99": r.percentile(0.99),
            }

    def series(self) -> Dict[LabelValues, _Reservoir]:
        with self._lock:
            return dict(self._series)


MetricType = Union[Counter, Gauge, Histogram]


class _BoundMetric:
    """A metric with fixed label values pre-applied — what
    :meth:`MetricsRegistry.labeled` hands out so per-replica components
    (e.g. one ``ServingMetrics`` per fleet replica) share ONE registry
    namespace while every series they touch carries its identity
    (``replica="r0"``) without the component knowing about labels."""

    def __init__(self, metric: _Metric, fixed: Dict[str, str]) -> None:
        self.metric = metric
        self.fixed = dict(fixed)

    @property
    def name(self) -> str:
        return self.metric.name

    @property
    def kind(self) -> str:
        return self.metric.kind

    def _merge(self, labels: Dict[str, Any]) -> Dict[str, Any]:
        overlap = set(self.fixed) & set(labels)
        if overlap:
            raise ValueError(
                f"labels {sorted(overlap)} are fixed by the labeled view "
                f"({self.fixed}) and cannot be overridden per call"
            )
        return {**self.fixed, **labels}


class BoundCounter(_BoundMetric):
    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self.metric.inc(amount, **self._merge(labels))  # type: ignore[union-attr]

    def set(self, value: float, **labels: Any) -> None:
        self.metric.set(value, **self._merge(labels))  # type: ignore[union-attr]

    def value(self, **labels: Any) -> float:
        return self.metric.value(**self._merge(labels))  # type: ignore[union-attr]


class BoundGauge(BoundCounter):
    pass


class BoundHistogram(_BoundMetric):
    def observe(self, value: float, **labels: Any) -> None:
        self.metric.observe(value, **self._merge(labels))  # type: ignore[union-attr]

    def track_threshold(self, threshold: float) -> None:
        self.metric.track_threshold(threshold)  # type: ignore[union-attr]

    def count_over(self, threshold: float, **labels: Any) -> int:
        return self.metric.count_over(  # type: ignore[union-attr]
            threshold, **self._merge(labels)
        )

    def count(self, **labels: Any) -> int:
        return self.metric.count(**self._merge(labels))  # type: ignore[union-attr]

    def sum(self, **labels: Any) -> float:
        return self.metric.sum(**self._merge(labels))  # type: ignore[union-attr]

    def percentile(self, q: float, **labels: Any) -> Optional[float]:
        return self.metric.percentile(q, **self._merge(labels))  # type: ignore[union-attr]

    def summary(self, **labels: Any) -> Dict[str, Optional[float]]:
        return self.metric.summary(**self._merge(labels))  # type: ignore[union-attr]


class LabeledRegistry:
    """A view of a :class:`MetricsRegistry` that stamps fixed labels on
    every metric created through it (see :meth:`MetricsRegistry.labeled`).
    Quacks like the registry for metric creation — components taking
    ``registry=`` (``ServingMetrics``, ``QosPolicy``)
    work unchanged — while reads/exports go through the BASE registry,
    where all views' series live side by side, separable by label."""

    def __init__(self, base: "MetricsRegistry",
                 labels: Dict[str, Any]) -> None:
        if not labels:
            raise ValueError("labeled() needs at least one fixed label")
        self.base = base
        self.labels: Dict[str, str] = {
            str(k): str(v) for k, v in sorted(labels.items())
        }

    @property
    def clock(self) -> Callable[[], float]:
        return self.base.clock

    def _names(self, labels: Sequence[str]) -> Tuple[str, ...]:
        overlap = set(self.labels) & set(labels)
        if overlap:
            raise ValueError(
                f"labels {sorted(overlap)} are already fixed by this view "
                f"({self.labels})"
            )
        return tuple(self.labels) + tuple(labels)

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> BoundCounter:
        return BoundCounter(
            self.base.counter(name, help, self._names(labels)), self.labels
        )

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> BoundGauge:
        return BoundGauge(
            self.base.gauge(name, help, self._names(labels)), self.labels
        )

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = ()) -> BoundHistogram:
        return BoundHistogram(
            self.base.histogram(name, help, self._names(labels)),
            self.labels,
        )

    def labeled(self, **labels: Any) -> "LabeledRegistry":
        """Narrow further (e.g. per-replica view narrowed per-tenant).
        Already-fixed labels cannot be re-fixed — silently re-stamping
        ``replica=`` would file every series under the wrong replica."""
        overlap = set(self.labels) & set(labels)
        if overlap:
            raise ValueError(
                f"labels {sorted(overlap)} are already fixed by this "
                f"view ({self.labels}) — narrowing may only ADD labels"
            )
        return LabeledRegistry(self.base, {**self.labels, **labels})

    # Export/read paths delegate to the base: the whole namespace.
    def get(self, name: str) -> Optional[MetricType]:
        return self.base.get(name)

    def snapshot(self) -> Dict[str, Any]:
        return self.base.snapshot()

    def write_jsonl(self, dest: Union[str, IO[str]]) -> int:
        return self.base.write_jsonl(dest)

    def to_prometheus(self) -> str:
        return self.base.to_prometheus()


def counter_property(attr: str) -> property:
    """A legacy int-attribute facade over a registry :class:`Counter`
    stored at ``self.<attr>``: reads return the counter's value as an
    int, assignment (``obj.retries += 1``) sets it — the pre-registry
    semantics of the plain-int counters this module re-bases
    (:class:`~torchgpipe_tpu_torch.serving.metrics.ServingMetrics`)."""

    def fget(self: Any) -> int:
        return int(getattr(self, attr).value())

    def fset(self: Any, value: float) -> None:
        getattr(self, attr).set(value)

    return property(fget, fset)


class MetricsRegistry:
    """The metric namespace: create-or-get by name, snapshot, export.

    Creation is idempotent — asking for an existing name returns the
    existing metric (type- and label-checked), so two components sharing
    a registry compose without coordination::

        reg = MetricsRegistry()
        steps = reg.counter("train_steps", help="optimizer steps applied")
        lat = reg.histogram("step_seconds")
        steps.inc(); lat.observe(0.031)
        print(reg.to_prometheus())
        reg.write_jsonl("metrics.jsonl")
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._metrics: Dict[str, MetricType] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # creation                                                           #
    # ------------------------------------------------------------------ #

    def _get_or_make(self, cls: type, name: str, help: str,
                     labels: Sequence[str]) -> MetricType:
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                # Exact type, not isinstance: Gauge subclasses Counter,
                # and counter("x") silently returning an existing Gauge
                # would hand monotone-counter code last-write-wins
                # semantics (and the wrong Prometheus TYPE line).
                if type(got) is not cls or (
                    tuple(got.label_names) != tuple(labels)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(got).__name__} with labels "
                        f"{got.label_names!r}; asked for {cls.__name__} "
                        f"with labels {tuple(labels)!r}"
                    )
                return got
            made = cls(name, help, labels)
            self._metrics[name] = made
            return made

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        got = self._get_or_make(Counter, name, help, labels)
        assert isinstance(got, Counter)
        return got

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        got = self._get_or_make(Gauge, name, help, labels)
        assert isinstance(got, Gauge)
        return got

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = ()) -> Histogram:
        got = self._get_or_make(Histogram, name, help, labels)
        assert isinstance(got, Histogram)
        return got

    def get(self, name: str) -> Optional[MetricType]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[MetricType]:
        with self._lock:
            return list(self._metrics.values())

    def labeled(self, **labels: Any) -> LabeledRegistry:
        """A view stamping ``labels`` on every metric created through it
        — how N fleet replicas share one registry while staying
        separable::

            shared = MetricsRegistry()
            m0 = ServingMetrics(registry=shared.labeled(replica="r0"))
            m1 = ServingMetrics(registry=shared.labeled(replica="r1"))
            shared.to_prometheus()   # serving_*{replica="r0"} + ...="r1"

        Series created through different views of one name must agree on
        the label SCHEMA (the create-or-get check); values differ per
        view.  Exports on the view read the whole base namespace."""
        return LabeledRegistry(self, labels)

    # ------------------------------------------------------------------ #
    # export                                                             #
    # ------------------------------------------------------------------ #

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: counters/gauges to their value, histograms to
        their :meth:`Histogram.summary`; labeled series keyed by the
        joined label values."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                rows = {
                    ",".join(k) if k else "": m.summary(
                        **dict(zip(m.label_names, k))
                    )
                    for k in m.series()
                }
            else:
                rows = {",".join(k) if k else "": v
                        for k, v in m.series().items()}
            out[m.name] = rows.get("", rows) if list(rows) == [""] else rows
        return out

    def _ordered_metrics(self) -> List[MetricType]:
        """Exporter iteration order: metrics sorted by name, so two
        processes (or two runs) that created the same series in a
        different order — e.g. fleet replicas racing their first
        request — emit byte-identical exports.  Series within a metric
        are sorted by label-value tuple at each use site."""
        return sorted(self.metrics(), key=lambda m: m.name)

    def write_jsonl(self, dest: Union[str, IO[str]]) -> int:
        """One JSON object per (metric, series) line, in deterministic
        order (metrics by name, series by label values); returns the
        line count.  ``dest`` is a path or an open text file."""
        lines: List[str] = []
        t = self.clock()
        for m in self._ordered_metrics():
            if isinstance(m, Histogram):
                for key in sorted(m.series()):
                    labels = dict(zip(m.label_names, key))
                    rec: Dict[str, Any] = {
                        "metric": m.name, "type": m.kind, "time": t,
                        "labels": labels,
                    }
                    rec.update(m.summary(**labels))
                    lines.append(json.dumps(rec))
            else:
                for key, v in sorted(m.series().items()):
                    lines.append(json.dumps({
                        "metric": m.name, "type": m.kind, "time": t,
                        "labels": dict(zip(m.label_names, key)),
                        "value": v,
                    }))
        text = "".join(line + "\n" for line in lines)
        if isinstance(dest, str):
            with open(dest, "w") as f:
                f.write(text)
        else:
            dest.write(text)
        return len(lines)

    def read_jsonl(self, src: Union[str, IO[str]]) -> List[Dict[str, Any]]:
        """Instance alias of the module-level :func:`read_jsonl` (kept
        here so the writer and reader live side by side in the API)."""
        return read_jsonl(src)

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format, in deterministic order
        (metrics by name, series by label values — a multi-replica
        registry scrapes identically however the replicas raced).
        Histograms export as summaries (``{quantile="…"}`` rows plus
        ``_sum``/``_count``) — the percentile-first shape, matching what
        :class:`Histogram` actually stores.  Label values are escaped
        per the exposition rules (backslash, quote, newline), so values
        like ``replica="r0"`` round-trip through a scrape."""

        def esc(v: str) -> str:
            # The exposition format requires escaping backslash, quote
            # and newline in label values — an unescaped quote (e.g. a
            # label value with quotes) would invalidate the whole
            # scrape.
            return (
                v.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def fmt_labels(names: Sequence[str], values: LabelValues,
                       extra: Optional[Tuple[str, str]] = None) -> str:
            pairs = [f'{n}="{esc(v)}"' for n, v in zip(names, values)]
            if extra is not None:
                pairs.append(f'{extra[0]}="{esc(extra[1])}"')
            return "{" + ",".join(pairs) + "}" if pairs else ""

        out: List[str] = []
        for m in self._ordered_metrics():
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            kind = "summary" if isinstance(m, Histogram) else m.kind
            out.append(f"# TYPE {m.name} {kind}")
            if isinstance(m, Histogram):
                for key in sorted(m.series()):
                    labels = dict(zip(m.label_names, key))
                    for q in (0.5, 0.95, 0.99):
                        v = m.percentile(q, **labels)
                        if v is None:
                            continue
                        out.append(
                            f"{m.name}"
                            f"{fmt_labels(m.label_names, key, ('quantile', str(q)))}"
                            f" {v:g}"
                        )
                    out.append(
                        f"{m.name}_sum{fmt_labels(m.label_names, key)} "
                        f"{m.sum(**labels):g}"
                    )
                    out.append(
                        f"{m.name}_count{fmt_labels(m.label_names, key)} "
                        f"{m.count(**labels)}"
                    )
            else:
                for key, v in sorted(m.series().items()):
                    out.append(
                        f"{m.name}{fmt_labels(m.label_names, key)} {v:g}"
                    )
        return "\n".join(out) + ("\n" if out else "")


def read_jsonl(src: Union[str, IO[str]]) -> List[Dict[str, Any]]:
    """Round-trip loader for :meth:`MetricsRegistry.write_jsonl`
    exports: one parsed record per (metric, series) line, exactly the
    dicts the writer emitted (``metric``/``type``/``time``/``labels``
    plus ``value`` or the histogram summary fields) — so persisted
    series and cost-model provenance written next to a trace can be
    reloaded and diffed offline.  ``src`` is a path or an open text
    file; blank lines are skipped, a malformed line raises (a torn
    export should fail loudly, not truncate silently)."""
    if isinstance(src, str):
        with open(src) as f:
            text = f.read()
    else:
        text = src.read()
    return [
        json.loads(line) for line in text.splitlines() if line.strip()
    ]


__all__ = [
    "BoundCounter",
    "BoundGauge",
    "BoundHistogram",
    "Counter",
    "Gauge",
    "Histogram",
    "LabeledRegistry",
    "MetricsRegistry",
    "RESERVOIR_SIZE",
    "counter_property",
    "read_jsonl",
]
