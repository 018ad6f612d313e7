"""Runtime telemetry: the metrics registry and the flight recorder.

Counterpart of part of ``torchgpipe_tpu/obs``: labeled counters, gauges
and histograms with JSONL and Prometheus exporters
(:mod:`~torchgpipe_tpu_torch.obs.registry`), and the per-rank event ring
of the multi-process pipeline (:mod:`~torchgpipe_tpu_torch.obs.flightrec`).
The step reporter, request traces, SLO monitor, postmortem analyzer and
reconciliation are not ported yet (ROADMAP.md, queue A item 5).
"""

from torchgpipe_tpu_torch.obs.flightrec import (
    FlightEvent,
    FlightRecorder,
    StallWatchdog,
    align_clocks,
    load_dump,
    merged_chrome_trace,
)
from torchgpipe_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    read_jsonl,
)

__all__ = ["Counter", "FlightEvent", "FlightRecorder", "Gauge", "Histogram",
           "MetricsRegistry", "StallWatchdog", "align_clocks", "load_dump",
           "merged_chrome_trace", "read_jsonl"]
