"""Runtime telemetry: metrics, flight records, request traces, SLOs.

Counterpart of part of ``torchgpipe_tpu/obs``: labeled counters, gauges
and histograms with JSONL and Prometheus exporters
(:mod:`~torchgpipe_tpu_torch.obs.registry`), the per-rank and per-replica
event ring (:mod:`~torchgpipe_tpu_torch.obs.flightrec`), the training
loop's :class:`StepReporter` (:mod:`~torchgpipe_tpu_torch.obs.reporter`),
request span trees stitched across replicas
(:mod:`~torchgpipe_tpu_torch.obs.reqtrace`) and multi-window burn-rate
SLOs (:mod:`~torchgpipe_tpu_torch.obs.slo`).  The cost model,
reconciliation, postmortem analyzer and replanning are ROADMAP.md queue
A item 5.6.
"""

from torchgpipe_tpu_torch.obs.flightrec import (
    FlightEvent,
    FlightRecorder,
    RankDump,
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
from torchgpipe_tpu_torch.obs.reporter import StepReporter, measured_step_flops
from torchgpipe_tpu_torch.obs.reqtrace import (
    Orphan,
    RequestTrace,
    Span,
    format_request_tree,
    request_chrome_trace,
    request_ids,
    stitch_request,
)
from torchgpipe_tpu_torch.obs.slo import Objective, SloEvent, SloMonitor

__all__ = ["Counter", "FlightEvent", "FlightRecorder", "Gauge", "Histogram",
           "MetricsRegistry", "Objective", "Orphan", "RankDump",
           "RequestTrace", "SloEvent", "SloMonitor", "Span", "StallWatchdog",
           "StepReporter", "align_clocks", "format_request_tree", "load_dump",
           "measured_step_flops", "merged_chrome_trace", "read_jsonl",
           "request_chrome_trace", "request_ids", "stitch_request"]
