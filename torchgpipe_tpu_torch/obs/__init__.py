"""Runtime telemetry: the metrics registry.

Counterpart of the registry half of ``torchgpipe_tpu/obs``: labeled
counters, gauges and histograms with JSONL and Prometheus exporters
(:mod:`~torchgpipe_tpu_torch.obs.registry`).  The flight recorder, step
reporter, request traces, SLO monitor and reconciliation are not ported
yet (ROADMAP.md, queue A item 5).
"""

from torchgpipe_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    read_jsonl,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "read_jsonl"]
