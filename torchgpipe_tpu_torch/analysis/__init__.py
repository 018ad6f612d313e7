"""Static checks.

Counterpart of part of ``torchgpipe_tpu/analysis``: the findings
vocabulary (:mod:`~torchgpipe_tpu_torch.analysis.diagnostics`) and the
serving certificate the rolling weight update needs
(:func:`~torchgpipe_tpu_torch.analysis.serving.certify_swap`).  The
pipeline linter, the planner, the rest of the serving lint and the
sharding checks are ROADMAP.md queue A item 5.6.
"""

from torchgpipe_tpu_torch.analysis.diagnostics import (
    Finding,
    Severity,
    apply_suppressions,
    format_findings,
    max_severity,
    sort_findings,
)

__all__ = ["Finding", "Severity", "apply_suppressions", "format_findings",
           "max_severity", "sort_findings"]
