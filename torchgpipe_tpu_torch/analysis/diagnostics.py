"""Findings and severities: the vocabulary of the static checks.

Counterpart of ``torchgpipe_tpu/analysis/diagnostics.py`` (pure Python,
copied).  A :class:`Finding` is one diagnostic anchored to a program
location (``<program path>:eqn<index>``, or just the program path when
the finding is about configuration).  The port's one producer so far is
:func:`~torchgpipe_tpu_torch.analysis.serving.certify_swap`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, List, Optional, Sequence, Tuple


class Severity(enum.IntEnum):
    """Ordered severities; comparisons (``>= WARNING``) gate exit codes."""

    INFO = 20
    WARNING = 30
    ERROR = 40

    def __str__(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: which rule fired, where, how bad, and why."""

    rule: str
    severity: Severity
    path: str  # program anchor, e.g. "stage1/forward" or "serving/engine"
    message: str
    eqn: Optional[int] = None  # equation index in the anchored program
    primitive: Optional[str] = None  # offending primitive name, if any

    @property
    def anchor(self) -> str:
        """``path:eqn<i>`` (or just ``path``) — the location string."""
        return self.path if self.eqn is None else f"{self.path}:eqn{self.eqn}"

    def format(self) -> str:
        prim = f" [{self.primitive}]" if self.primitive else ""
        return (
            f"{str(self.severity).upper():7s} {self.rule:22s} "
            f"{self.anchor}{prim}: {self.message}"
        )


def parse_suppression(spec: str) -> Tuple[str, Optional[str]]:
    """Parse one suppression spec: ``rule`` or ``rule@path-prefix``."""
    if "@" in spec:
        rule, _, prefix = spec.partition("@")
        return rule.strip(), prefix.strip()
    return spec.strip(), None


def is_suppressed(finding: Finding, suppress: Sequence[str]) -> bool:
    """True if any suppression spec matches the finding.

    ``"rule"`` suppresses the rule everywhere; ``"rule@stage1"`` only where
    the finding's path starts with ``stage1``; ``"*@stage1"`` suppresses
    every rule under that path prefix.
    """
    for spec in suppress:
        rule, prefix = parse_suppression(spec)
        if rule not in ("*", finding.rule):
            continue
        if prefix is None or finding.path.startswith(prefix):
            return True
    return False


def apply_suppressions(
    findings: Iterable[Finding], suppress: Sequence[str]
) -> List[Finding]:
    """Drop suppressed findings; order is preserved."""
    if not suppress:
        return list(findings)
    return [f for f in findings if not is_suppressed(f, suppress)]


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Most severe first, then by anchor for stable output."""
    return sorted(
        findings, key=lambda f: (-int(f.severity), f.path, f.eqn or 0, f.rule)
    )


def format_findings(findings: Sequence[Finding]) -> str:
    """Human-readable report, one line per finding plus a summary line."""
    if not findings:
        return "pipeline lint: clean (0 findings)"
    lines = [f.format() for f in findings]
    n_err = sum(1 for f in findings if f.severity >= Severity.ERROR)
    n_warn = sum(1 for f in findings if f.severity == Severity.WARNING)
    lines.append(
        f"pipeline lint: {len(findings)} finding(s) "
        f"({n_err} error(s), {n_warn} warning(s))"
    )
    return "\n".join(lines)


def max_severity(findings: Sequence[Finding]) -> Optional[Severity]:
    """The worst severity present, or None for a clean run."""
    return max((f.severity for f in findings), default=None)
