"""Request-scoped tracing: stitch one request's span tree across replicas.

Counterpart of ``torchgpipe_tpu/obs/reqtrace.py`` (stdlib only, copied
so the port imports nothing of the reference); it reads the port's
:mod:`~torchgpipe_tpu_torch.obs.flightrec` dumps.
The fleet layer is observable as counters and gauges (occupancy, TTFT
percentiles, failover totals) — but when ONE request is slow, aggregates
cannot say where its time went.  This module answers that question from
the flight records the serving stack already keeps: every serving-side
:class:`~torchgpipe_tpu_torch.obs.flightrec.FlightRecorder` event carries a
``rid`` correlation key (``req_submit`` / ``req_admit`` /
``req_prefix_copy`` / ``req_prefill`` / ``req_decode`` /
``req_spec_round`` / ``req_finish`` / ``req_preempt`` from the engine,
``route`` / ``req_move`` from the router), and :func:`stitch_request`
rebuilds one request's life as a span tree:

* **attempts** — one per replica incarnation, opened by that replica's
  ``req_submit`` event; children are the queue wait, the prefix-cache
  copy, each prefill chunk, the coalesced decode-step group,
  speculative draft/verify rounds (with accepted counts), and the
  finish / preemption marker;
* **migrations** — a failover or drain moves the request mid-flight;
  the gap between one attempt's last event and the next attempt's
  first is an explicit ``migration`` span, so "where did the time go"
  includes "being moved";
* **cross-replica alignment** — every event is placed on the shared
  timeline via its dump's ``clock_offset`` (the ``align_clocks``
  machinery; in-process fleet replicas share one monotonic clock, so
  their offsets are 0 and stitching is exact by construction).

The module is deliberately STDLIB-ONLY and duck-typed over dump objects
(anything with ``worker`` / ``rank`` / ``clock_offset`` / ``events``,
each event with ``kind`` / ``t`` / ``dur`` / ``rid`` / ``detail``): like
the flight recorder itself, inspecting the dumps a dead fleet left
behind must not require torch or a device.

An event that cannot be parented (an engine-side ``req_*`` event on a
replica with no preceding ``req_submit`` for that request) is an ORPHAN:
it means the correlation chain is broken — a recorder ring that rotated
past the submit, or an engine emitting spans without threading the rid —
and :attr:`RequestTrace.orphans` lists it rather than the tree hiding a
silent hole.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Engine-side event kinds that belong INSIDE a replica attempt (must be
# parented by a req_submit — or, on a decode-pool replica, a req_ingest
# — on the same replica).  Router-side kinds (route, req_move,
# kv_migrate, callback_error) attach to the request root.
ATTEMPT_KINDS = (
    "req_admit",
    "req_prefix_copy",
    "req_prefill",
    "req_decode",
    "req_spec_round",
    "req_finish",
    "req_preempt",
    "req_handoff",
)

# Event kinds that OPEN a replica attempt: req_submit on an admission
# (unified or prefill pool), req_ingest when a migrated request arrives
# mid-stream on a decode replica (which never sees a submit).
_ATTEMPT_OPENERS = ("req_submit", "req_ingest")


def detail_tag(detail: str, key: str) -> str:
    """The ``<key>=<value>`` tag in a flight event's space-separated
    ``detail`` string ("" when absent) — the one parser for every tag
    the serving stack stamps (``phase=`` for disaggregated pools,
    ``tier=`` / ``tenant=`` for QoS classes, ``version=`` for the
    rollout's param version), so a stitched trace can answer "which
    weights served this token" without each caller re-splitting."""
    prefix = key + "="
    for tok in detail.split():
        if tok.startswith(prefix):
            return tok[len(prefix):]
    return ""


def _phase_of(detail: str) -> str:
    """The ``phase=<pool>`` tag a disaggregated engine stamps on its
    attempt-opening events (empty for unified replicas)."""
    return detail_tag(detail, "phase")


@dataclasses.dataclass
class Span:
    """One node of a request's span tree.  ``t0 == t1`` is an instant
    marker (route, finish); otherwise a duration span on the stitched
    (rank-0-aligned) timeline."""

    name: str
    replica: str
    t0: float
    t1: float
    detail: str = ""
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "replica": self.replica,
            "t0": self.t0,
            "t1": self.t1,
            "detail": self.detail,
            "children": [c.to_dict() for c in self.children],
        }


@dataclasses.dataclass
class Orphan:
    """An event the stitcher could not parent (see module docstring)."""

    replica: str
    kind: str
    t: float
    detail: str = ""


@dataclasses.dataclass
class RequestTrace:
    """One request's stitched cross-replica story."""

    rid: str
    root: Span
    replicas: List[str]          # replicas that ran an attempt, in order
    orphans: List[Orphan]
    migrations: int

    @property
    def complete(self) -> bool:
        """True when the request reached a ``req_finish`` somewhere."""
        return any(
            c.name == "finish"
            for attempt in self.root.children
            for c in attempt.children
        )


def _dump_name(dump: Any, index: int) -> str:
    worker = getattr(dump, "worker", None)
    if worker:
        return str(worker)
    rank = getattr(dump, "rank", None)
    if rank is not None:
        return f"rank{rank}"
    return f"dump{index}"


def _aligned(dump: Any, t: float) -> float:
    return float(t) + float(getattr(dump, "clock_offset", 0.0))


def request_ids(dumps: Sequence[Any]) -> List[str]:
    """Every rid any of the dumps mentions, ordered by first appearance
    on the aligned timeline."""
    first: Dict[str, float] = {}
    for i, d in enumerate(dumps):
        del i
        for e in d.events:
            rid = getattr(e, "rid", None)
            if rid is None:
                continue
            at = _aligned(d, e.t)
            if rid not in first or at < first[rid]:
                first[rid] = at
    return sorted(first, key=lambda r: first[r])


def _child_span(replica: str, kind: str, at: float,
                dur: Optional[float], detail: str) -> Span:
    """One engine event -> one child span.  ``dur`` events are recorded
    AT COMPLETION measuring backward (the flight-recorder slice
    convention), so the span runs [at - dur, at]."""
    name = {
        "req_admit": "queue",
        "req_prefix_copy": "prefix_copy",
        "req_prefill": "prefill",
        "req_decode": "decode",
        "req_spec_round": "spec_round",
        "req_finish": "finish",
        "req_preempt": "preempt",
        "req_handoff": "handoff",
    }.get(kind, kind)
    if dur is not None:
        return Span(name, replica, at - float(dur), at, detail)
    return Span(name, replica, at, at, detail)


def stitch_request(dumps: Sequence[Any], rid: str) -> RequestTrace:
    """Rebuild request ``rid``'s span tree from per-replica flight dumps
    (module docstring).  Raises ``ValueError`` when no dump mentions the
    rid at all — an unknown rid and a broken trace must not look alike
    (the latter returns a trace with orphans)."""
    # (aligned_t, seq, replica, event) for every event carrying the rid.
    rows: List[Tuple[float, int, str, Any]] = []
    for i, d in enumerate(dumps):
        name = _dump_name(d, i)
        for e in d.events:
            if getattr(e, "rid", None) == rid:
                rows.append((_aligned(d, e.t), int(e.seq), name, e))
    if not rows:
        raise ValueError(
            f"no dump mentions request {rid!r} — known requests: "
            f"{request_ids(dumps)[:16]!r}"
        )
    rows.sort(key=lambda r: (r[0], r[1]))

    # Attempts: one per opener (req_submit / req_ingest), in
    # aligned-time order; openers remembered so the migration span
    # between two attempts can say WHICH kind of move it was.
    attempts: List[Span] = []
    opened_by: List[str] = []
    # Latest open attempt per replica (attempt events parent into it).
    open_attempt: Dict[str, Span] = {}
    root_children: List[Span] = []
    orphans: List[Orphan] = []
    for at, _seq, replica, e in rows:
        kind = str(e.kind)
        dur = getattr(e, "dur", None)
        detail = str(getattr(e, "detail", "") or "")
        if kind in _ATTEMPT_OPENERS:
            phase = _phase_of(detail)
            label = f"attempt@{replica}" + (f":{phase}" if phase else "")
            span = Span(label, replica, at, at, detail)
            attempts.append(span)
            opened_by.append(kind)
            open_attempt[replica] = span
        elif kind in ATTEMPT_KINDS:
            parent = open_attempt.get(replica)
            if parent is None or at < parent.t0:
                orphans.append(Orphan(replica, kind, at, detail))
                continue
            child = _child_span(replica, kind, at, dur, detail)
            # Clamp: a backward-measured dur can start before the
            # attempt opened (queue wait measured from arrival at the
            # ROUTER); the attempt window grows to hold its children.
            parent.t0 = min(parent.t0, child.t0)
            parent.t1 = max(parent.t1, child.t1)
            parent.children.append(child)
        else:
            # Router-side context (route, req_move, callback_error …):
            # instants on the request root, never orphans.
            root_children.append(Span(kind, replica, at, at, detail))

    # Interleave attempts and migration spans on the root.
    children: List[Span] = []
    migrations = 0
    for i, attempt in enumerate(attempts):
        if i > 0:
            prev = attempts[i - 1]
            migrations += 1
            children.append(Span(
                f"migration {prev.replica}->{attempt.replica}",
                attempt.replica,
                prev.t1,
                max(attempt.t0, prev.t1),
                (
                    "kv handoff (prefill→decode)"
                    if opened_by[i] == "req_ingest"
                    else "in-flight move (failover/drain)"
                ),
            ))
        children.append(attempt)
    # Router instants slot in by time, after the attempt list is built.
    children.extend(root_children)
    children.sort(key=lambda s: s.t0)
    t0 = min((s.t0 for s in children), default=rows[0][0])
    t1 = max((s.t1 for s in children), default=rows[-1][0])
    root = Span(f"request {rid}", "", t0, t1, "", children)
    seen: List[str] = []
    for a in attempts:
        if a.replica not in seen:
            seen.append(a.replica)
    return RequestTrace(
        rid=rid, root=root, replicas=seen, orphans=orphans,
        migrations=migrations,
    )


# --------------------------------------------------------------------- #
# rendering                                                             #
# --------------------------------------------------------------------- #


def _fmt_span(span: Span, t_zero: float) -> str:
    at = (span.t0 - t_zero) * 1e3
    if span.dur > 0:
        head = f"{span.name}  +{at:.1f}ms  ({span.dur * 1e3:.2f}ms)"
    else:
        head = f"{span.name}  +{at:.1f}ms"
    if span.detail:
        head += f"  [{span.detail}]"
    return head


def format_request_tree(trace: RequestTrace) -> str:
    """The text span tree — one request, every replica, milliseconds
    from the request's first recorded event."""
    root = trace.root
    t_zero = root.t0
    lines = [
        f"request {trace.rid}: {root.dur * 1e3:.1f}ms total, "
        f"{len(trace.replicas)} replica(s) {trace.replicas}, "
        f"{trace.migrations} migration(s)"
        + ("" if trace.complete else "  [INCOMPLETE]")
    ]

    def walk(spans: Sequence[Span], prefix: str) -> None:
        for i, s in enumerate(spans):
            last = i == len(spans) - 1
            branch = "└─ " if last else "├─ "
            lines.append(prefix + branch + _fmt_span(s, t_zero))
            walk(s.children, prefix + ("   " if last else "│  "))

    walk(root.children, "")
    for o in trace.orphans:
        lines.append(
            f"ORPHAN: {o.kind} on {o.replica} at "
            f"+{(o.t - t_zero) * 1e3:.1f}ms — no req_submit parents it"
        )
    return "\n".join(lines)


def request_chrome_trace(trace: RequestTrace, path: str) -> None:
    """One request as a Perfetto trace: one process row per replica
    (plus a ``fleet`` row for routing/migration spans), microsecond
    timestamps re-zeroed on the request's first event."""
    t_zero = trace.root.t0
    pids = {name: i + 1 for i, name in enumerate(trace.replicas)}
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "fleet"}},
    ]
    for name, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})

    def emit(span: Span) -> None:
        pid = pids.get(span.replica, 0)
        ts = (span.t0 - t_zero) * 1e6
        args = {"detail": span.detail, "rid": trace.rid}
        if span.dur > 0:
            events.append({
                "name": span.name, "ph": "X", "pid": pid, "tid": 0,
                "ts": ts, "dur": max(span.dur * 1e6, 0.01), "args": args,
            })
        else:
            events.append({
                "name": span.name, "ph": "i", "s": "p", "pid": pid,
                "tid": 0, "ts": ts, "args": args,
            })
        for c in span.children:
            emit(c)

    for child in trace.root.children:
        emit(child)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


__all__ = [
    "ATTEMPT_KINDS",
    "Orphan",
    "RequestTrace",
    "Span",
    "detail_tag",
    "format_request_tree",
    "request_chrome_trace",
    "request_ids",
    "stitch_request",
]
