"""Pipeline timeline tracing.

Counterpart of ``torchgpipe_tpu/utils/tracing.py`` (``TimelineEvent``,
``Timeline``, ``device_trace``, ``simulate_pipeline``).  The engine
records one span per cell and phase (``GPipe(tracer=Timeline())``):
``fwd`` and ``bwd`` per (micro-batch, stage), and ``loss`` (the
fill-drain gathered loss at micro-batch -1, one per micro-batch under
1F1B).  A span starts as the engine begins the cell's work and ends at
:meth:`Timeline.record`.

With ``sync=False`` (default) a span is the host's dispatch time of the
cell (CUDA runs asynchronously, so device work overlaps later spans).
With ``sync=True`` :meth:`Timeline.record` synchronizes the cell's
device before it ends the span, so each span is the cell's serialized
time on the card, dispatch included, and no two cells overlap: the
serialized-pipeline ablation the reference's unet-timeline experiments
measure, and the input :func:`simulate_pipeline` projects onto a
schedule.

Usage::

    tracer = Timeline(sync=True)
    model = GPipe(layers, balance, chunks=8, tracer=tracer)
    model.value_and_grad(x, y, loss_fn)
    print(tracer.summary())
    simulate_pipeline(tracer.events, n_stages=len(balance))

Not ported here (ROADMAP.md queue A item 5.6): ``recommend_schedule``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree


@dataclasses.dataclass
class TimelineEvent:
    name: str  # "fwd" | "bwd" | "loss"
    stage: int
    mbatch: int
    t_start: float
    t_end: float

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


def _sync(out: Any) -> None:
    """Wait for the devices of the CUDA tensors in ``out``."""
    devices = {t.device for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class Timeline:
    """Per-cell span recorder for ``GPipe``'s per-cell scheduler."""

    def __init__(self, sync: bool = False) -> None:
        self.sync = sync
        self.events: List[TimelineEvent] = []
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self.events.clear()
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since construction or :meth:`reset`: where the engine
        takes a cell's start."""
        return time.perf_counter() - self._t0

    def record(
        self,
        name: str,
        stage: int,
        mbatch: int,
        out: Any = None,
        settle: float = 0.0,
        *,
        start: Optional[float] = None,
    ) -> Any:
        """Record one cell and return ``out``; with ``sync``, wait for
        the devices of the tensors in ``out`` first.  ``settle`` seconds
        are slept inside the span, after the wait (the reference's
        straggler slot).  The span starts at ``start`` (from
        :meth:`now`; default: this call)."""
        t_start = self.now() if start is None else start
        if self.sync and out is not None:
            _sync(out)
        if settle > 0.0:
            time.sleep(settle)
        self.events.append(TimelineEvent(name, stage, mbatch, t_start, self.now()))
        return out

    def to_chrome_trace(self, path: str) -> None:
        """Write the recorded cells as Chrome trace-event JSON (one row
        per stage, one slice per cell and phase), for
        ``chrome://tracing`` or Perfetto."""
        trace = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": stage,
             "args": {"name": f"stage {stage}" if stage >= 0 else "program"}}
            for stage in sorted({e.stage for e in self.events})
        ]
        trace += [
            {"name": f"{e.name} mb{e.mbatch}", "ph": "X", "pid": 0, "tid": e.stage,
             "ts": e.t_start * 1e6, "dur": max(e.duration * 1e6, 0.01),
             "args": {"stage": e.stage, "micro_batch": e.mbatch, "kind": e.name}}
            for e in self.events
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)

    def by_stage(self) -> dict:
        out: dict = {}
        for ev in self.events:
            out.setdefault(ev.stage, []).append(ev)
        return out

    def summary(self) -> str:
        if not self.events:
            return "timeline: no events"
        total = max(ev.t_end for ev in self.events) - min(
            ev.t_start for ev in self.events
        )
        lines = [
            f"timeline: {len(self.events)} cells over {total * 1e3:.1f}ms "
            f"({'sync/serialized' if self.sync else 'async dispatch'})"
        ]
        for stage, evs in sorted(self.by_stage().items()):
            busy = sum(ev.duration for ev in evs)
            lines.append(
                f"  stage {stage}: {len(evs)} cells, "
                f"busy {busy * 1e3:.1f}ms ({100 * busy / total:.0f}%)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the CPU and (when there is one) the
    card, written to ``logdir/trace.json`` for Perfetto: the port's
    counterpart of the reference's ``jax.profiler`` trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def simulate_pipeline(
    events: List[TimelineEvent],
    n_stages: int,
    schedule: str = "fill_drain",
    virtual_stages: int = 1,
) -> Optional[Tuple[float, float, float]]:
    """Project measured per-cell times (a ``sync=True`` timeline) onto a
    pipeline schedule with perfect overlap.  ``'fill_drain'``: per phase,
    ``finish(i, j) = max(finish(i-1, j), finish(i, j-1)) + t(i, j)``,
    forward and backward separated by the loss barrier.  ``'1f1b'``: each
    stage runs its PipeDream-flush order (``pipeline.one_f1b_orders``), an
    op starting when its stage is free and its producer finished (fwd
    needs the upstream fwd; bwd the downstream bwd, or the same cell's fwd
    on the last stage).  ``'interleaved'``: the measured stages are read
    as the ``n_stages`` GLOBAL blocks of a virtual-stage layout, block
    ``g`` on device ``g % (n_stages // v)`` as chunk ``g // (n_stages //
    v)``, each device running its table order
    (:mod:`~torchgpipe_tpu_torch.parallel.interleaved`): "what would this
    measured run cost interleaved on n/v devices?".  ``'zb'``: the
    measured fused backward split into equal B and W halves (the
    dense-layer FLOP model: state it when quoting), scheduled by the
    zero-bubble order (:mod:`~torchgpipe_tpu_torch.parallel.zerobubble`).
    Cells observed over several steps are averaged into one step; barrier
    spans (negative micro-batch or stage) are left out.  Returns
    ``(makespan_seconds, busy_fraction, bubble_fraction)``, or None
    without cells; compare the fill-drain bubble with the analytic
    ``(n - 1) / (m + n - 1)`` of uniform cells: the gap is stage
    imbalance."""
    if schedule not in ("fill_drain", "1f1b", "interleaved", "zb"):
        raise ValueError(
            "schedule must be 'fill_drain', '1f1b', 'interleaved' or 'zb'"
        )
    if schedule == "interleaved":
        if virtual_stages < 2:
            raise ValueError("interleaved projection needs virtual_stages >= 2")
        if n_stages % virtual_stages != 0:
            raise ValueError(
                f"n_stages ({n_stages}) must divide by virtual_stages "
                f"({virtual_stages}): measured stages become the global "
                "blocks of the virtual layout"
            )
    elif virtual_stages != 1:
        raise ValueError("virtual_stages only applies to 'interleaved'")
    events = [e for e in events if e.mbatch >= 0 and e.stage >= 0]
    if not events:
        return None
    sums: dict = {}
    counts: dict = {}
    for ev in events:
        key = (ev.name, ev.mbatch, ev.stage)
        sums[key] = sums.get(key, 0.0) + ev.duration
        counts[key] = counts.get(key, 0) + 1
    by_phase: dict = {}
    for (name, i, j), total in sums.items():
        by_phase.setdefault(name, {})[(i, j)] = total / counts[(name, i, j)]
    if schedule == "1f1b":
        makespan = _simulate_1f1b(by_phase, n_stages)
    elif schedule == "interleaved":
        makespan = _simulate_interleaved(by_phase, n_stages, virtual_stages)
    elif schedule == "zb":
        makespan = _simulate_zb(by_phase, n_stages)
    else:
        makespan = 0.0
        for cells in by_phase.values():
            m = 1 + max(i for i, _ in cells)
            n = 1 + max(j for _, j in cells)
            finish = [[0.0] * n for _ in range(m)]
            for i in range(m):
                for j in range(n):
                    prev = max(finish[i - 1][j] if i else 0.0,
                               finish[i][j - 1] if j else 0.0)
                    finish[i][j] = prev + cells.get((i, j), 0.0)
            makespan += finish[m - 1][n - 1]
    if makespan is None or makespan <= 0:
        return None
    # busy/bubble are per EXECUTION UNIT: devices (n/v of the measured
    # global blocks) for the interleaved projection, stages otherwise.
    units = n_stages // virtual_stages if schedule == "interleaved" else n_stages
    busy = sum(c for cells in by_phase.values() for c in cells.values()) / (
        units * makespan)
    return makespan, busy, 1.0 - busy


def _list_schedule(orders: Any, dep_fn: Callable, time_fn: Callable) -> Optional[float]:
    """The projections' dependency-driven list scheduler: each unit runs
    its ``orders`` row in order, an op starting when its unit is free and
    ``dep_fn(op, j)`` (or None) has finished; ``time_fn(op, j)`` prices
    the op.  The makespan, or None on a deadlock."""
    n = len(orders)
    done: dict = {}
    pos = [0] * n
    unit_free = [0.0] * n
    total = sum(len(o) for o in orders)
    scheduled = 0
    while scheduled < total:
        progressed = False
        for j in range(n):
            while pos[j] < len(orders[j]):
                op = orders[j][pos[j]]
                dep = dep_fn(op, j)
                if dep is not None and dep not in done:
                    break
                start = max(unit_free[j], done[dep] if dep is not None else 0.0)
                finish = start + time_fn(op, j)
                done[op + (j,)] = finish
                unit_free[j] = finish
                pos[j] += 1
                scheduled += 1
                progressed = True
        if not progressed:
            return None
    return max(unit_free)


def _simulate_interleaved(by_phase: dict, n_blocks: int, v: int) -> Optional[float]:
    """Completion times of the interleaved op order: measured cell ``(i,
    g)`` is micro-batch ``i`` on global block ``g = c*n + dev`` (n =
    n_blocks // v devices); fwd g needs fwd g-1, bwd g needs bwd g+1, the
    last block's bwd its own fwd."""
    from torchgpipe_tpu_torch.parallel.interleaved import (
        BWD, FWD, _cell_sequence, _producer)

    fwd = by_phase.get("fwd", {})
    bwd = by_phase.get("bwd", {})
    if not fwd:
        return None
    n = n_blocks // v
    m = 1 + max(i for i, _ in fwd)
    if m % n != 0:
        raise ValueError(
            f"interleaved projection needs the measured micro-batch count "
            f"({m}) divisible by the device count n_stages//virtual_stages "
            f"({n})"
        )
    orders = [_cell_sequence(n, m, v, j) for j in range(n)]

    def dep_fn(op, j):
        kind, c, i = op
        dep = _producer(n, v, kind, c, i, j)
        if dep is None and kind == BWD:
            return (FWD, c, i, j)   # the loss seed: its own forward
        return dep

    def time_fn(op, j):
        kind, c, i = op
        return (fwd if kind == FWD else bwd).get((i, c * n + j), 0.0)

    return _list_schedule(orders, dep_fn, time_fn)


def _simulate_zb(by_phase: dict, n: int) -> Optional[float]:
    """Zero-bubble projection: each measured backward split into a B and
    a W half of equal time, in the zero-bubble op order."""
    from torchgpipe_tpu_torch.parallel.zerobubble import B, F, _dep, _zb_sequence

    fwd = by_phase.get("fwd", {})
    bwd = by_phase.get("bwd", {})
    if not fwd:
        return None
    m = 1 + max(i for i, _ in fwd)
    orders = [_zb_sequence(n, m, j) for j in range(n)]

    def dep_fn(op, j):
        kind, i = op
        dep = _dep(n, kind, i, j)
        if dep is not None:
            return dep
        if kind == B and j == n - 1:
            return (F, i, j)   # the loss seed: its own forward
        if kind not in (F, B):
            return (B, i, j)   # W after its own B
        return None

    def time_fn(op, j):
        kind, i = op
        return fwd.get((i, j), 0.0) if kind == F else bwd.get((i, j), 0.0) / 2.0

    return _list_schedule(orders, dep_fn, time_fn)


def _simulate_1f1b(by_phase: dict, n: int) -> Optional[float]:
    """Completion times of the PipeDream-flush order."""
    from torchgpipe_tpu_torch.pipeline import one_f1b_orders

    fwd = by_phase.get("fwd", {})
    bwd = by_phase.get("bwd", {})
    if not fwd:
        return None
    m = 1 + max(i for i, _ in fwd)

    def dep_fn(op, j):
        kind, i = op
        if kind == "fwd":
            return ("fwd", i, j - 1) if j > 0 else None
        return ("bwd", i, j + 1) if j < n - 1 else ("fwd", i, j)

    def time_fn(op, j):
        kind, i = op
        return (fwd if kind == "fwd" else bwd).get((i, j), 0.0)

    return _list_schedule(one_f1b_orders(m, n), dep_fn, time_fn)


__all__ = ["Timeline", "TimelineEvent", "device_trace", "simulate_pipeline"]
