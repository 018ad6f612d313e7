"""Zero-bubble (ZB-H1-style) pipeline schedule tables.

The port's own copy of ``torchgpipe_tpu/parallel/zerobubble.py`` (plain
numpy; the same tables, bit for bit, and the same errors).  The classic
backward cell does two jobs at once: the ACTIVATION gradient (dx, on the
critical path: the upstream stage waits for it) and the WEIGHT gradient
(dW, consumed only by the optimizer at step end).  Zero-bubble schedules
(Qi et al., "Zero Bubble Pipeline Parallelism", arXiv:2401.10241) split
them: ``B`` cells compute only dx and hand the cotangent upstream at once;
``W`` cells compute dW afterwards, in ticks 1F1B would leave idle.

The schedule is a STATIC table from lockstep list-scheduling: per stage the
F/B order is exactly classic 1F1B (the in-flight activation bound n - j is
kept), with each micro-batch's W placed immediately after its B (the
H1-style memory-bounded choice: the kept graphs and cotangents stay within
the 1F1B window).  Early stages' drain tail is thereby W-filled; warm-up
stalls of late stages stay idle.  The generator also proves the buffer
geometry the reference's compiled scan uses: ring-slot depths for the
activation/cotangent inboxes, the stored residuals (live F -> W) and the
stored cotangents (live B -> W), each validated collision-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

F, B, W, IDLE = 0, 1, 2, 3


def _zb_sequence(n: int, m: int, j: int) -> List[Tuple[int, int]]:
    """Stage ``j``'s ZB op order: classic 1F1B warmup and F/B cadence,
    with each micro-batch's W immediately after its B.

    The immediate-W placement is the memory-bounded (H1-style) choice:
    the stored-vjp residuals (live F → W) and stored cotangents (live
    B → W) stay within the 1F1B in-flight window instead of piling up to
    O(m), while the split still halves the per-tick backward cost and the
    early stages' drain tail is W-filled rather than idle."""
    warmup = min(n - j - 1, m)
    seq: List[Tuple[int, int]] = [(F, i) for i in range(warmup)]
    f, b = warmup, 0
    while f < m:
        seq.append((F, f)); f += 1
        seq.append((B, b)); seq.append((W, b)); b += 1
    while b < m:
        seq.append((B, b)); seq.append((W, b)); b += 1
    return seq


def _dep(n: int, kind: int, i: int, j: int) -> Optional[Tuple[int, int, int]]:
    """The remote cell this cell consumes, or None (external input /
    same-stage dependencies handled by the caller)."""
    if kind == F:
        return (F, i, j - 1) if j > 0 else None
    if kind == B:
        return (B, i, j + 1) if j < n - 1 else None
    return None  # W depends on the SAME stage's B — checked separately


@dataclass(frozen=True)
class ZeroBubbleTables:
    """Static ZB schedule plus the proven buffer geometry."""

    n: int
    m: int
    ticks: int
    kind: np.ndarray       # [T, n] int32 in {F, B, W, IDLE}
    mb: np.ndarray         # [T, n] int32
    slots: int             # act/cotangent inbox ring depth (i % slots)
    y_slots: int           # last-stage loss-seed ring depth (F -> B span)
    resid_slots: int       # stored-vjp residual ring depth (F -> W span)
    dy_slots: int          # stored-cotangent ring depth (B -> W span)
    x_slots: int           # stored cell-INPUT ring depth (F -> B span) —
                           # the recompute variant (checkpoint='always')
                           # stores inputs instead of F-time vjp residuals

    @property
    def bubble_ticks(self) -> int:
        return self.ticks * self.n - 3 * self.m * self.n  # idle cells

    def weighted_makespan(self, t_f: float, t_b: float, t_w: float) -> float:
        """Lockstep makespan with per-op costs (each tick costs the max
        over the stages' ops that tick) — the number the schedule exists
        to minimize."""
        cost = {F: t_f, B: t_b, W: t_w, IDLE: 0.0}
        return float(
            sum(
                max(cost[int(k)] for k in row)
                for row in self.kind
            )
        )


def fused_1f1b_weighted_makespan(
    n: int, m: int, t_f: float = 1.0, t_bw: float = 2.0
) -> float:
    """Exact lockstep cost of classic 1F1B with a FUSED backward (dx+dW in
    one cell costing ``t_bw``), from the closed-form 1F1B tick predicates
    (:func:`torchgpipe_tpu_torch.spmd.fwd_tick` / ``bwd_tick``).

    The comparator for :meth:`ZeroBubbleTables.weighted_makespan`: the
    zb win is this figure over the zb makespan at uniform split costs
    ``(t_f, t_bw/2, t_bw/2)``; the ratio depends on the cost profile, so
    evaluate it at measured costs."""
    total = 0.0
    for t in range(2 * (m + n - 1)):
        c = 0.0
        for j in range(n):
            tj = t - j
            warm = 0 <= tj <= n - 1 - j and tj < m
            i_s = tj // 2 if tj >= 0 else 0
            steady = tj >= 0 and tj % 2 == 0 and i_s > n - 1 - j and i_s < m
            num = t + j - (2 * n - 1)
            do_b = num >= 0 and num % 2 == 0 and num // 2 < m
            if do_b:
                c = max(c, t_bw)
            elif warm or steady:
                c = max(c, t_f)
        total += c
    return total


def _min_depth(spans: dict) -> int:
    """Smallest power-of-two depth S such that slot ``(j, i % S)`` never
    holds two live values at once (inclusive tick intervals)."""

    def fits(s: int) -> bool:
        by_slot: dict = {}
        for (j, i), span in spans.items():
            by_slot.setdefault((j, i % s), []).append(span)
        for intervals in by_slot.values():
            intervals.sort()
            for a, b in zip(intervals, intervals[1:]):
                if b[0] <= a[1]:
                    return False
        return True

    for s in (1 << p for p in range(0, 16)):
        if fits(s):
            return s
    raise RuntimeError("no feasible slot depth found")


def zero_bubble_tables(n: int, m: int) -> ZeroBubbleTables:
    """Greedy lockstep scheduling of the split-backward schedule; the
    result is validated (every op exactly once, dependencies strictly
    ordered, buffer slots collision-free) before returning."""
    if n < 1 or m < 1:
        raise ValueError(f"need n, m >= 1, got n={n} m={m}")
    seqs = [_zb_sequence(n, m, j) for j in range(n)]
    pos = [0] * n
    done: dict = {}  # (kind, i, j) -> tick
    rows_kind: List[List[int]] = []
    rows_mb: List[List[int]] = []
    t = 0
    limit = 8 * m * n + 8 * n + 64
    while any(pos[j] < len(seqs[j]) for j in range(n)):
        if t > limit:
            raise RuntimeError(f"zb schedule did not converge (n={n} m={m})")
        krow, irow = [IDLE] * n, [0] * n
        fired = []
        for j in range(n):
            if pos[j] >= len(seqs[j]):
                continue
            kind, i = seqs[j][pos[j]]
            dep = _dep(n, kind, i, j)
            ok = dep is None or done.get(dep, t) < t
            if kind == B and j == n - 1:
                # Loss seed: this stage's own forward, earlier tick.
                ok = ok and done.get((F, i, j), t) < t
            if kind == W:
                # Same-stage split: W replays the residuals B touched and
                # the cotangent B stored — strictly after B's tick.
                ok = done.get((B, i, j), t) < t
            if ok:
                krow[j], irow[j] = kind, i
                fired.append((kind, i, j))
                pos[j] += 1
        for cell in fired:
            done[cell] = t
        rows_kind.append(krow)
        rows_mb.append(irow)
        t += 1

    # ---- spans -> proven buffer depths -------------------------------- #
    tick_of: dict = {}
    for tt, (krow, irow) in enumerate(zip(rows_kind, rows_mb)):
        for j in range(n):
            if krow[j] != IDLE:
                tick_of[(krow[j], irow[j], j)] = tt
    act_spans: dict = {}   # delivered act -> F reads it
    cot_spans: dict = {}   # delivered cotangent -> B reads it
    y_spans: dict = {}     # last-stage F output -> B loss seed
    resid_spans: dict = {}  # F stores vjp residuals -> W last read
    dy_spans: dict = {}    # B stores its cotangent -> W reads it
    x_spans: dict = {}     # F stores its input -> B recomputes from it
    for (kind, i, j), tt in tick_of.items():
        if kind == F:
            if j > 0:
                act_spans[(j, i)] = (tick_of[(F, i, j - 1)] + 1, tt)
            if j == n - 1:
                y_spans[(j, i)] = (tt, tick_of[(B, i, j)])
            resid_spans[(j, i)] = (tt, tick_of[(W, i, j)])
            x_spans[(j, i)] = (tt, tick_of[(B, i, j)])
        elif kind == B:
            if j < n - 1:
                cot_spans[(j, i)] = (tick_of[(B, i, j + 1)] + 1, tt)
            dy_spans[(j, i)] = (tt, tick_of[(W, i, j)])
    tables = ZeroBubbleTables(
        n=n, m=m, ticks=t,
        kind=np.asarray(rows_kind, np.int32),
        mb=np.asarray(rows_mb, np.int32),
        # The activation and cotangent spans share one slot array; tag the
        # merged keys structurally so stage j's cotangents can never alias
        # stage j's activations, whatever n is.
        slots=_min_depth({
            **{(("act", j), i): s for (j, i), s in act_spans.items()},
            **{(("cot", j), i): s for (j, i), s in cot_spans.items()},
        }),
        y_slots=_min_depth(y_spans) if y_spans else 1,
        resid_slots=_min_depth(resid_spans),
        dy_slots=_min_depth(dy_spans),
        x_slots=_min_depth(x_spans),
    )
    _validate(tables)
    return tables


def _validate(tb: ZeroBubbleTables) -> None:
    n, m = tb.n, tb.m
    done: dict = {}
    counts = {F: 0, B: 0, W: 0}
    for t in range(tb.ticks):
        for j in range(n):
            k = int(tb.kind[t, j])
            if k == IDLE:
                continue
            cell = (k, int(tb.mb[t, j]), j)
            if cell in done:
                raise AssertionError(f"cell {cell} scheduled twice")
            dep = _dep(n, k, cell[1], j)
            if dep is not None and not done.get(dep, t) < t:
                raise AssertionError(f"{cell} at {t} before dep {dep}")
            if k == B and j == n - 1:
                if not done.get((F, cell[1], j), t) < t:
                    raise AssertionError(f"{cell} before its loss-seed fwd")
            if k == W:
                if not done.get((B, cell[1], j), t) < t:
                    raise AssertionError(f"{cell} before its B")
            done[cell] = t
            counts[k] += 1
    if not (counts[F] == counts[B] == counts[W] == n * m):
        raise AssertionError(f"op counts wrong: {counts} for n={n} m={m}")
