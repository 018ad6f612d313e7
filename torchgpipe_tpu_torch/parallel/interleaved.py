"""Interleaved-1F1B (virtual pipeline stages) schedule tables.

The port's own copy of ``torchgpipe_tpu/parallel/interleaved.py`` (plain
numpy; the same tables, bit for bit, and the same errors).  Megatron-style
interleaved pipelining: each of the ``n`` ranks of the ``pp`` axis owns
``v`` non-adjacent model chunks (rank ``j`` holds global blocks ``c*n + j``
for ``c in range(v)``), so a micro-batch visits every rank ``v`` times and
the fill/drain bubble shrinks by ~``v``.

The schedule is *static*: :func:`interleaved_tables` runs a lockstep
list-scheduling simulation (each rank executes its cells in the canonical
Megatron order, stalling until data dependencies are satisfied) and
returns dense per-tick tables.  :class:`~torchgpipe_tpu_torch.spmd.SpmdGPipe`
runs each rank's column in tick order, so a cell's input was sent at an
earlier tick by the rank that produced it.  Schedule shape: Narayanan et
al., "Efficient Large-Scale Language Model Training on GPU Clusters Using
Megatron-LM" (arXiv:2104.04473) section 2.2.

Conventions
-----------
* ``kind``: 0 = forward, 1 = backward, 2 = idle.
* ``chunk``: local chunk index ``c`` (global block = ``c*n + j``).
* ``mb``: micro-batch index ``i``.
* Tables are ``[T, n]``: one row per tick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

FWD, BWD, IDLE = 0, 1, 2


def _cell_sequence(n: int, m: int, v: int, j: int) -> List[Tuple[int, int, int]]:
    """Device ``j``'s cell order: warmup forwards, 1F1B steady state, drain.

    Forward cells are enumerated in Megatron order (micro-batches in groups
    of ``n``; the chunk index advances after each group), backwards in the
    mirror order with chunks reversed.
    """
    total = m * v

    def fwd_cell(k: int) -> Tuple[int, int, int]:
        chunk = (k // n) % v
        mb = (k // (n * v)) * n + k % n
        return (FWD, chunk, mb)

    def bwd_cell(k: int) -> Tuple[int, int, int]:
        chunk = v - 1 - ((k // n) % v)
        mb = (k // (n * v)) * n + k % n
        return (BWD, chunk, mb)

    if v == 1:
        warmup = min(n - j - 1, total)  # classic 1F1B depth
    else:
        warmup = min((n - j - 1) * 2 + (v - 1) * n, total)
    seq: List[Tuple[int, int, int]] = [fwd_cell(k) for k in range(warmup)]
    f, b = warmup, 0
    while f < total:
        seq.append(fwd_cell(f)); f += 1
        seq.append(bwd_cell(b)); b += 1
    while b < total:
        seq.append(bwd_cell(b)); b += 1
    return seq


def _producer(
    n: int,
    v: int,
    kind: int,
    c: int,
    i: int,
    j: int,
) -> Optional[Tuple[int, int, int, int]]:
    """The cell whose output this cell consumes, or None for an external
    input (forward chunk 0 stage 0) / the local loss seed (backward chunk
    v-1 stage n-1, which also depends on its own forward — handled by the
    caller as a same-device dependency)."""
    if kind == FWD:
        if j > 0:
            return (FWD, c, i, j - 1)
        if c > 0:
            return (FWD, c - 1, i, n - 1)
        return None
    if j < n - 1:
        return (BWD, c, i, j + 1)
    if c < v - 1:
        return (BWD, c + 1, i, 0)
    return None


@dataclass(frozen=True)
class InterleavedTables:
    """Static schedule tables plus the buffer geometry the engine needs."""

    n: int
    m: int
    v: int
    ticks: int
    kind: np.ndarray   # [T, n] int32
    chunk: np.ndarray  # [T, n] int32
    mb: np.ndarray     # [T, n] int32
    slots: int         # inbox/saved-input ring-buffer depth (per chunk)

    @property
    def bubble_ticks(self) -> int:
        return self.ticks - 2 * self.m * self.v


def _check_args(n: int, m: int, v: int) -> None:
    if n < 1 or v < 1 or m < 1:
        raise ValueError(f"need n, m, v >= 1, got n={n} m={m} v={v}")
    if v > 1 and m % n != 0:
        raise ValueError(
            f"interleaved schedule needs chunks (m={m}) divisible by the "
            f"pipeline depth (n={n}) — Megatron's micro-batch grouping "
            "(arXiv:2104.04473 §2.2) assumes full groups"
        )


def _lockstep_simulate(
    n: int,
    v: int,
    seqs: List[List[Tuple[int, int, int]]],
) -> Tuple[List[List[int]], List[List[int]], List[List[int]]]:
    """Lockstep list-scheduling of per-device cell sequences into rows.

    Each tick, every device attempts its next cell; a cell runs only if
    its producer ran at a *strictly earlier* tick (hand-offs take one
    ppermute tick; same-device dependencies also resolve tick-to-tick).
    The simulation terminates — each tick at least the globally-earliest
    unsatisfied cell's producer chain makes progress.
    """
    pos = [0] * n
    done: dict = {}  # (kind, c, i, j) -> tick
    rows_kind: List[List[int]] = []
    rows_chunk: List[List[int]] = []
    rows_mb: List[List[int]] = []
    t = 0
    total = sum(len(s) for s in seqs)
    limit = 4 * total + 4 * n * v + 64  # far above any valid schedule
    while any(pos[j] < len(seqs[j]) for j in range(n)):
        if t > limit:
            raise RuntimeError(
                f"schedule did not converge (n={n} v={v}, {total} cells)"
            )
        krow, crow, irow = [IDLE] * n, [0] * n, [0] * n
        fired = []
        for j in range(n):
            if pos[j] >= len(seqs[j]):
                continue
            kind, c, i = seqs[j][pos[j]]
            dep = _producer(n, v, kind, c, i, j)
            ok = dep is None or done.get(dep, t) < t
            if kind == BWD and c == v - 1 and j == n - 1:
                # Loss seed: needs this device's own forward of the same
                # cell at an earlier tick.
                ok = ok and done.get((FWD, c, i, j), t) < t
            if ok:
                krow[j], crow[j], irow[j] = kind, c, i
                fired.append((kind, c, i, j))
                pos[j] += 1
        # Commit AFTER scanning all devices: cells fired this tick must not
        # satisfy same-tick dependencies.
        for cell in fired:
            done[cell] = t
        rows_kind.append(krow); rows_chunk.append(crow); rows_mb.append(irow)
        t += 1
    return rows_kind, rows_chunk, rows_mb, t


def interleaved_tables(n: int, m: int, v: int) -> InterleavedTables:
    """Lockstep-simulate the interleaved training schedule into dense
    tables; the result is checked for validity before returning."""
    _check_args(n, m, v)
    seqs = [_cell_sequence(n, m, v, j) for j in range(n)]
    rows_kind, rows_chunk, rows_mb, t = _lockstep_simulate(n, v, seqs)

    tables = InterleavedTables(
        n=n, m=m, v=v, ticks=t,
        kind=np.asarray(rows_kind, np.int32),
        chunk=np.asarray(rows_chunk, np.int32),
        mb=np.asarray(rows_mb, np.int32),
        slots=_required_slots(n, v, rows_kind, rows_chunk, rows_mb),
    )
    _validate(tables)
    return tables


def interleaved_forward_tables(n: int, m: int, v: int) -> InterleavedTables:
    """Forward-only tables for pipelined inference over virtual stages.

    Same lockstep simulation, but each device's sequence is just its
    ``m * v`` forward cells in Megatron order — a fill-drain schedule over
    the ``n * v`` virtual stages with round-robin device mapping.
    """
    _check_args(n, m, v)
    seqs = [
        [cell for cell in _cell_sequence(n, m, v, j) if cell[0] == FWD]
        for j in range(n)
    ]
    rows_kind, rows_chunk, rows_mb, t = _lockstep_simulate(n, v, seqs)
    # Slot depth: activation liveness only (delivery tick -> consumption;
    # no backward cells, so each span ends at the cell's own tick).
    fwd_tick, bwd_tick = _cell_ticks(n, rows_kind, rows_chunk, rows_mb)
    tables = InterleavedTables(
        n=n, m=m, v=v, ticks=t,
        kind=np.asarray(rows_kind, np.int32),
        chunk=np.asarray(rows_chunk, np.int32),
        mb=np.asarray(rows_mb, np.int32),
        slots=_min_slot_depth([_act_spans(n, v, fwd_tick, bwd_tick)]),
    )
    _validate(tables, forward_only=True)
    return tables


def _min_slot_depth(span_families: Dict) -> int:
    """Smallest power-of-two ring-buffer depth S such that, within every
    family, slot ``(device, chunk, mb % S)`` never holds two live values at
    once (liveness intervals keyed ``(j, c, i) -> (start_tick, end_tick)``,
    inclusive).  Raises rather than returning an unverified depth."""

    def fits(spans, s) -> bool:
        by_slot: dict = {}
        for (j, c, i), span in spans.items():
            by_slot.setdefault((j, c, i % s), []).append(span)
        for intervals in by_slot.values():
            intervals.sort()
            for a, b in zip(intervals, intervals[1:]):
                if b[0] <= a[1]:
                    return False
        return True

    for s in (1 << p for p in range(0, 16)):
        if all(fits(spans, s) for spans in span_families):
            return s
    raise RuntimeError("no feasible slot count found")


def _cell_ticks(
    n: int,
    rows_kind: List[List[int]],
    rows_chunk: List[List[int]],
    rows_mb: List[List[int]],
) -> Tuple[Dict, Dict]:
    """Per-cell fire ticks: ``({(j,c,i): fwd_tick}, {(j,c,i): bwd_tick})``."""
    fwd_tick: dict = {}
    bwd_tick: dict = {}
    for t, (krow, crow, irow) in enumerate(zip(rows_kind, rows_chunk, rows_mb)):
        for j in range(n):
            key = (j, crow[j], irow[j])
            if krow[j] == FWD:
                fwd_tick[key] = t
            elif krow[j] == BWD:
                bwd_tick[key] = t
    return fwd_tick, bwd_tick


def _act_spans(n: int, v: int, fwd_tick: Dict, bwd_tick: Dict) -> dict:
    """Activation inbox / saved-input liveness: from the producer's forward
    tick + 1 (the ppermute delivery; the cell's own tick when there is no
    producer) until the matching backward cell reads it (its own forward
    tick when the schedule has no backwards)."""
    spans: dict = {}
    for (j, c, i), tf in fwd_tick.items():
        dep = _producer(n, v, FWD, c, i, j)
        start = tf if dep is None else fwd_tick[(dep[3], dep[1], dep[2])] + 1
        spans[(j, c, i)] = (start, bwd_tick.get((j, c, i), tf))
    return spans


def _required_slots(
    n: int,
    v: int,
    rows_kind: List[List[int]],
    rows_chunk: List[List[int]],
    rows_mb: List[List[int]],
) -> int:
    """Slot depth for the training schedule: activation spans plus the
    cotangent-inbox spans (producer's backward tick + 1 until the consuming
    backward cell's tick)."""
    fwd_tick, bwd_tick = _cell_ticks(n, rows_kind, rows_chunk, rows_mb)
    cot_spans: dict = {}
    for (j, c, i), tb in bwd_tick.items():
        dep = _producer(n, v, BWD, c, i, j)
        if dep is not None:
            cot_spans[(j, c, i)] = (bwd_tick[(dep[3], dep[1], dep[2])] + 1, tb)
    return _min_slot_depth(
        [_act_spans(n, v, fwd_tick, bwd_tick), cot_spans]
    )


def _validate(tb: InterleavedTables, forward_only: bool = False) -> None:
    """Every cell exactly once per device; dependencies strictly ordered."""
    n, m, v = tb.n, tb.m, tb.v
    done: dict = {}
    for t in range(tb.ticks):
        for j in range(n):
            k = int(tb.kind[t, j])
            if k == IDLE:
                continue
            if forward_only and k != FWD:
                raise AssertionError(f"non-forward cell in forward tables")
            cell = (k, int(tb.chunk[t, j]), int(tb.mb[t, j]), j)
            if cell in done:
                raise AssertionError(f"cell {cell} scheduled twice")
            dep = _producer(n, v, *cell)
            if dep is not None and not (done.get(dep, t) < t):
                raise AssertionError(f"{cell} at tick {t} before dep {dep}")
            if k == BWD and cell[1] == v - 1 and j == n - 1:
                if not done.get((FWD, cell[1], cell[2], j), t) < t:
                    raise AssertionError(f"loss cell {cell} before own fwd")
            done[cell] = t
    expect = (1 if forward_only else 2) * m * v * n
    if len(done) != expect:
        raise AssertionError(f"{len(done)} cells scheduled, want {expect}")
