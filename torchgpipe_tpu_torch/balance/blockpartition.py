"""Optimal contiguous block partitioning of a cost sequence.

Counterpart of ``torchgpipe_tpu/balance/blockpartition.py``: split a
sequence into ``partitions`` contiguous blocks minimising the maximum
block sum (the pipeline's bottleneck stage), by the exact O(n^2 k)
dynamic program, with the same tie-breaking (the earliest cut wins).
The reference also has a C++ build of it (``_native/``); its own
fallback is this Python, so the port needs no host compiler.
"""

from __future__ import annotations

from typing import List, Sequence


def solve(sequence: Sequence[float], partitions: int = 1) -> List[List[float]]:
    """Split ``sequence`` into ``partitions`` contiguous blocks minimizing
    the maximum block sum; returns the blocks.  Raises ``ValueError`` on
    an infeasible request, with the reference's wording."""
    if partitions < 1:
        raise ValueError("partitions must be a positive integer")
    n = len(sequence)
    if n < partitions:
        raise ValueError(
            f"sequence length is less than intended partitions (sequence: {n}, "
            f"partitions: {partitions})"
        )

    prefix = [0.0]
    for c in sequence:
        prefix.append(prefix[-1] + float(c))

    INF = float("inf")
    # dp[k][j]: least possible maximum block sum of costs[:j] in k blocks.
    dp = [[INF] * (n + 1) for _ in range(partitions + 1)]
    cut = [[0] * (n + 1) for _ in range(partitions + 1)]
    dp[0][0] = 0.0
    for k in range(1, partitions + 1):
        prev = dp[k - 1]
        # Each of the remaining partitions needs at least one element.
        for j in range(k, n - (partitions - k) + 1):
            best, best_i = INF, k - 1
            pj = prefix[j]
            for i in range(k - 1, j):
                cand = max(prev[i], pj - prefix[i])
                if cand < best:
                    best, best_i = cand, i
            dp[k][j] = best
            cut[k][j] = best_i

    bounds = [n]
    j = n
    for k in range(partitions, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    bounds.reverse()
    return [list(sequence[bounds[b]:bounds[b + 1]]) for b in range(partitions)]


def solve_sizes(sequence: Sequence[float], partitions: int = 1) -> List[int]:
    """Like :func:`solve` but return block *lengths*: the ``balance``."""
    return [len(b) for b in solve(sequence, partitions)]
