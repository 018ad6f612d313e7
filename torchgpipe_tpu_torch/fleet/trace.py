"""Deterministic synthetic request traces: the fleet's measurement fuel.

Counterpart of ``torchgpipe_tpu/fleet/trace.py`` (pure numpy, copied so
the port imports nothing of the reference).  It generates production-
SHAPED load, seeded and reproducible, lazily:

* **ragged lengths** — prompt and generation budgets drawn per request
  from configured ranges (uniform);
* **bursty arrivals** — a two-state Markov-modulated Poisson process
  (burst/calm states with separate rates, geometric dwell times);
* **shared-prefix tenants** — each tenant owns a fixed system prompt
  prepended to every one of its requests, tenant popularity ~ 1/rank —
  the workload a radix prefix cache exists for;
* **sessions** — a fraction of requests continue an existing tenant
  session (router affinity food).

Determinism: the stream is a pure function of ``TraceConfig`` (one
``numpy.random.RandomState(seed)`` consumed sequentially, in the
reference's order), so the same config gives the reference's trace byte
for byte.

A request whose prompt + budget cannot fit ``max_len`` is never
silently resized: :func:`synthetic_trace` SKIPS it and counts it in
``TraceStats.skipped_too_long``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One synthetic request."""

    index: int
    arrival_s: float
    tenant: int
    session: str
    prompt: np.ndarray           # [s] int32 = tenant prefix + suffix
    prefix_len: int              # tokens shared with the whole tenant
    max_new_tokens: int


@dataclasses.dataclass
class TraceStats:
    """What the generator produced — and what it refused to."""

    generated: int = 0
    skipped_too_long: int = 0
    burst_arrivals: int = 0
    total_prompt_tokens: int = 0
    shared_prefix_tokens: int = 0
    burst_prompt_tokens: int = 0
    last_arrival_s: float = 0.0
    per_tenant: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def shareable_fraction(self) -> float:
        """Fraction of prompt tokens inside a tenant prefix — the
        prefix cache's theoretical reuse ceiling on this trace."""
        if not self.total_prompt_tokens:
            return 0.0
        return self.shared_prefix_tokens / self.total_prompt_tokens


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for :func:`synthetic_trace`; defaults make a small, CPU-
    friendly mix (scale ``n_requests`` to millions — generation is
    lazy and O(prompt length) per request)."""

    n_requests: int
    seed: int = 0
    vocab: int = 64
    n_tenants: int = 4
    # Tenant shared-prefix lengths drawn once per tenant from this range
    # (inclusive); tenant popularity ~ 1/rank (Zipf-ish).
    prefix_len: Tuple[int, int] = (6, 12)
    # Per-request unique suffix length range (inclusive; >= 1 so the
    # full prompt is never exactly the bare tenant prefix).
    suffix_len: Tuple[int, int] = (1, 8)
    new_tokens: Tuple[int, int] = (2, 12)
    # Requests must fit prompt + budget <= max_len (the pool contract);
    # misfits are SKIPPED AND COUNTED, never resized silently.
    max_len: int = 64
    # Markov-modulated Poisson arrivals: mean inter-arrival seconds per
    # state, and the per-arrival probability of switching state.
    calm_gap_s: float = 0.05
    burst_gap_s: float = 0.002
    p_enter_burst: float = 0.1
    p_exit_burst: float = 0.3
    # Fraction of requests that continue an existing tenant session.
    p_continue_session: float = 0.3
    # Burst-state length overrides (None = bursts change ONLY arrival
    # timing, the pre-disaggregation behaviour — traces generated under
    # old configs stay byte-identical).  Set to shift the burst state's
    # suffix-length / generation-budget ranges, e.g. long-prompt
    # prefill storms over a short-prompt base load — the mix
    # phase-disaggregated serving exists for.
    burst_suffix_len: Optional[Tuple[int, int]] = None
    burst_new_tokens: Optional[Tuple[int, int]] = None


def tenant_prefixes(cfg: TraceConfig) -> List[np.ndarray]:
    """Each tenant's fixed system prompt (deterministic per config) —
    drawn from a DEDICATED stream so callers can reconstruct them
    without walking the trace."""
    rng = np.random.RandomState(cfg.seed ^ 0x7E7A17)
    out: List[np.ndarray] = []
    lo, hi = cfg.prefix_len
    for _ in range(cfg.n_tenants):
        n = int(rng.randint(lo, hi + 1))
        out.append(rng.randint(0, cfg.vocab, (n,)).astype(np.int32))
    return out


def synthetic_trace(
    cfg: TraceConfig,
    stats: Optional[TraceStats] = None,
) -> Iterator[TraceRequest]:
    """Lazily yield ``cfg.n_requests`` seeded requests (see the module
    docstring for the shape).  Pass a :class:`TraceStats` to collect
    the honesty counters while streaming."""
    rng = np.random.RandomState(cfg.seed)
    prefixes = tenant_prefixes(cfg)
    # Zipf-ish popularity: tenant k with weight 1/(k+1).
    weights = np.array(
        [1.0 / (k + 1) for k in range(cfg.n_tenants)], np.float64
    )
    weights /= weights.sum()
    now = 0.0
    burst = False
    sessions: List[Tuple[int, str]] = []   # (tenant, session id)
    emitted = 0
    attempt = 0
    while emitted < cfg.n_requests:
        attempt += 1
        # arrival process
        if burst:
            gap_mean = cfg.burst_gap_s
            if rng.rand() < cfg.p_exit_burst:
                burst = False
        else:
            gap_mean = cfg.calm_gap_s
            if rng.rand() < cfg.p_enter_burst:
                burst = True
        now += float(rng.exponential(gap_mean))
        # tenant + session
        tenant = int(rng.choice(cfg.n_tenants, p=weights))
        if sessions and rng.rand() < cfg.p_continue_session:
            tenant, session = sessions[int(rng.randint(len(sessions)))]
        else:
            session = f"t{tenant}-s{attempt}"
            sessions.append((tenant, session))
            if len(sessions) > 64:      # bounded memory at 1e6 requests
                sessions.pop(0)
        prefix = prefixes[tenant]
        s_lo, s_hi = cfg.suffix_len
        n_lo, n_hi = cfg.new_tokens
        if burst:
            if cfg.burst_suffix_len is not None:
                s_lo, s_hi = cfg.burst_suffix_len
            if cfg.burst_new_tokens is not None:
                n_lo, n_hi = cfg.burst_new_tokens
        suffix_n = int(rng.randint(s_lo, s_hi + 1))
        suffix = rng.randint(0, cfg.vocab, (suffix_n,)).astype(np.int32)
        prompt = np.concatenate([prefix, suffix])
        new = int(rng.randint(n_lo, n_hi + 1))
        if prompt.size + new > cfg.max_len:
            # The honesty rule: count, never silently shrink.
            if stats is not None:
                stats.skipped_too_long += 1
            continue
        req = TraceRequest(
            index=emitted,
            arrival_s=now,
            tenant=tenant,
            session=session,
            prompt=prompt,
            prefix_len=int(prefix.size),
            max_new_tokens=new,
        )
        if stats is not None:
            # Counted AFTER the skip check: burst_arrivals shares
            # generated's population, so burst_fraction stays <= 1
            # under heavy skipping.
            if burst:
                stats.burst_arrivals += 1
                stats.burst_prompt_tokens += int(prompt.size)
            stats.generated += 1
            stats.total_prompt_tokens += int(prompt.size)
            stats.shared_prefix_tokens += int(prefix.size)
            stats.last_arrival_s = now
            stats.per_tenant[tenant] = (
                stats.per_tenant.get(tenant, 0) + 1
            )
        emitted += 1
        yield req


def prefill_heavy_config(
    n_requests: int,
    seed: int = 0,
    max_len: int = 64,
    **overrides: object,
) -> TraceConfig:
    """The disaggregation stress mix: a short-prompt, decode-dominated
    base load punctuated by bursts of LONG prompts with small budgets —
    prefill storms.  On a unified fleet every storm steals decode
    iterations from in-flight streams (TPOT spikes); a phase-split
    fleet absorbs it in the prefill pool.  Deterministic per (n_requests, seed,
    max_len); keyword overrides replace any field."""
    burst_lo = max_len // 2
    cfg = dict(
        n_requests=n_requests,
        seed=seed,
        max_len=max_len,
        prefix_len=(4, 6),
        suffix_len=(1, 4),
        new_tokens=(6, 12),
        burst_suffix_len=(burst_lo, max(burst_lo, max_len - 14)),
        burst_new_tokens=(2, 4),
        p_enter_burst=0.15,
        p_exit_burst=0.35,
    )
    cfg.update(overrides)
    return TraceConfig(**cfg)  # type: ignore[arg-type]


def trace_summary(cfg: TraceConfig,
                  sample: int = 2048) -> Dict[str, float]:
    """Cheap summary of a config by walking ``sample`` requests — for
    logging next to measured numbers."""
    stats = TraceStats()
    for _ in synthetic_trace(
        dataclasses.replace(cfg, n_requests=min(cfg.n_requests, sample)),
        stats,
    ):
        pass
    denom = max(stats.generated, 1)
    return {
        "requests": float(stats.generated),
        "skipped_too_long": float(stats.skipped_too_long),
        "shareable_fraction": stats.shareable_fraction,
        "burst_fraction": stats.burst_arrivals / denom,
        "mean_arrival_gap_s": (
            stats.last_arrival_s / denom
        ),
    }


__all__ = [
    "TraceConfig",
    "TraceRequest",
    "TraceStats",
    "prefill_heavy_config",
    "synthetic_trace",
    "tenant_prefixes",
    "trace_summary",
]
