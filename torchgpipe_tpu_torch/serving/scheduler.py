"""Iteration-level (continuous) batching: Orca-style request scheduling.

Counterpart of ``torchgpipe_tpu/serving/scheduler.py`` (pure Python and
numpy, near-verbatim).  The scheduler decides, BETWEEN engine steps,
three things the captured programs never see (they only ever see values,
not shapes):

* **Admission** — queued requests move into free pool slots the moment
  one opens (a finished/cancelled request frees its slot in the SAME
  engine iteration), subject to the admission-control cap: with an HBM
  budget the cap is :func:`torchgpipe_tpu_torch.tune.serving_max_slots`'s
  accounting of the cache pool — admitting a request can
  never grow an array, so the cap is the entire memory story.
  ``wave_admission=True`` disables recycling (admit only into an EMPTY
  engine, run the wave to its longest request) — the static-batching
  baseline the benchmarks compare against.
* **Phase interleaving** — a request absorbs its prompt in fixed-size
  chunks (``prefill_chunk``) through the same slot-masked step decode
  uses; when both prefill work and decode-ready rows exist, the
  scheduler ALTERNATES so ongoing decodes are never starved behind a
  long prompt (chunked prefill, Orca §4/Sarathi-style).  A bucket
  LADDER (``prefill_chunk=(1, 2, 4, 8)``) admits each step at the
  smallest bucket covering its pending work, so short prompts stop
  paying the max chunk's FLOPs while the captured-program count stays
  statically bounded at ``len(ladder) + 1``.
* **Eviction** — finished (per-row EOS / max-token) and cancelled
  requests release their slot immediately.

Everything here is host-side and O(active + queued) per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from torchgpipe_tpu_torch.serving.cache_pool import CachePool


def normalize_buckets(
    prefill_chunk: Union[int, Sequence[int]]
) -> Tuple[int, ...]:
    """The prefill BUCKET LADDER from a ``prefill_chunk`` declaration:
    a single int is the classic one-chunk configuration; a sequence is a
    static ladder of chunk sizes (sorted, deduplicated), each compiling
    ONE program — a prefill step picks the smallest bucket covering its
    work, so short prompts stop paying the max chunk's FLOPs while the
    steady-state program count stays statically bounded at
    ``len(ladder) + 1`` (``analysis.serving`` certifies this)."""
    if isinstance(prefill_chunk, (int, np.integer)):
        buckets: Tuple[int, ...] = (int(prefill_chunk),)
    else:
        buckets = tuple(sorted({int(g) for g in prefill_chunk}))
    if not buckets or buckets[0] < 1:
        raise ValueError(
            f"prefill buckets must be >= 1, got {prefill_chunk!r}"
        )
    return buckets


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime state.

    ``prompt`` is the tokens to teacher-force (for a resumed request:
    original prompt + tokens already emitted before the drain, with
    ``emitted_prefix`` carrying the latter so results concatenate).
    """

    rid: str
    prompt: np.ndarray                    # [s] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    on_token: Optional[Callable[[str, int], None]] = None
    emitted_prefix: List[int] = dataclasses.field(default_factory=list)
    # QoS identity (serving/qos.py): the latency tier admission orders
    # by, and the tenant token budgets are charged to.  Both ride the
    # drain/restore snapshot, so a preempted or migrated request keeps
    # its class wherever it resumes.
    tier: str = "standard"
    tenant: Optional[str] = None

    # runtime state (engine/scheduler owned)
    status: str = "queued"   # queued|active|finished|cancelled|preempted
    slot: Optional[int] = None
    prefilled: int = 0       # prompt tokens absorbed so far
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def tokens(self) -> List[int]:
        """All tokens this request has produced (across a drain/resume)."""
        return list(self.emitted_prefix) + list(self.generated)


class Scheduler:
    """Continuous-batching admission/interleave/eviction policy."""

    def __init__(
        self,
        pool: CachePool,
        *,
        prefill_chunk: Union[int, Sequence[int]] = 8,
        max_active: Optional[int] = None,
        wave_admission: bool = False,
        qos: Optional[Any] = None,
    ) -> None:
        self.prefill_buckets = normalize_buckets(prefill_chunk)
        self.pool = pool
        # The classic single-chunk attribute stays the LADDER MAX — the
        # largest program any prefill step can dispatch.
        self.prefill_chunk = self.prefill_buckets[-1]
        self.max_active = (
            pool.num_slots if max_active is None
            else min(max_active, pool.num_slots)
        )
        if self.max_active < 1:
            raise ValueError(
                "admission cap is 0 slots: the cache pool does not fit "
                "the HBM budget — shrink max_len/num_slots or raise the "
                "budget (tune.serving_max_slots accounting)"
            )
        self.wave_admission = wave_admission
        # ``qos`` (serving.qos.QosPolicy) turns FIFO admission into
        # tier-ordered admission and resolves over-budget demotion at
        # pick time; None keeps classic FIFO exactly (and requests with
        # uniform tiers admit FIFO either way — the stable tie-break).
        self.qos = qos
        self.queue: List[Request] = []
        self.active: Dict[str, Request] = {}
        self._last_action = "decode"  # alternation seed: prefill first

    # ------------------------------------------------------------------ #
    # request lifecycle                                                  #
    # ------------------------------------------------------------------ #

    def submit(self, req: Request) -> None:
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid!r}: max_new_tokens must be >= 1"
            )
        if req.prompt_len + req.max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"request {req.rid!r}: prompt ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                f"pool's max_len={self.pool.max_len} — shape-static "
                "serving cannot grow a slot; raise max_len at engine "
                "build time or shorten the request"
            )
        self.queue.append(req)

    def cancel(self, rid: str) -> bool:
        """Cancel a queued or active request; its slot frees NOW."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                req.status = "cancelled"
                del self.queue[i]
                return True
        req = self.active.get(rid)
        if req is not None:
            req.status = "cancelled"
            self.release(req)
            return True
        return False

    def admit(self) -> List[Request]:
        """Move queued requests into free slots (iteration-level).

        Continuous mode admits whenever a slot is free under the cap;
        wave mode only into an idle engine (static-batching baseline)."""
        admitted: List[Request] = []
        if self.wave_admission and self.active:
            return admitted
        while (
            self.queue
            and self.pool.num_free > 0
            and len(self.active) < self.max_active
        ):
            req = self.queue.pop(self._pick_next())
            slot = self.pool.alloc(req.rid)
            assert slot is not None
            req.slot = slot
            req.status = "active"
            self.active[req.rid] = req
            admitted.append(req)
        return admitted

    def _pick_next(self) -> int:
        """The queue index the next free slot admits: highest tier
        priority first (interactive < standard < batch), arrival order
        within a tier — without a QoS policy, plain FIFO.  Over-budget
        demotion resolves HERE, against the tenant's LATEST spend: the
        demotion sticks on the request (``req.tier``), so its drain and
        migration snapshots carry the class it actually ran at, and it
        is counted once per request."""
        if self.qos is None:
            return 0
        from torchgpipe_tpu_torch.serving.qos import TIER_PRIORITY

        best, best_rank = 0, None
        for i, req in enumerate(self.queue):
            eff = self.qos.effective_tier(req.tier, req.tenant)
            if eff != req.tier:
                req.tier = eff
                self.qos.note_demotion(req.tenant)
            rank = TIER_PRIORITY[req.tier]
            if best_rank is None or rank < best_rank:
                best, best_rank = i, rank
        return best

    def release(self, req: Request) -> None:
        """Free a finished/cancelled/preempted request's slot NOW — the
        per-row early-exit that makes batching continuous."""
        if req.slot is not None:
            self.pool.free(req.slot)
            req.slot = None
        self.active.pop(req.rid, None)

    # ------------------------------------------------------------------ #
    # iteration policy                                                   #
    # ------------------------------------------------------------------ #

    def prefill_pending(self) -> List[Request]:
        return [r for r in self.active.values() if not r.prefill_done]

    def bucket_for(self, n: int) -> int:
        """The smallest ladder bucket covering ``n`` pending prompt
        tokens (the max bucket when ``n`` exceeds it — the remainder
        absorbs over further chunked steps)."""
        for g in self.prefill_buckets:
            if n <= g:
                return g
        return self.prefill_buckets[-1]

    def prefill_bucket(self) -> int:
        """The bucket THIS prefill step dispatches: the smallest ladder
        entry covering every pending request's next chunk (each request's
        chunk is its remaining prompt capped at the ladder max — one
        shared ``[slots, g]`` buffer serves all slots, masked rows
        no-ops, so the step's bucket must cover the largest take)."""
        need = 0
        cap = self.prefill_buckets[-1]
        for r in self.prefill_pending():
            need = max(need, min(r.prompt_len - r.prefilled, cap))
        return self.bucket_for(max(need, 1))

    def decode_ready(self) -> List[Request]:
        return [r for r in self.active.values() if r.prefill_done]

    def next_action(self) -> Optional[str]:
        """``'prefill'`` | ``'decode'`` | ``None`` (idle).

        When both phases have work the scheduler alternates (chunked
        prefill interleaving); otherwise whichever phase has work runs.
        """
        pre = bool(self.prefill_pending())
        dec = bool(self.decode_ready())
        if pre and dec:
            action = "decode" if self._last_action == "prefill" else "prefill"
        elif pre:
            action = "prefill"
        elif dec:
            action = "decode"
        else:
            return None
        self._last_action = action
        return action

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot — recorded on each request's
        ``req_submit`` flight event so a stitched trace can say how
        deep the line was when this request joined it."""
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active


__all__ = ["Request", "Scheduler", "normalize_buckets"]
