"""Speculative decoding over the slot-pooled serving engine.

Counterpart of ``torchgpipe_tpu/fleet/speculative.py``.  Decode is
memory-bound: every emitted token pays a full forward pass at one token
per slot.  Speculative decoding (Leviathan et al., arXiv:2211.17192)
turns that into chunked verification: a cheap DRAFT model proposes
``gamma`` tokens per slot, and the TARGET model scores all of them in
ONE chunked slot step.  Greedy acceptance keeps the leading run of
proposals the target agrees with plus the target's own next token, so
the output stream is token for token what target-only greedy decode
emits.

The program count stays statically bounded:

* the VERIFY pass reuses the engine's ``g > 1`` prefill program, which
  already writes the per-position greedy grid ``[S, g]``; acceptance is
  host-side bookkeeping over that grid.  No target program is added.
* the draft side captures one chunk program per prefill bucket (prompt
  mirroring and post-acceptance catch-up share them; the catch-up lag
  is at most 2 after the first round) plus the ``g = 1`` proposal
  program, each over the draft's own pool and frontier buffer.

Rollback is free: rejected draft tokens' rows sit ABOVE the rolled-back
frontier, where slot masking makes them dead.  The host owns per-row
acceptance, so each round re-uploads both frontier vectors once (the
engine's ``_upload_lengths`` and its draft twin).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchgpipe_tpu_torch.models.generation import (
    _check_decodable,
    _decode_slots,
    _model_device,
    _split_params,
)
from torchgpipe_tpu_torch.models.transformer import TransformerConfig
from torchgpipe_tpu_torch.serving.cache_pool import CachePool
from torchgpipe_tpu_torch.serving.engine import Engine, TensorSpec, _Program


class _DraftProgram(_Program):
    """A draft slot step at ``g`` tokens a slot, over the draft pool."""

    def body(self, engine: "Engine") -> None:
        engine._draft_body(self)   # type: ignore[attr-defined]


class SpeculativeEngine(Engine):
    """A serving :class:`Engine` whose decode phase drafts-and-verifies.

    Example::

        eng = SpeculativeEngine(
            cfg, model, draft_cfg, draft_model,
            gamma=3, num_slots=4, max_len=64, prefill_chunk=8,
            device="cpu",
        )
        rid = eng.submit(prompt, max_new_tokens=32)
        eng.run()                    # greedy == a plain Engine's output

    ``gamma`` proposals per round need a verify chunk of ``gamma + 1``
    tokens, so ``gamma + 1`` must fit the largest prefill bucket.
    Greedy only (``temperature > 0`` is refused: the sampled acceptance
    rule lives in ``models.generation.speculative_generate``).  The draft
    model lies on the engine's device.
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        model: Sequence[Any],
        draft_cfg: TransformerConfig,
        draft_model: Sequence[Any],
        *,
        gamma: int = 3,
        **engine_kwargs: Any,
    ) -> None:
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if float(engine_kwargs.get("temperature", 0.0)) != 0.0:
            raise ValueError(
                "SpeculativeEngine is greedy-only: acceptance compares "
                "argmax tokens, which preserves the target distribution "
                "only at temperature=0 — use the plain Engine (or "
                "models.generation.speculative_generate, which "
                "implements the sampled acceptance rule) for sampling"
            )
        if engine_kwargs.get("role", "unified") != "unified":
            raise ValueError(
                "SpeculativeEngine is unified-only: a speculative round "
                "interleaves draft decode with a verify pass through "
                "the prefill program, so neither phase-role's reduced "
                "program set can host it — disaggregate at the fleet "
                "level with plain prefill/decode engines instead"
            )
        if engine_kwargs.get("prefix_cache") is not None:
            raise ValueError(
                "prefix_cache + speculative decoding in ONE engine is "
                "unsupported: prefix reuse copies TARGET KV rows only, "
                "leaving the draft cache cold (an unbounded catch-up "
                "lag) — compose at the fleet level instead (router over "
                "a prefix-cached replica and a speculative replica)"
            )
        self.gamma = int(gamma)
        self.draft_cfg = draft_cfg
        self._draft_params = _split_params(draft_cfg, draft_model)
        super().__init__(cfg, model, **engine_kwargs)
        _model_device(draft_model, self.device)
        if self.gamma + 1 > self.prefill_buckets[-1]:
            raise ValueError(
                f"gamma={self.gamma} needs a verify chunk of "
                f"{self.gamma + 1} tokens, but the largest prefill "
                f"bucket is {self.prefill_buckets[-1]} — the verify "
                "pass reuses the prefill program, so raise "
                "prefill_chunk or lower gamma"
            )
        _check_decodable(draft_cfg, self.pool.max_len)
        S, dev = self.pool.num_slots, self.device
        cuda = dev.type == "cuda"
        self.draft_pool = CachePool(draft_cfg, S, self.pool.max_len, device=dev)
        # The draft frontier: a device buffer the draft programs read and
        # advance, its host mirror (draft_pool.lengths) and the shadow of
        # what the buffer holds, as the engine keeps its own.
        with torch.inference_mode():
            self._draft_lengths = torch.zeros(S, dtype=torch.int64, device=dev)
        self._draft_shadow: Optional[np.ndarray] = None
        self._draft_len_host = torch.zeros(S, dtype=torch.int64, pin_memory=cuda)
        self._draft_len_copied = torch.cuda.Event() if cuda else None
        # Draft bucket set: the prefill ladder (prompt mirroring) plus
        # g=1 (the proposal step); catch-up lags map into this set.
        self.draft_buckets: Tuple[int, ...] = tuple(
            sorted(set(self.prefill_buckets) | {1})
        )
        self._verify_bucket = self.scheduler.bucket_for(self.gamma + 1)
        self._draft_names = {g: f"draft@{g}" for g in self.draft_buckets}
        with torch.inference_mode():
            for g, name in self._draft_names.items():
                self._programs[name] = _DraftProgram(name, g, False, S, dev)
                self.trace_counts[name] = 0
        reg = self.metrics.registry
        self._c_rounds = reg.counter(
            "serving_spec_rounds", help="speculative verify rounds")
        self._c_proposed = reg.counter(
            "serving_spec_proposed", help="draft tokens proposed")
        self._c_accepted = reg.counter(
            "serving_spec_accepted", help="draft tokens accepted")

    # ------------------------------------------------------------------ #
    # draft programs                                                     #
    # ------------------------------------------------------------------ #

    @property
    def program_count(self) -> int:
        """Target programs (the base engine's bound, verify included at
        zero extra) plus the fixed draft set."""
        return super().program_count + len(self.draft_buckets)

    def step_input_specs(self) -> Dict[str, Any]:
        specs = super().step_input_specs()
        S = self.pool.num_slots
        c = self.draft_pool.cache
        draft_cache = {
            "k": [TensorSpec(tuple(t.shape), t.dtype) for t in c.k],
            "v": [TensorSpec(tuple(t.shape), t.dtype) for t in c.v],
        }
        for g, name in self._draft_names.items():
            specs[name] = {
                "cache": draft_cache,
                "lengths": TensorSpec((S,), torch.int64),
                "n_valid": TensorSpec((S,), torch.int64),
                "tokens": TensorSpec((S, g), torch.int64),
            }
        return specs

    @property
    def acceptance_rate(self) -> float:
        proposed = self._c_proposed.value()
        return self._c_accepted.value() / proposed if proposed else 0.0

    def _draft_body(self, prog: _Program) -> None:
        """The draft slot step: greedy token at each row's last valid
        position, the draft frontier advanced in place."""
        S, g = prog.tokens.shape
        logits, _, new_len = _decode_slots(
            self.draft_cfg, self._draft_params, prog.tokens,
            self.draft_pool.cache, self._draft_lengths, prog.n_valid,
        )
        last = (prog.n_valid - 1).clamp(0, g - 1)
        rows = logits.gather(
            1, last.view(S, 1, 1).expand(S, 1, logits.shape[-1]))[:, 0]
        prog.tok.copy_(rows.argmax(-1))
        self._draft_lengths.copy_(new_len)

    def _upload_draft_lengths(self) -> None:
        """The draft twin of the engine's ``_upload_lengths``."""
        if self._draft_shadow is not None and np.array_equal(
            self.draft_pool.lengths, self._draft_shadow
        ):
            return
        if self._draft_len_copied is not None:
            self._draft_len_copied.synchronize()
            self.draft_pool.lengths_device(self._draft_lengths, self._draft_len_host)
            self._draft_len_copied.record()
        else:
            self.draft_pool.lengths_device(self._draft_lengths)
        self._draft_shadow = self.draft_pool.lengths.copy()

    def _run_draft(self, g: int, tokens: np.ndarray,
                   n_valid: np.ndarray) -> np.ndarray:
        """One draft step at bucket ``g``; mirrors the frontier advance
        on the host and returns the per-slot greedy tokens (host)."""
        prog = self._programs[self._draft_names[g]]

        def attempt() -> None:
            try:
                self._build(prog)
                self._upload_draft_lengths()
                prog.load(tokens, n_valid)
                prog.run(self)
            except Exception:
                self._draft_shadow = None     # a retry re-uploads
                raise

        self._dispatch(attempt)
        self.draft_pool.lengths += n_valid
        self._draft_shadow = self._draft_shadow + n_valid
        return prog.tok.cpu().numpy()

    def _on_admit(self, req: Any) -> None:
        """A recycled slot's draft frontier resets with its target one
        (stale draft rows are dead by masking once it is zeroed)."""
        super()._on_admit(req)
        self.draft_pool.lengths[req.slot] = 0

    def _after_prefill_dispatch(
        self, g: int, tokens: np.ndarray, n_valid: np.ndarray
    ) -> None:
        """Mirror the prompt chunk into the draft cache (same bucket,
        same tokens): draft frontiers track target frontiers through
        prefill."""
        self._run_draft(g, tokens, n_valid)

    # ------------------------------------------------------------------ #
    # the speculative decode round                                       #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _stream_window(r: Any, start: int, n: int) -> np.ndarray:
        """Tokens ``[start, start + n)`` of the request's prompt+generated
        stream, without materializing the whole concatenation."""
        prompt = np.asarray(r.prompt, np.int32)
        parts: List[np.ndarray] = []
        if start < prompt.size:
            parts.append(prompt[start:start + n])
            n -= parts[-1].size
            start = 0
        else:
            start -= prompt.size
        if n > 0:
            parts.append(np.asarray(r.generated[start:start + n], np.int32))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _run_decode(self) -> None:
        reqs = self.scheduler.decode_ready()
        S = self.pool.num_slots
        gamma = self.gamma
        t_round = self._rec_clock()

        # Phase A1 — draft catch-up: feed each row the accepted tokens
        # the draft has not consumed yet, INCLUDING the current last
        # emitted token; the chunk's last-position argmax is proposal 1.
        lags = np.zeros((S,), np.int32)
        for r in reqs:
            lags[r.slot] = (int(self.pool.lengths[r.slot]) + 1
                            - int(self.draft_pool.lengths[r.slot]))
        g_c = self.scheduler.bucket_for(int(lags.max()))
        cu_tokens = np.zeros((S, g_c), np.int32)
        cu_valid = np.zeros((S,), np.int32)
        for r in reqs:
            s, lag = r.slot, int(lags[r.slot])
            cu_tokens[s, :lag] = self._stream_window(
                r, int(self.draft_pool.lengths[s]), lag)
            cu_valid[s] = lag
        proposals = np.zeros((S, gamma), np.int32)
        proposals[:, 0] = self._run_draft(g_c, cu_tokens, cu_valid)

        # Phase A2 — remaining proposals, one g=1 draft step each.
        one_valid = np.zeros((S,), np.int32)
        for r in reqs:
            one_valid[r.slot] = 1
        for k in range(1, gamma):
            proposals[:, k] = self._run_draft(
                1, proposals[:, k - 1:k].copy(), one_valid)

        # Phase B — ONE chunked target step over [cur_tok, proposals]
        # through the EXISTING prefill program at the covering bucket;
        # its per-position greedy grid is the acceptance oracle.
        name = self._prefill_names[self._verify_bucket]
        v_tokens = self._token_buffer(name)
        v_valid = np.zeros((S,), np.int32)
        for r in reqs:
            s = r.slot
            v_tokens[s, 0] = self._cur_tok[s]
            v_tokens[s, 1:gamma + 1] = proposals[s]
            v_valid[s] = gamma + 1
        self._run_program(name, v_tokens, v_valid)
        grid_host = self._programs[name].grid.cpu().numpy()
        # The step advanced every row's device frontier by gamma+1;
        # acceptance is PER ROW, so the host mirror is authoritative and
        # the device vector re-uploads next step.
        self._lengths_shadow = None
        self.metrics.step("decode", len(reqs), S)
        self._c_rounds.inc()
        self._c_proposed.inc(gamma * len(reqs))

        # Phase C — greedy acceptance + rollback, host-side; the draft
        # frontier re-uploads at the next round's catch-up.
        self._draft_shadow = None
        for r in reqs:
            s = r.slot
            target = grid_host[s, :gamma + 1]
            n = 0
            while n < gamma and proposals[s, n] == target[n]:
                n += 1
            emitted = [int(t) for t in proposals[s, :n]] + [int(target[n])]
            self._c_accepted.inc(n)
            if self.recorder is not None:
                self._rec(
                    "req_spec_round", r.rid,
                    dur=max(self._rec_clock() - t_round, 0.0),
                    detail=f"proposed={gamma} accepted={n}",
                )
            # Frontiers BEFORE emission (emission may free the slot):
            # target keeps [.., cur_tok, d1..dn]; the draft consumed
            # d1..d_{gamma-1}, so its valid run is d1..dn capped there.
            t_len = int(self.pool.lengths[s])
            self.pool.lengths[s] = t_len + 1 + n
            self.draft_pool.lengths[s] = t_len + 1 + min(n, gamma - 1)
            for tok in emitted:
                if r.status != "active":
                    break       # budget/eos hit mid-round: drop the rest
                self._emit(r, tok)


__all__ = ["SpeculativeEngine"]
