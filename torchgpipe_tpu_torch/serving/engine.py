"""The serving loop: a statically bounded program set, arbitrary churn.

Counterpart of ``torchgpipe_tpu/serving/engine.py`` (``Engine``,
``:84``).  After warm-up the engine runs a STATICALLY BOUNDED set of
programs — exactly two with a single ``prefill_chunk``,
``len(ladder) + 1`` with a prefill bucket ladder
(``prefill_chunk=(8, 64, 256)``):

* **prefill** — the slot step
  (:func:`~torchgpipe_tpu_torch.models.generation._decode_slots`) at
  ``g = prefill_chunk`` tokens a slot (one program per ladder bucket;
  each step runs the smallest bucket covering its largest pending
  chunk): every slot's pending prompt chunk teacher-forced at its own
  frontier, masked rows no-ops; rows finishing their prompt sample their
  FIRST token from the chunk's last valid position;
* **decode** — the slot step at ``g = 1``: one token per occupied slot,
  each at its own position.

Request arrival, completion, cancellation and drain change only the
VALUES of the programs' buffers (tokens, ``n_valid``, lengths, the cache
pool), never a shape.  The reference jits each program once; here, on a
CUDA device, each program is a CUDA graph captured once, on its first
use, and replayed under any churn:

* it reads static buffers — tokens ``[S, g]`` and ``n_valid [S]`` (one
  int64 buffer per program), the lengths ``[S]``, the pool's cache and
  the model's parameters — and writes static outputs: the sampled token
  per slot, the per-position argmax grid ``[S, g]`` of a prefill, and
  the advanced lengths, in place;
* before capture it runs once on a side stream as a no-op step (every
  ``n_valid`` 0, so no cache byte and no frontier changes, and a
  sampling generator is restored), as the PyTorch documentation
  prescribes; the capture is in ``capture_error_mode="global"``, so any
  host synchronisation in the body raises instead of being captured;
* all of an engine's graphs share one memory pool (they never run at
  the same time, and what a step reads back lives outside the pool);
* a step makes ONE host-to-device copy (its tokens and ``n_valid``,
  from a pinned buffer, ``non_blocking``) and at most one device-to-host
  fetch of the ``[S]`` sampled tokens (pinned, ``non_blocking``, then an
  event); the lengths buffer is re-uploaded only when the host mirror
  differs from its shadow (admission, eviction, drain), as the
  reference's ``_lengths_for_step``/``_commit_lengths`` re-upload.

:attr:`Engine.compile_stats` counts captures: after any churn it is the
reference's trace count, ``{'prefill': 1, 'decode': 1}`` or one entry per
``prefill@g`` plus ``decode``.  A capture failure, or an error in a
replay, raises; no path runs the eager body in place of a graph on the
card.  On the CPU the same bodies run eagerly (the device the caller
asked for), and ``compile_stats`` counts each program's first run.

The slot step reads the cache densely (``flash_decode_reference`` with a
``[S]`` frontier), as the reference's does (its decode kernel takes one
scalar position): no hand-written kernel runs on this path.

Resilience: every step retries transient failures under
:func:`~torchgpipe_tpu_torch.resilience.guard.classify_error` (bounded
backoff, :class:`~torchgpipe_tpu_torch.resilience.guard.GuardPolicy`); a
:class:`~torchgpipe_tpu_torch.resilience.preemption.PreemptionHandler`
triggers a cooperative drain between iterations — unfinished requests
snapshot (prompt + tokens emitted so far) through a
:class:`~torchgpipe_tpu_torch.resilience.checkpoint.CheckpointManager`,
and :meth:`Engine.restore_requests` resubmits them, each stream
continuing exactly where it stopped (greedy decode is
prefix-deterministic).  The snapshot format is the reference's, so a
drain written by either package restores in the other.

A MoE model serves with ``moe=MoEConfig(...)`` (token-choice routing;
``expert_choice`` is refused, as the reference refuses it): the slot step
runs the routed experts in inference mode, and a ``'dropless'`` config's
grouped products take device offsets, so its programs capture as the
dense model's do.  A model from ``models.quant.quantize_params_int8``
serves as any other: its graphs dequantize the int8 weights each step.

The fleet layer (:mod:`torchgpipe_tpu_torch.fleet`) adds three more
fixed-shape programs, each captured once like the slot steps:

* ``prefix_copy`` (with ``prefix_cache=`` a
  :class:`~torchgpipe_tpu_torch.fleet.prefix_cache.RadixPrefixCache`):
  rows ``[0, n)`` of slot ``src`` copied into slot ``dst`` in every
  layer's K, V (and int8 scales), ``src``/``dst``/``n`` read from a
  device tensor (``index_select``/``index_copy_`` under a row mask), so
  one graph serves every reuse;
* ``migrate_ingest`` (``role="decode"``): the same masked write of a
  migrated request's shipped rows, copied first into the program's
  static row buffers (one slot's worth), into slot ``dst``;
* a ``role="prefill"`` engine runs only the prefill ladder and parks
  each request at prompt completion for
  :func:`~torchgpipe_tpu_torch.fleet.migration.migrate`; a
  ``role="decode"`` engine runs exactly ``decode`` + ``migrate_ingest``.

``recorder=`` (an :class:`~torchgpipe_tpu_torch.obs.flightrec.
FlightRecorder`) threads the reference's per-request events through the
loop — ``req_submit``, ``req_admit``, ``req_prefix_copy``, one
``req_prefill`` per chunk, ``req_decode`` coalesced per group,
``req_finish``, ``req_preempt``, ``req_handoff``/``req_ingest`` — each
keyed by ``rid`` (:func:`~torchgpipe_tpu_torch.obs.reqtrace.
stitch_request` rebuilds the span tree).  Recording is host-side only,
on the recorder's own clock: it never touches a program's buffers and
costs one ``if`` per site without a recorder.  A span's ``dur`` is host
time: a decode group ends after the step's one token fetch, so it spans
device time; a prefill chunk's is its launch (and fetch, when a prompt
completes).  ``reporter=`` (an :class:`~torchgpipe_tpu_torch.obs.
StepReporter`) ticks once per engine iteration.

Replicas may share one model's parameters: the engine reads them in
place (``_split_params`` copies nothing) and keeps its own pool,
programs and graph memory pool.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torchgpipe_tpu_torch import graphs
from torchgpipe_tpu_torch.models.generation import (
    QuantKVCache,
    _check_decodable,
    _decode_slots,
    _model_device,
    _mlp_layer_for,
    _sample,
    _split_params,
)
from torchgpipe_tpu_torch.models.transformer import Device, TransformerConfig
from torchgpipe_tpu_torch.resilience.guard import GuardPolicy, classify_error
from torchgpipe_tpu_torch.serving.cache_pool import CachePool
from torchgpipe_tpu_torch.serving.metrics import ServingMetrics
from torchgpipe_tpu_torch.serving.qos import TIER_PRIORITY, check_tier
from torchgpipe_tpu_torch.serving.scheduler import (
    Request,
    Scheduler,
    normalize_buckets,
)


def _flat(p: Dict[str, Any], prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """A layer's param dict as sorted ``(path, tensor)`` pairs, nested
    dicts (LoRA adapters, a MoE block's ``"mlp"``, an int8 weight's
    ``{"q8", "sc"}``) flattened to ``a.b`` paths."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k, v in sorted(p.items()):
        if isinstance(v, dict):
            out += _flat(v, f"{prefix}{k}.")
        else:
            out.append((prefix + k, v))
    return out


class TensorSpec(NamedTuple):
    """The (shape, dtype) of one program input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class _ParamLayer:
    """A layer-like view of one parameter dict (``params()`` returns it):
    what :func:`~torchgpipe_tpu_torch.models.generation._split_params`
    reads, so an engine's own parameters pass where a model does."""

    def __init__(self, params: Dict[str, Any]) -> None:
        self._params = params

    def params(self) -> Dict[str, Any]:
        return self._params


class _Program:
    """One engine program: the slot step at ``g`` tokens a slot, over
    static buffers.  ``inp`` holds the tokens ``[S, g]`` then ``n_valid
    [S]`` (int64), loaded from ``host`` (pinned on the card) by one copy;
    ``tok`` (and, for a prefill, ``grid``) are its outputs.  ``graph`` is
    its CUDA graph once captured."""

    def __init__(self, name: str, g: int, prefill: bool, num_slots: int,
                 device: torch.device) -> None:
        S = num_slots
        self.name, self.g, self.prefill = name, g, prefill
        cuda = device.type == "cuda"
        self.inp = torch.zeros(S * g + S, dtype=torch.int64, device=device)
        self.tokens = self.inp[:S * g].view(S, g)
        self.n_valid = self.inp[S * g:]
        self.host = torch.zeros(S * g + S, dtype=torch.int64, pin_memory=cuda)
        # Recorded after each upload: the host buffer is written again
        # only once the copy out of it has run.
        self.copied = torch.cuda.Event() if cuda else None
        self.tok = torch.zeros(S, dtype=torch.int64, device=device)
        self.grid = (torch.zeros((S, g), dtype=torch.int64, device=device)
                     if prefill else None)
        self.graph: Optional[Any] = None
        self.built = False

    def load(self, tokens: np.ndarray, n_valid: np.ndarray) -> None:
        """The step's one host-to-device copy."""
        if self.copied is not None:
            self.copied.synchronize()
        h = self.host.numpy()
        h[:tokens.size] = tokens.reshape(-1)
        h[tokens.size:] = n_valid
        self.inp.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()

    def body(self, engine: "Engine") -> None:
        engine._body(self)

    def run(self, engine: "Engine") -> None:
        """Replay the graph, or run the body eagerly."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body(engine)


class _RowsProgram(_Program):
    """A row-copy program (``prefix_copy``, ``migrate_ingest``): ``inp``
    holds ``src``, ``dst`` and ``n`` (int64), loaded from ``host`` by one
    copy; ``rows`` (``migrate_ingest`` only) are the static buffers of one
    slot's shipped rows, the tree :meth:`Engine.kv_row_specs` describes."""

    def __init__(self, name: str, device: torch.device,
                 rows: Optional[Dict[str, List[torch.Tensor]]] = None) -> None:
        cuda = device.type == "cuda"
        self.name, self.g, self.prefill = name, 0, False
        self.inp = torch.zeros(3, dtype=torch.int64, device=device)
        self.src, self.dst, self.n = self.inp[0:1], self.inp[1:2], self.inp[2:3]
        self.host = torch.zeros(3, dtype=torch.int64, pin_memory=cuda)
        self.copied = torch.cuda.Event() if cuda else None
        self.rows = rows
        self.graph: Optional[Any] = None
        self.built = False

    def load(self, src: int, dst: int, n: int) -> None:  # type: ignore[override]
        if self.copied is not None:
            self.copied.synchronize()
        self.host.numpy()[:] = (src, dst, n)
        self.inp.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()

    def body(self, engine: "Engine") -> None:
        engine._rows_body(self)


class Engine:
    """Continuous-batching inference engine over a slot-pooled KV cache.

    Example::

        model = llama(cfg, device="cpu")          # or on the card
        eng = Engine(cfg, model, num_slots=4, max_len=64, device="cpu")
        rid = eng.submit(prompt_tokens, max_new_tokens=16, eos_id=2)
        eng.run()                       # or step() under your own loop
        tokens = eng.result(rid)        # np.int32 [n]

    ``model`` is the port's ``llama(cfg)`` (or any sequence of its
    layers) on ``device`` (``cuda`` unless named).  The engine serves
    that model's parameters in place: :meth:`swap_params` writes new
    weights into them.

    ``hbm_budget_bytes`` turns on admission control: the slot cap is
    :func:`~torchgpipe_tpu_torch.tune.serving_max_slots` of the pool
    (after the resident parameter bytes and ``overhead_bytes``), and the
    POOL ITSELF is clamped to it before allocation.  The port's steps
    update the pool in place, so no step holds two copies of it: the cap
    counts one copy (the reference's ``donated=True`` cap), whatever
    ``donate`` says.  ``donate`` keeps only its retry meaning: with
    ``donate=True`` a failed step is never retried.

    ``temperature=0`` (default) is greedy, the mode whose streams equal
    the reference engine's token for token.  Sampling takes
    ``generator`` (a ``torch.Generator`` on ``device``) and applies
    ``generate``'s temperature/top-k/top-p filter chain, batched over
    slots; a captured program advances the generator on every replay as
    the eager body would.

    ``cuda_graph=False`` runs every program's body eagerly on the card
    as well: the comparison the graphs are held to (equal tokens and
    cache bytes), and a way to debug a body.
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        model: Sequence[Any],
        *,
        num_slots: int,
        max_len: int,
        prefill_chunk: Any = 8,
        kv_quant: bool = False,
        cache_dtype: Optional[torch.dtype] = None,
        moe: Optional[Any] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefix_cache: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
        hbm_budget_bytes: Optional[int] = None,
        overhead_bytes: int = 0,
        wave_admission: bool = False,
        metrics: Optional[ServingMetrics] = None,
        registry: Optional[Any] = None,
        reporter: Optional[Any] = None,
        recorder: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
        preemption: Optional[Any] = None,
        checkpoint_manager: Optional[Any] = None,
        guard_policy: Optional[GuardPolicy] = None,
        sleep: Callable[[float], None] = time.sleep,
        donate: bool = False,
        role: str = "unified",
        qos: Optional[Any] = None,
        cuda_graph: bool = True,
        device: Device = None,
    ) -> None:
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be 'unified' | 'prefill' | 'decode', got {role!r}"
            )
        if role == "decode" and prefix_cache is not None:
            raise ValueError(
                "a decode-role engine never prefills, so a prefix cache "
                "would never be consulted — attach it to the prefill "
                "pool, whose completed prompts become the donors"
            )
        if moe is not None and getattr(moe, "router", "topk") == "expert_choice":
            raise ValueError(
                "expert_choice routing selects the top-C tokens PER "
                "EXPERT across the batch — at decode time the batch is "
                "one token per slot, so the experts compete over "
                "UNRELATED streams and a slot's token can be chosen by "
                "no expert (it silently emits the zero vector, "
                "corrupting that stream); serve MoE models with "
                "token-choice routing (router='topk'), which routes "
                "every token independently of its batch neighbours"
            )
        self.moe = moe
        self._mlp = _mlp_layer_for(moe)
        self.cfg = cfg
        self.device = _model_device(model, device)
        self._params = _split_params(cfg, model)   # validates the layer list
        self.version = 0
        _check_decodable(cfg, max_len)
        self.prefill_buckets = normalize_buckets(prefill_chunk)
        self.prefill_chunk = self.prefill_buckets[-1]
        self.role = role
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        if self.temperature > 0.0:
            if generator is None:
                raise ValueError(
                    "temperature sampling needs generator=torch.Generator"
                )
            if generator.device.type != self.device.type:
                raise ValueError(
                    f"the generator lies on {generator.device}, the engine "
                    f"runs on {self.device}"
                )
        self._generator = generator
        self.donate = donate
        self.cuda_graph = cuda_graph
        max_active: Optional[int] = None
        if hbm_budget_bytes is not None:
            from torchgpipe_tpu_torch.tune import serving_max_slots, tree_bytes

            max_active = serving_max_slots(
                cfg, max_len, hbm_budget_bytes,
                kv_quant=kv_quant, dtype=cache_dtype,
                param_bytes=tree_bytes(self._params),
                overhead_bytes=overhead_bytes,
            )
            if max_active < 1:
                raise ValueError(
                    "admission cap is 0 slots: the cache pool does not "
                    "fit the HBM budget — shrink max_len/num_slots or "
                    "raise the budget (tune.serving_max_slots accounting)"
                )
            # The cap bounds ALLOCATED memory: the pool is clamped to it.
            num_slots = min(num_slots, max_active)
        self.pool = CachePool(
            cfg, num_slots, max_len, kv_quant=kv_quant, dtype=cache_dtype,
            device=self.device,
        )
        # ``qos`` (serving.qos.QosPolicy): tier-ordered admission,
        # per-tenant token budgets, pressure preemption of batch-tier
        # streams.
        self.qos = qos
        self.scheduler = Scheduler(
            self.pool, prefill_chunk=self.prefill_buckets,
            max_active=max_active, wave_admission=wave_admission, qos=qos,
        )
        self.metrics = metrics or ServingMetrics(clock=clock, registry=registry)
        # ``reporter`` (obs.StepReporter) ticks once per engine iteration;
        # ``recorder`` (obs.FlightRecorder) takes the rid-keyed request
        # events.  Both are host-side only.
        self.reporter = reporter
        self.recorder = recorder
        # One ``req_decode`` event per request GROUP of decode steps
        # (flushed at finish/preempt/handoff), not one per token.
        self._decode_groups: Dict[str, List[float]] = {}
        self._prefix_cache = prefix_cache
        # drain hooks: called with the snapshot dict after every drain.
        self.drain_hooks: List[Callable[[Dict[str, Any]], None]] = []
        self.guard_policy = guard_policy or GuardPolicy()
        self._sleep = sleep
        self._preemption = preemption
        self._checkpoint_manager = checkpoint_manager
        self._drain_requested = False
        self._draining = False
        self._last_drain_sid: Optional[int] = None
        if preemption is not None and hasattr(preemption, "add_callback"):
            preemption.add_callback(self.request_drain)
        self._requests: Dict[str, Request] = {}
        # Requests parked at prompt completion on a prefill-role engine:
        # out of the scheduler, still holding their slot (the KV rows
        # are the migration payload, freed by complete_migration).
        self._migration_ready: List[Request] = []
        self._cur_tok = np.zeros((num_slots,), np.int32)
        self._rid_counter = 0

        # Device state the programs share: the frontier buffer and its
        # host twins.  ``_lengths_shadow`` records what ``_lengths`` holds
        # (None: unknown, re-upload); any host-side mutation a step did
        # not mirror (admission, eviction, drain) makes the compare miss
        # and triggers ONE re-upload.
        dev, cuda = self.device, self.device.type == "cuda"
        with torch.inference_mode():
            self._lengths = torch.zeros(num_slots, dtype=torch.int64, device=dev)
            self._programs: Dict[str, _Program] = {}
            self._prefill_names = {} if role == "decode" else {
                g: ("prefill" if len(self.prefill_buckets) == 1 else f"prefill@{g}")
                for g in self.prefill_buckets
            }
            for g, name in self._prefill_names.items():
                self._programs[name] = _Program(name, g, True, num_slots, dev)
            if role != "prefill":
                self._programs["decode"] = _Program("decode", 1, False, num_slots, dev)
            # The row index the copy programs mask with.
            self._row_index = torch.arange(max_len, dtype=torch.int64, device=dev)
            if role == "decode":
                rows = {
                    kind: [torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
                           for spec in specs]
                    for kind, specs in self.kv_row_specs().items()
                }
                self._programs["migrate_ingest"] = _RowsProgram(
                    "migrate_ingest", dev, rows)
            if prefix_cache is not None:
                self._programs["prefix_copy"] = _RowsProgram("prefix_copy", dev)
        self._lengths_shadow: Optional[np.ndarray] = None
        self._len_host = torch.zeros(num_slots, dtype=torch.int64, pin_memory=cuda)
        self._len_copied = torch.cuda.Event() if cuda else None
        self._tok_host = torch.zeros(num_slots, dtype=torch.int64, pin_memory=cuda)
        self._tok_ready = torch.cuda.Event() if cuda else None
        self._tok_src: Optional[torch.Tensor] = None
        self._graph_pool: Optional[Any] = None
        self.trace_counts = {name: 0 for name in self._programs}
        self._token_shapes = {
            name: (num_slots, prog.g) for name, prog in self._programs.items()
            if not isinstance(prog, _RowsProgram)
        }

    # ------------------------------------------------------------------ #
    # programs                                                           #
    # ------------------------------------------------------------------ #

    @property
    def program_count(self) -> int:
        """The statically bounded program count: one prefill program per
        ladder bucket plus the decode program (plus ``prefix_copy`` with
        a prefix cache).  Disaggregation SHRINKS it: a prefill pool drops
        the decode program, a decode pool is exactly ``decode`` +
        ``migrate_ingest``."""
        extra = 1 if self._prefix_cache is not None else 0
        if self.role == "prefill":
            return len(self.prefill_buckets) + extra
        if self.role == "decode":
            return 2
        return len(self.prefill_buckets) + 1 + extra

    @property
    def compile_stats(self) -> Dict[str, int]:
        """Times each program was built: captured into a CUDA graph on
        the card, first run eagerly on the CPU (or with
        ``cuda_graph=False``).  After warm-up, under any churn, it is
        ``{'prefill': 1, 'decode': 1}`` (one ``prefill@g`` per bucket of
        a ladder)."""
        return dict(self.trace_counts)

    def step_input_specs(self) -> Dict[str, Any]:
        """The (shape, dtype) of each program's inputs — request
        independent by construction (the steps' buffers are built from
        these same shapes)."""
        S = self.pool.num_slots

        def specs(ts: List[torch.Tensor]) -> List[TensorSpec]:
            return [TensorSpec(tuple(t.shape), t.dtype) for t in ts]

        c = self.pool.cache
        cache_spec = {"k": specs(c.k), "v": specs(c.v)}
        if isinstance(c, QuantKVCache):
            cache_spec.update(k_scale=specs(c.k_scale), v_scale=specs(c.v_scale))
        common = {
            "cache": cache_spec,
            "lengths": TensorSpec((S,), torch.int64),
            "n_valid": TensorSpec((S,), torch.int64),
        }
        specs: Dict[str, Any] = {
            kind: dict(common, tokens=TensorSpec(shape, torch.int64))
            for kind, shape in self._token_shapes.items()
        }
        scalar = TensorSpec((1,), torch.int64)
        if "prefix_copy" in self._programs:
            specs["prefix_copy"] = {"cache": cache_spec, "src": scalar,
                                    "dst": scalar, "n": scalar}
        if "migrate_ingest" in self._programs:
            specs["migrate_ingest"] = {"cache": cache_spec,
                                       "rows": self.kv_row_specs(),
                                       "dst": scalar, "n": scalar}
        return specs

    def kv_row_specs(self) -> Dict[str, Any]:
        """The (shape, dtype) of ONE slot's migration payload: per-layer
        KV rows (+ int8 scale rows) with the slot axis sliced away —
        what :meth:`export_kv_rows` produces and ``migrate_ingest``
        consumes (:func:`~torchgpipe_tpu_torch.fleet.migration.
        validate_pools` compares them across pools)."""
        c = self.pool.cache
        rows: Dict[str, Any] = {
            "k": [TensorSpec(tuple(b.shape[1:]), b.dtype) for b in c.k],
            "v": [TensorSpec(tuple(b.shape[1:]), b.dtype) for b in c.v],
        }
        if isinstance(c, QuantKVCache):
            rows["k_scale"] = [TensorSpec(tuple(b.shape[1:]), b.dtype) for b in c.k_scale]
            rows["v_scale"] = [TensorSpec(tuple(b.shape[1:]), b.dtype) for b in c.v_scale]
        return rows

    def serving_layers(self) -> List[_ParamLayer]:
        """The engine's own parameters as a layer list (embed, blocks,
        head) that :meth:`swap_params` and ``analysis.serving.
        certify_swap`` accept in place of a model."""
        embed_p, block_p, head_p = self._params
        return [_ParamLayer(p) for p in [embed_p, *block_p, head_p]]

    def weights_key(self) -> Tuple[str, int]:
        """Where the served weights live (the embedding table's device
        and address): engines with equal keys share parameter tensors,
        so a swap into one is seen by all."""
        t = _flat(self._params[0])[0][1]
        return str(t.device), t.data_ptr()

    def _token_buffer(self, kind: str) -> np.ndarray:
        return np.zeros(self._token_shapes[kind], np.int32)

    def _body(self, prog: _Program) -> None:
        """One program's step over the static buffers: the slot step,
        the sampled token per slot (of a prefill: at each row's last
        valid position), a prefill's per-position argmax grid, and the
        lengths advanced in place (the last write, after every read)."""
        S, g = prog.tokens.shape
        logits, _, new_len = _decode_slots(
            self.cfg, self._params, prog.tokens, self.pool.cache,
            self._lengths, prog.n_valid, self._mlp,
        )
        if prog.prefill:
            last = (prog.n_valid - 1).clamp(0, g - 1)
            rows = logits.gather(
                1, last.view(S, 1, 1).expand(S, 1, logits.shape[-1]))[:, 0]
            # Per-POSITION greedy tokens [S, g]: what the model would emit
            # after each input position (a speculative verify pass reads
            # it; chunked prefill does not).
            prog.grid.copy_(logits.argmax(-1))
        else:
            rows = logits[:, 0]
        prog.tok.copy_(_sample(rows, self._generator, self.temperature,
                               self.top_k, self.top_p))
        self._lengths.copy_(new_len)

    def _rows_body(self, prog: _RowsProgram) -> None:
        """A row-copy program's body: in every layer's K and V bank (and
        int8 scale bank), slot ``dst`` takes rows ``[0, n)`` of slot
        ``src`` (``prefix_copy``) or of the static shipped rows
        (``migrate_ingest``) and keeps its own above ``n``.  Indices are
        read from device tensors; nothing syncs with the host."""
        keep = self._row_index < prog.n            # [L] rows to write

        def put(bank: torch.Tensor, rows: Optional[torch.Tensor], axis: int) -> None:
            # ``axis``: the bank's length axis (1 for K/V, 2 for scales).
            cur = bank.index_select(0, prog.dst)
            new = (rows.unsqueeze(0) if rows is not None
                   else bank.index_select(0, prog.src))
            shape = [1] * bank.dim()
            shape[axis] = bank.shape[axis]
            bank.index_copy_(0, prog.dst, torch.where(keep.view(shape), new, cur))

        c = self.pool.cache
        banks = [("k", c.k, 1), ("v", c.v, 1)]
        if isinstance(c, QuantKVCache):
            banks += [("k_scale", c.k_scale, 2), ("v_scale", c.v_scale, 2)]
        for kind, layers, axis in banks:
            for i, bank in enumerate(layers):
                put(bank, None if prog.rows is None else prog.rows[kind][i], axis)

    def _build(self, prog: _Program) -> None:
        """Capture ``prog`` into a CUDA graph (on the card, unless
        ``cuda_graph=False``), counted in :attr:`compile_stats`.  Without
        a graph the body runs eagerly and its first run is the build."""
        if prog.built:
            return
        if self.device.type != "cuda" or not self.cuda_graph:
            prog.built = True
            self.trace_counts[prog.name] += 1
            return
        gen = self._generator if self.temperature > 0.0 else None
        gen_state = gen.get_state() if gen is not None else None
        prog.inp.zero_()        # n_valid / n 0 everywhere: a no-op warm-up step
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        prog.graph, _ = graphs.capture(
            lambda: prog.body(self), self.device, self._graph_pool,
            warmup=lambda: prog.body(self), generator=gen)
        if gen is not None:
            gen.set_state(gen_state)
        prog.built = True
        self.trace_counts[prog.name] += 1

    def _upload_lengths(self) -> None:
        """Re-upload the host frontier mirror when it differs from what
        the device buffer holds (``_lengths_shadow``).  Steady decode —
        no admissions, no evictions — uploads nothing: each program
        advances the device buffer itself."""
        if self._lengths_shadow is not None and np.array_equal(
            self.pool.lengths, self._lengths_shadow
        ):
            return
        if self._len_copied is not None:
            self._len_copied.synchronize()
            self.pool.lengths_device(self._lengths, self._len_host)
            self._len_copied.record()
        else:
            self.pool.lengths_device(self._lengths)
        self._lengths_shadow = self.pool.lengths.copy()

    def _run_program(self, name: str, tokens: np.ndarray,
                     n_valid: np.ndarray) -> None:
        """One step of program ``name`` under the retry policy, then the
        start of the device-to-host copy of its sampled tokens (the step's
        bookkeeping runs while it is in flight; :meth:`_fetch_tokens`
        waits for it)."""
        prog = self._programs[name]

        def attempt() -> None:
            self._build(prog)
            self._upload_lengths()
            prog.load(tokens, n_valid)
            prog.run(self)
            if self._tok_ready is not None:
                self._tok_host.copy_(prog.tok, non_blocking=True)
                self._tok_ready.record()
            self._tok_src = prog.tok

        self._dispatch(attempt)
        self._lengths_shadow = self._lengths_shadow + n_valid

    def _run_rows(self, name: str, src: int, dst: int, n: int,
                  rows: Optional[Dict[str, Any]] = None) -> None:
        """One row-copy program (``prefix_copy``/``migrate_ingest``)
        under the retry policy; ``rows`` (the ingest's shipped rows) are
        first copied into the program's static row buffers."""
        prog = self._programs[name]

        def attempt() -> None:
            self._build(prog)
            if rows is not None:
                for kind, bufs in prog.rows.items():
                    for buf, src_rows in zip(bufs, rows[kind]):
                        buf.copy_(src_rows, non_blocking=True)
            prog.load(src, dst, n)
            prog.run(self)

        self._dispatch(attempt)

    def _fetch_tokens(self) -> np.ndarray:
        """The last step's sampled tokens on the host: the ONE fetch of a
        step."""
        if self._tok_ready is not None:
            self._tok_ready.synchronize()
            return self._tok_host.numpy()
        return self._tok_src.numpy()

    def _dispatch(self, fn: Callable[[], None]) -> None:
        """Run a step under the transient-retry policy.  A port step
        writes the cache only at ``lengths + j`` and advances the device
        lengths last; a retry re-uploads the host mirror (which a failed
        step never advanced), so it rewrites the same values.  With
        ``donate=True`` transient errors re-raise immediately, as in the
        reference."""
        attempt = 0
        while True:
            try:
                with torch.inference_mode():
                    fn()
                return
            except Exception as err:  # noqa: BLE001 — classified below
                if (
                    self.donate
                    or classify_error(err) != "transient"
                    or attempt >= self.guard_policy.max_retries
                ):
                    raise
                delay = self.guard_policy.backoff(attempt)
                attempt += 1
                self.metrics.retries += 1
                self._lengths_shadow = None
                self._sleep(delay)

    # ------------------------------------------------------------------ #
    # live param refresh                                                 #
    # ------------------------------------------------------------------ #

    def swap_params(self, model: Sequence[Any], version: int) -> None:
        """Serve NEW weights with zero rebuild: every parameter of
        ``model`` is copied (``copy_``) into the engine's parameters,
        whose storage the captured graphs read, so nothing is recaptured
        and later steps read the new weights.  A swap that changes any
        parameter's name, shape, dtype or device is REFUSED — cold-start
        a fresh Engine for a re-shaped model.

        Call only on a drained/idle engine: swapping under live decode
        would splice two versions into one stream.  After the swap the
        engine's streams equal what a fresh engine on ``model`` gives.
        The engine's parameters are those of the model it was built on,
        so that model holds the new weights afterwards."""
        new = _split_params(self.cfg, model)    # validates the layer list

        def sig(params: Tuple) -> List[Tuple[str, Tuple[int, ...], torch.dtype, torch.device]]:
            embed_p, block_p, head_p = params
            return [(k, tuple(t.shape), t.dtype, t.device)
                    for p in [embed_p, *block_p, head_p] for k, t in _flat(p)]

        if sig(new) != sig(self._params):
            raise ValueError(
                "swap_params: the published params change a parameter "
                "(name, shape, dtype, device) signature — an in-place swap "
                "would have to recapture every program mid-serve, so it is "
                "refused; cold-start a fresh Engine for a re-shaped model"
            )
        with torch.no_grad():
            for dst_p, src_p in zip([self._params[0], *self._params[1], self._params[2]],
                                    [new[0], *new[1], new[2]]):
                for (_, dst), (_, src) in zip(_flat(dst_p), _flat(src_p)):
                    if src is not dst:
                        dst.copy_(src)
        self.version = int(version)
        if self.recorder is not None:
            self.recorder.record("param_swap", detail=f"version={self.version}")

    # ------------------------------------------------------------------ #
    # request-scoped flight recording                                    #
    # ------------------------------------------------------------------ #

    def _rec(self, kind: str, rid: str, *, dur: Optional[float] = None,
             detail: str = "") -> None:
        """One rid-keyed flight event (no-op without a recorder)."""
        if self.recorder is not None:
            self.recorder.record(kind, rid=rid, dur=dur, detail=detail)

    def _rec_clock(self) -> float:
        """The recorder's clock (0.0 without one: callers use the value
        only when a recorder exists, so durations stay on the clock of
        the recorder's own event stamps)."""
        return self.recorder.clock() if self.recorder is not None else 0.0

    def _flush_decode_group(self, rid: str) -> None:
        """Emit the coalesced decode-step span of ``rid`` (if any): from
        its first step's start to its last step's end, with the step
        count."""
        group = self._decode_groups.pop(rid, None)
        if group is None or self.recorder is None:
            return
        t0, t1, steps = group
        self._rec("req_decode", rid, dur=max(t1 - t0, 0.0),
                  detail=f"steps={int(steps)}")

    # ------------------------------------------------------------------ #
    # request API                                                        #
    # ------------------------------------------------------------------ #

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        rid: Optional[str] = None,
        eos_id: Optional[int] = None,
        on_token: Optional[Callable[[str, int], None]] = None,
        emitted_prefix: Sequence[int] = (),
        tier: str = "standard",
        tenant: Optional[str] = None,
    ) -> str:
        """Queue a request; returns its id.  Admission happens between
        engine iterations (a free slot + the admission cap permitting)."""
        if self.role == "decode":
            raise ValueError(
                "decode-role engine: work arrives via ingest_migration() "
                "from a prefill replica, never submit() — route "
                "admissions to the prefill pool"
            )
        check_tier(tier)     # before any registration (no phantom state)
        if rid is None:
            self._rid_counter += 1
            rid = f"r{self._rid_counter}"
        self._check_rid_free(rid)
        req = Request(
            rid=rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id,
            on_token=on_token,
            emitted_prefix=list(emitted_prefix),
            tier=tier,
            tenant=tenant,
        )
        self.scheduler.submit(req)   # validates before registration
        self._requests[rid] = req
        self.metrics.arrived(rid)
        # Recorded only after validation accepted the request: a
        # rejected submit leaves no phantom span.
        if self.recorder is not None:
            phase = "" if self.role == "unified" else f" phase={self.role}"
            tenant_tag = "" if tenant is None else f" tenant={tenant}"
            self._rec(
                "req_submit", rid,
                detail=(
                    f"prompt={req.prompt_len} new={req.max_new_tokens} "
                    f"queued={self.scheduler.queue_depth}"
                    f" tier={tier}{tenant_tag}"
                    f" version={self.version}{phase}"
                ),
            )
        return rid

    def _check_rid_free(self, rid: str) -> None:
        """A rid may RETURN to an engine that served it before (a drain
        and resume resubmits it) once its prior incarnation is inert; a
        still-live duplicate is an error."""
        old = self._requests.get(rid)
        if old is not None and old.status in ("queued", "active", "migrating", "finished"):
            raise ValueError(f"duplicate request id {rid!r}")

    def cancel(self, rid: str) -> bool:
        ok = self.scheduler.cancel(rid)
        if ok:
            self.metrics.finished(rid, status="cancelled")
            self._flush_decode_group(rid)
            self._rec("req_finish", rid, detail="status=cancelled")
        return ok

    def result(self, rid: str) -> np.ndarray:
        """All tokens request ``rid`` has produced so far (across a
        drain/resume), as ``np.int32 [n]``."""
        return np.asarray(self._requests[rid].tokens(), np.int32)

    def status(self, rid: str) -> str:
        return self._requests[rid].status

    # ------------------------------------------------------------------ #
    # the loop                                                           #
    # ------------------------------------------------------------------ #

    def step(self) -> bool:
        """ONE engine iteration: admit, pick a phase, run its program,
        emit/evict.  Returns False when idle (nothing ran)."""
        if not self._draining:
            if self.qos is not None:
                self._preempt_for_pressure()
            if (
                self._prefix_cache is not None
                and self.scheduler.queue
                and self.pool.num_free == 0
            ):
                # Admission pressure: evict idle prefix entries (their
                # pins are the only remaining references) so queued
                # requests beat cached prefixes to slots.
                self._prefix_cache.reclaim(self.pool, len(self.scheduler.queue))
            for req in self.scheduler.admit():
                self.metrics.admitted(req.rid)
                self._on_admit(req)
        action = self.scheduler.next_action()
        if action is None:
            return False
        if action == "prefill":
            self._run_prefill()
        else:
            self._run_decode()
        if self.reporter is not None:
            self.reporter.step()
        return True

    def _preempt_for_pressure(self) -> None:
        """QoS pressure valve (runs before admission): when queued work
        OUTRANKS an active preemptible stream and admission is blocked,
        evict ONE preemptible active request through the drain snapshot
        path and requeue it — it resumes bitwise once pressure clears.
        Interactive/standard streams are never preempted."""
        sched = self.scheduler
        if not sched.queue:
            return
        if sched.pool.num_free > 0 and len(sched.active) < sched.max_active:
            return      # admission can proceed — nothing to yield
        want = min(
            TIER_PRIORITY[self.qos.effective_tier(r.tier, r.tenant)]
            for r in sched.queue
        )
        victims = [
            r for r in sched.active.values()
            if self.qos.preemptible(r.tier) and TIER_PRIORITY[r.tier] > want
        ]
        if not victims:
            return
        # Most recently admitted among the worst-priority preemptibles:
        # deterministic, and the stream with the least progress to redo.
        worst = max(TIER_PRIORITY[r.tier] for r in victims)
        victim = [r for r in victims if TIER_PRIORITY[r.tier] == worst][-1]
        kwargs = self.preempt_request(victim.rid)
        self.qos.note_preemption()
        self.submit(**kwargs)

    def preempt_request(self, rid: str) -> Dict[str, Any]:
        """Evict one ACTIVE request NOW (its slot frees immediately) and
        return the ``submit()`` kwargs that resume it: prompt extended by
        the tokens already emitted (teacher-forced), budget shrunk,
        ``emitted_prefix`` extended — the drain/restore schema."""
        req = self.scheduler.active.get(rid)
        if req is None:
            raise ValueError(
                f"request {rid!r} is not active — nothing to preempt"
            )
        generated = list(req.generated)
        kwargs: Dict[str, Any] = {
            "rid": req.rid,
            "prompt": np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(generated, np.int32),
            ]) if generated else np.asarray(req.prompt, np.int32),
            "max_new_tokens": req.max_new_tokens - len(generated),
            "eos_id": req.eos_id,
            "on_token": req.on_token,
            "emitted_prefix": list(req.emitted_prefix) + generated,
            "tier": req.tier,
            "tenant": req.tenant,
        }
        req.status = "preempted"
        self.scheduler.release(req)
        self.metrics.finished(rid, status="preempted")
        self._flush_decode_group(rid)
        self._rec("req_preempt", rid,
                  detail=f"qos tier={req.tier} emitted={len(generated)}")
        return kwargs

    def _on_admit(self, req: Request) -> None:
        """Per-admission hook: the prefix-cache consult; subclasses
        extend it (``fleet.SpeculativeEngine`` resets the recycled
        slot's draft frontier)."""
        if self.recorder is not None:
            times = self.metrics.requests.get(req.rid)
            wait = times.queue_wait if times is not None else None
            self._rec("req_admit", req.rid, dur=wait, detail=f"slot={req.slot}")
        if self._prefix_cache is not None:
            self._apply_prefix_reuse(req)

    def _apply_prefix_reuse(self, req: Request) -> None:
        """Admission-time trie consult: when the prompt extends a cached
        prefix, the ``prefix_copy`` program copies the donor slot's rows
        into the request's slot (bitwise what a cold prefill of those
        tokens writes) and the prefix counts as prefilled.  At most
        ``prompt_len - 1`` tokens reuse: the LAST prompt token always
        prefills, producing the first-token logits."""
        m, donor = self._prefix_cache.match(req.prompt, limit=req.prompt_len - 1)
        if m <= 0 or donor is None:
            return
        assert req.slot is not None
        t0 = self._rec_clock()
        self._run_rows("prefix_copy", donor, req.slot, m)
        self.pool.lengths[req.slot] = m      # shadow miss -> re-upload
        req.prefilled = m
        self.metrics.prefix_hit(m)
        self._rec("req_prefix_copy", req.rid,
                  dur=max(self._rec_clock() - t0, 0.0),
                  detail=f"reused={m} donor_slot={donor}")

    def _run_prefill(self) -> None:
        reqs = self.scheduler.prefill_pending()
        # Ladder admission: the smallest bucket covering this step's
        # largest pending chunk.
        g = self.scheduler.prefill_bucket()
        name = self._prefill_names[g]
        tokens = self._token_buffer(name)
        n_valid = np.zeros((self.pool.num_slots,), np.int32)
        takes: List[Tuple[Request, int]] = []
        for r in reqs:
            take = min(g, r.prompt_len - r.prefilled)
            tokens[r.slot, :take] = r.prompt[r.prefilled:r.prefilled + take]
            n_valid[r.slot] = take
            takes.append((r, take))
        t0 = self._rec_clock()
        self._run_program(name, tokens, n_valid)
        # Subclass hook: speculative decoding mirrors every prefill chunk
        # into its draft cache (same bucket, same buffer).
        self._after_prefill_dispatch(g, tokens, n_valid)
        self.metrics.step("prefill", len(reqs), self.pool.num_slots)
        # ONE host fetch per step, when a prompt completes in it.
        tok_host = (self._fetch_tokens()
                    if any(r.prefilled + take >= r.prompt_len for r, take in takes)
                    else None)
        if self.recorder is not None:
            dur = max(self._rec_clock() - t0, 0.0)
            for r, take in takes:
                self._rec("req_prefill", r.rid, dur=dur, detail=f"g={g} take={take}")
        for r, take in takes:
            self.pool.lengths[r.slot] += take
            r.prefilled += take
            if r.prefill_done:
                if self._prefix_cache is not None:
                    # The slot now holds the whole prompt's rows: it
                    # becomes a donor (the insert pins it through the
                    # pool refcounts, so recycling waits for eviction).
                    self._prefix_cache.insert(r.prompt, r.slot, self.pool)
                self._emit(r, int(tok_host[r.slot]))

    def _after_prefill_dispatch(self, g: int, tokens: np.ndarray,
                                n_valid: np.ndarray) -> None:
        """No-op hook; ``fleet.SpeculativeEngine`` overrides it to
        teacher-force the same prompt chunk into the draft cache."""

    def _run_decode(self) -> None:
        reqs = self.scheduler.decode_ready()
        tokens = self._token_buffer("decode")
        n_valid = np.zeros((self.pool.num_slots,), np.int32)
        for r in reqs:
            tokens[r.slot, 0] = self._cur_tok[r.slot]
            n_valid[r.slot] = 1
        t0 = self._rec_clock()
        self._run_program("decode", tokens, n_valid)
        self.metrics.step("decode", len(reqs), self.pool.num_slots)
        tok_host = self._fetch_tokens()        # the ONE host fetch per step
        if self.recorder is not None:
            t1 = self._rec_clock()
            for r in reqs:
                group = self._decode_groups.get(r.rid)
                if group is None:
                    self._decode_groups[r.rid] = [t0, t1, 1.0]
                else:
                    group[1] = t1
                    group[2] += 1.0
        for r in reqs:
            self.pool.lengths[r.slot] += 1
            self._emit(r, int(tok_host[r.slot]))

    def _emit(self, req: Request, token: int) -> None:
        """Stream one token; per-row termination FREES THE SLOT NOW."""
        req.generated.append(token)
        self.metrics.token(req.rid)
        if self.qos is not None:
            self.qos.spend(req.tenant, 1)
        if req.on_token is not None:
            req.on_token(req.rid, token)
        done = (
            (req.eos_id is not None and token == req.eos_id)
            or req.remaining_new <= 0
        )
        if done:
            req.status = "finished"
            self.scheduler.release(req)
            self.metrics.finished(req.rid)
            self._flush_decode_group(req.rid)
            self._rec(
                "req_finish", req.rid,
                detail=(f"status=finished tokens={len(req.tokens())} "
                        f"version={self.version}"),
            )
        elif self.role == "prefill":
            # Prompt complete, stream live: the decode phase belongs to
            # the decode pool.  Park the request OUT of the scheduler with
            # its slot still held (the rows are the migration payload,
            # released by complete_migration once a decode replica has
            # ingested them).  A request finishing on its first token
            # never parks.
            req.status = "migrating"
            self.scheduler.active.pop(req.rid, None)
            self._migration_ready.append(req)
            self._flush_decode_group(req.rid)
        else:
            self._cur_tok[req.slot] = token

    # ------------------------------------------------------------------ #
    # KV migration (disaggregated serving)                               #
    # ------------------------------------------------------------------ #

    @property
    def migration_pending(self) -> bool:
        """Requests parked at prompt completion, awaiting handoff to a
        decode replica (prefill role only)."""
        return bool(self._migration_ready)

    def take_migration_ready(self) -> List[Request]:
        """Pop the parked requests (the router hands each to
        :func:`~torchgpipe_tpu_torch.fleet.migration.migrate`); append
        back to ``_migration_ready`` to re-park one the decode pool
        cannot take yet."""
        out = self._migration_ready
        self._migration_ready = []
        return out

    def export_kv_rows(self, req: Request) -> Dict[str, Any]:
        """One slot's migration payload: per-layer KV rows (+ int8 scale
        rows) with the slot axis sliced away, as views of the pool (no
        copy; :func:`~torchgpipe_tpu_torch.fleet.migration.stage_rows`
        copies them to the host).  Shapes and dtypes are
        :meth:`kv_row_specs`."""
        if req.slot is None:
            raise ValueError(f"request {req.rid!r} holds no slot — nothing to export")
        slot = req.slot
        c = self.pool.cache
        rows: Dict[str, Any] = {
            "k": [b[slot] for b in c.k],
            "v": [b[slot] for b in c.v],
        }
        if isinstance(c, QuantKVCache):
            rows["k_scale"] = [b[slot] for b in c.k_scale]
            rows["v_scale"] = [b[slot] for b in c.v_scale]
        return rows

    def complete_migration(self, req: Request) -> None:
        """Donor-side epilogue: the decode replica has ingested the rows
        — free the slot (a prefix-cache donor pin, if any, keeps the rows
        alive for future hits) and close the books here."""
        req.status = "migrated"
        self.scheduler.release(req)
        self.metrics.migrated_out(req.rid)
        self._rec("req_handoff", req.rid,
                  detail=f"phase={self.role} emitted={len(req.generated)}")

    def ingest_migration(
        self,
        *,
        rid: str,
        prompt: Any,
        max_new_tokens: int,
        rows: Dict[str, Any],
        last_token: int,
        eos_id: Optional[int] = None,
        on_token: Optional[Callable[[str, int], None]] = None,
        emitted_prefix: Sequence[int] = (),
        tier: str = "standard",
        tenant: Optional[str] = None,
    ) -> str:
        """Receive a mid-stream request from a prefill replica: allocate
        a slot, write the shipped ``rows`` through the ``migrate_ingest``
        program, and register the request exactly as a unified engine
        holds it after emitting its first token (``last_token``), so the
        decode stream continues unchanged.

        Bypasses admission: no queue, no prefix-cache consult, no re-fire
        of ``on_token`` for the carried token (the donor streamed it).
        ``max_new_tokens`` is the ORIGINAL budget; the carried token
        counts against it.  Raises ``RuntimeError`` when the pool has no
        free slot (the router re-parks and retries)."""
        if self.role != "decode":
            raise ValueError(
                "ingest_migration is the decode pool's entry point — "
                f"this engine's role is {self.role!r}"
            )
        self._check_rid_free(rid)
        check_tier(tier)
        req = Request(
            rid=rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id,
            on_token=on_token,
            emitted_prefix=list(emitted_prefix),
            tier=tier,
            tenant=tenant,
        )
        if req.prompt_len + req.max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"request {rid!r}: prompt ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds this "
                f"pool's max_len={self.pool.max_len} — a disaggregated "
                "fleet needs equal max_len across roles"
            )
        slot = self.pool.alloc(rid)
        if slot is None:
            raise RuntimeError(
                "decode pool full: no free slot for migrated request "
                f"{rid!r} — retry when a stream finishes"
            )
        t0 = self._rec_clock()
        try:
            self._run_rows("migrate_ingest", 0, slot, req.prompt_len, rows=rows)
        except Exception:
            # Register NOTHING on failure: the request is still parked
            # on the donor, slot and all.
            self.pool.free(slot)
            raise
        req.slot = slot
        req.status = "active"
        req.prefilled = req.prompt_len
        req.generated = [int(last_token)]   # emitted on the donor
        self._requests[rid] = req
        self.scheduler.active[rid] = req
        self.metrics.arrived(rid)
        self.metrics.ingested(rid)
        self.pool.lengths[slot] = req.prompt_len  # shadow miss -> upload
        self._cur_tok[slot] = int(last_token)
        self._rec(
            "req_ingest", rid,
            dur=max(self._rec_clock() - t0, 0.0),
            detail=(f"phase=decode rows={req.prompt_len} slot={slot} "
                    f"emitted={len(req.generated)}"),
        )
        return rid

    # ------------------------------------------------------------------ #
    # run / drain / resume                                               #
    # ------------------------------------------------------------------ #

    def run(self, max_steps: Optional[int] = None) -> str:
        """Iterate until idle, preempted, or ``max_steps``.  Returns
        ``'idle'`` | ``'preempted'`` | ``'budget'``."""
        steps = 0
        while not self.scheduler.idle:
            if self._preempted():
                self.drain()
                return "preempted"
            if not self.step():
                break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return "budget"
        return "idle"

    def request_drain(self) -> None:
        """Ask the engine to drain at the next iteration boundary (safe
        from a PreemptionHandler callback or another thread)."""
        self._drain_requested = True

    def resume_serving(self) -> None:
        """Re-open a drained engine for admissions.  The captured
        programs and the pool are unchanged, so serving resumes without
        a rebuild."""
        self._draining = False
        self._drain_requested = False

    def _preempted(self) -> bool:
        if self._drain_requested:
            return True
        h = self._preemption
        return bool(h is not None and getattr(h, "preempted", False))

    def drain(self, step_id: Optional[int] = None) -> Dict[str, Any]:
        """Cooperative drain: stop admitting, snapshot every unfinished
        request (original prompt + tokens emitted so far), release all
        slots, and — when a CheckpointManager is wired — persist the
        snapshot.  Returns the snapshot dict."""
        self._draining = True
        # Migration-parked requests (prefill role) are in flight too.
        unfinished = (list(self.scheduler.queue)
                      + list(self.scheduler.active.values())
                      + list(self._migration_ready))
        tree: Dict[str, Dict[str, np.ndarray]] = {}
        meta: Dict[str, Dict[str, Any]] = {}
        for r in unfinished:
            tree[r.rid] = {
                "prompt": np.asarray(r.prompt, np.int32),
                "generated": np.asarray(r.generated, np.int32),
            }
            meta[r.rid] = {
                "max_new_tokens": r.max_new_tokens,
                "eos_id": r.eos_id,
                "emitted_prefix": list(r.emitted_prefix),
                "prompt_len": r.prompt_len,
                "generated_len": len(r.generated),
                "tier": r.tier,
                "tenant": r.tenant,
            }
        if self.recorder is not None:
            for r in unfinished:
                self._flush_decode_group(r.rid)
                self._rec("req_preempt", r.rid, detail=f"drain emitted={len(r.generated)}")
            self.recorder.record("drain", detail=f"{len(unfinished)} in-flight")
        for r in list(self.scheduler.active.values()):
            r.status = "preempted"
            self.scheduler.release(r)
        for r in list(self.scheduler.queue):
            r.status = "preempted"
        self.scheduler.queue.clear()
        for r in self._migration_ready:
            r.status = "preempted"
            self.scheduler.release(r)   # frees the held slot
        self._migration_ready.clear()
        self.metrics.drained(len(unfinished))
        for rid in meta:
            self.metrics.finished(rid, status="preempted")
        # Persist only when there is something to restore, and never at a
        # step id an earlier drain used: CheckpointManager.save REPLACES
        # an existing step_<n> snapshot.
        if self._checkpoint_manager is not None and meta:
            sid = step_id if step_id is not None else self.metrics.engine_steps
            if self._last_drain_sid is not None:
                sid = max(sid, self._last_drain_sid + 1)
            self._checkpoint_manager.save(sid, tree, metadata={"requests": meta})
            self._last_drain_sid = sid
        self._drain_requested = False
        snapshot = {"tree": tree, "requests": meta}
        for hook in list(self.drain_hooks):
            hook(snapshot)
        return snapshot

    @staticmethod
    def restore_requests(source: Any) -> List[Dict[str, Any]]:
        """Rebuild submit() kwargs for every request a drain snapshot
        holds — from a CheckpointManager or a :meth:`drain` return.
        Each entry resubmits with the prompt EXTENDED by the tokens
        already emitted (teacher-forced on resume) and the budget shrunk
        accordingly."""
        if isinstance(source, dict):
            meta = source["requests"]
            tree = source["tree"]
        else:
            snap = source.restore_latest()
            if snap is None:
                return []
            meta = snap.metadata["requests"]
            template = {
                rid: {
                    "prompt": np.zeros((m["prompt_len"],), np.int32),
                    "generated": np.zeros((m["generated_len"],), np.int32),
                }
                for rid, m in meta.items()
            }
            tree = source.restore_step(snap.step, template).tree
        out: List[Dict[str, Any]] = []
        for rid, m in meta.items():
            prompt = np.asarray(tree[rid]["prompt"], np.int32)
            generated = np.asarray(tree[rid]["generated"], np.int32)
            out.append({
                "rid": rid,
                "prompt": np.concatenate([prompt, generated]),
                "max_new_tokens": int(m["max_new_tokens"]) - generated.size,
                "eos_id": m["eos_id"],
                "emitted_prefix": list(m["emitted_prefix"]) + generated.tolist(),
                "tier": m.get("tier", "standard"),
                "tenant": m.get("tenant"),
            })
        return out


__all__ = ["Engine", "TensorSpec"]
