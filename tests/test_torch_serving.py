"""The port's serving Engine against the JAX reference engine.

Both engines run the SAME request trace (submits, staggered steps,
cancellations, drains) over the same weights: a small float32 Llama
(vocab 64, dim 32, 2 layers, 4 heads, 2 kv heads — the reference's
``tests/test_serving.py`` config), initialised by the reference and
converted with ``params_from_jax``, traces from numpy seeds.  Greedy
streams must be EQUAL token for token: both sides compute the same
float32 network in another summation order (~1e-6 relative on the
logits), which flips an argmax only at a near-tie these seeded traces do
not have.  ``compile_stats`` must be equal too (traces there, first
builds here).  On the CPU the port runs each program's body eagerly;
the captured CUDA graphs are held to those bodies by
``tests/test_torch_cuda_serving.py`` on the card.

The reference's ``test_resilience::test_classify_error`` fails on jax
0.9.0 (it imports ``jaxlib.xla_extension``), so the port's
``classify_error`` is held against a table written here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.obs.registry import MetricsRegistry as JRegistry
from torchgpipe_tpu.resilience.checkpoint import CheckpointManager as JCheckpointManager
from torchgpipe_tpu.serving import Engine as JEngine
from torchgpipe_tpu.serving.metrics import ServingMetrics as JServingMetrics
from torchgpipe_tpu.tune import serving_cache_bytes as j_cache_bytes
from torchgpipe_tpu.tune import serving_max_slots as j_max_slots
from torchgpipe_tpu.tune import tree_bytes as j_tree_bytes
from torchgpipe_tpu_torch import tune
from torchgpipe_tpu_torch.models.moe import MoEConfig
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.obs.registry import MetricsRegistry
from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.resilience.checkpoint import CheckpointManager
from torchgpipe_tpu_torch.resilience.guard import GuardPolicy, classify_error
from torchgpipe_tpu_torch.resilience.preemption import PreemptionHandler
from torchgpipe_tpu_torch.serving import Engine
from torchgpipe_tpu_torch.serving.metrics import ServingMetrics
from torchgpipe_tpu_torch.serving.scheduler import normalize_buckets

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


def _weights(seed):
    params, _, _ = sequential_init(
        jt.llama(JCFG), jax.random.PRNGKey(seed), jax.ShapeDtypeStruct((2, 8), jnp.int32)
    )
    model = params_from_jax(TCFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def weights():
    return _weights(0)


def _engines(weights, **kw):
    params, model = weights
    return JEngine(JCFG, params, **kw), Engine(TCFG, model, device="cpu", **kw)


def _workload(seed, n, plen_lo=2, plen_hi=10, new_hi=8):
    rng = np.random.RandomState(seed)
    return [
        (rng.randint(0, 64, (int(rng.randint(plen_lo, plen_hi)),)).astype(np.int32),
         int(rng.randint(2, new_hi)))
        for _ in range(n)
    ]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _drive(eng, script):
    """Run ``script`` (a list of ``(op, arg)``) on ``eng``; returns every
    submitted request's ``(status, tokens)``."""
    rids = []
    for op, arg in script:
        if op == "submit":
            prompt, new, kw = arg
            rids.append(eng.submit(prompt, new, **kw))
        elif op == "step":
            for _ in range(arg):
                eng.step()
        elif op == "cancel":
            eng.cancel(arg)
        elif op == "run":
            eng.run()
    return {r: (eng.status(r), eng.result(r).tolist()) for r in rids}


def _same(weights, script, **kw):
    jeng, teng = _engines(weights, **kw)
    want, got = _drive(jeng, script), _drive(teng, script)
    assert got == want
    assert teng.compile_stats == jeng.compile_stats
    return jeng, teng, got


# --------------------------------------------------------------------- #
# streams: single bucket, ladder, churn, cancellation                   #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("prefill_chunk", [4, (1, 2, 4, 8)])
def test_staggered_trace_with_cancels_equals_jax(weights, prefill_chunk):
    """16 ragged requests (prompts 1-15), two steps between submits, two
    cancelled while queued or just admitted: equal streams and statuses,
    no program built twice."""
    script = []
    for i, (prompt, new) in enumerate(_workload(0, 16, plen_lo=1, plen_hi=16)):
        script.append(("submit", (prompt, new, {})))
        if i in (5, 11):
            script.append(("cancel", f"r{i + 1}"))
        else:
            script.append(("step", 2))
    script.append(("run", None))
    _, teng, got = _same(weights, script, num_slots=4, max_len=32,
                         prefill_chunk=prefill_chunk)
    assert all(v <= 1 for v in teng.compile_stats.values())
    assert teng.compile_stats["decode"] == 1
    assert [s for s, _ in got.values()].count("cancelled") == 2
    teng.pool.check_refcounts()
    assert teng.pool.num_free == 4


def test_ladder_builds_each_bucket_once(weights):
    """Served one at a time, prompt lengths 1, 2, 3, 7 and 12 pick every
    bucket of (1, 2, 4, 8); a second, staggered pass over the same mix
    builds nothing more (the reference's compile-counter test)."""
    rng = np.random.RandomState(5)
    mix = [(1, 2), (2, 2), (3, 2), (7, 2), (12, 3)]
    script = []
    for plen, new in mix:
        script += [("submit", (rng.randint(0, 64, (plen,)).astype(np.int32), new, {})),
                   ("run", None)]
    script += [("submit", (rng.randint(0, 64, (plen,)).astype(np.int32), new, {}))
               for plen, new in mix] + [("run", None)]
    _, teng, _ = _same(weights, script, num_slots=3, max_len=32,
                       prefill_chunk=(1, 2, 4, 8))
    assert teng.compile_stats == {"prefill@1": 1, "prefill@2": 1, "prefill@4": 1,
                                  "prefill@8": 1, "decode": 1}
    assert teng.program_count == 5


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bucket_wider_than_the_cache_equals_jax(weights, kv_quant):
    """A ladder bucket wider than ``max_len`` (32 over a 24-position
    pool): prompts of 9-20 tokens pick it, and its tokens past the
    buffer write nothing, as the reference's dropped writes do."""
    rng = np.random.RandomState(9)
    script = []
    for i in range(6):
        prompt = rng.randint(0, 64, (int(rng.randint(9, 21)),)).astype(np.int32)
        script += [("submit", (prompt, int(rng.randint(2, 4)), {})), ("step", i % 2)]
    script.append(("run", None))
    _, teng, got = _same(weights, script, num_slots=3, max_len=24,
                         prefill_chunk=(4, 8, 32), kv_quant=kv_quant)
    assert teng.compile_stats["prefill@32"] == 1
    assert all(s == "finished" for s, _ in got.values())


def test_cache_dtype_equals_jax(weights):
    """``cache_dtype=bfloat16`` over float32 parameters: the pool is
    bf16 on both sides, with equal bytes and equal streams."""
    rng = np.random.RandomState(13)
    script = [("submit", (rng.randint(0, 64, (int(rng.randint(2, 12)),)).astype(np.int32),
                          int(rng.randint(2, 8)), {})) for _ in range(6)]
    script.append(("run", None))
    params, model = weights
    jeng = JEngine(JCFG, params, num_slots=4, max_len=32, prefill_chunk=4,
                   cache_dtype=jnp.bfloat16)
    teng = Engine(TCFG, model, num_slots=4, max_len=32, prefill_chunk=4,
                  cache_dtype=torch.bfloat16, device="cpu")
    assert _drive(teng, script) == _drive(jeng, script)
    assert teng.pool.cache.k[0].dtype == torch.bfloat16
    assert teng.pool.bytes() == jeng.pool.bytes() - 4 == \
        tune.serving_cache_bytes(TCFG, 4, 32) // 2


@pytest.mark.parametrize("prefill_chunk", [4, (1, 2, 4, 8)])
def test_soak_churn_equals_jax(weights, prefill_chunk):
    """Random churn: submits, cancels of queued or live requests, and
    0-3 steps between arrivals."""
    rng = np.random.RandomState(11)
    script, live = [], []
    for i in range(24):
        prompt = rng.randint(0, 64, (int(rng.randint(1, 14)),)).astype(np.int32)
        kw = {"eos_id": int(rng.randint(64))} if i % 3 == 0 else {}
        script.append(("submit", (prompt, int(rng.randint(1, 9)), kw)))
        live.append(f"r{i + 1}")
        if rng.rand() < 0.2:
            script.append(("cancel", live.pop(int(rng.randint(len(live))))))
        script.append(("step", int(rng.randint(0, 4))))
    script.append(("run", None))
    _same(weights, script, num_slots=4, max_len=32, prefill_chunk=prefill_chunk)


def test_wave_admission_and_metrics_equal_reference(weights):
    """A ragged mix through continuous and wave (static-batching)
    admission, each engine on a deterministic clock: the whole metrics
    snapshot equals the reference engine's, and continuous batching beats
    the wave baseline in steps, tokens per step and occupancy."""
    rng = np.random.RandomState(3)
    script = [("submit", (rng.randint(0, 64, (int(rng.randint(3, 7)),)).astype(np.int32),
                          [24, 2, 3, 20, 2, 4, 18, 3, 2, 16, 3, 2][i], {}))
              for i in range(12)] + [("run", None)]
    snaps = {}
    for wave in (False, True):
        jeng, teng = _engines(weights, num_slots=4, max_len=32, prefill_chunk=4,
                              wave_admission=wave)
        jeng.metrics = JServingMetrics(clock=FakeClock())
        teng.metrics = ServingMetrics(clock=FakeClock())
        assert _drive(teng, script) == _drive(jeng, script)
        snaps[wave] = teng.metrics.snapshot()
        assert snaps[wave] == jeng.metrics.snapshot()
    cont, stat = snaps[False], snaps[True]
    assert cont["tokens_out"] == stat["tokens_out"] == 99
    assert cont["engine_steps"] < stat["engine_steps"]
    assert cont["tokens_per_step"] > stat["tokens_per_step"]
    assert cont["occupancy"] > stat["occupancy"]


def test_cancel_mid_decode_frees_slot_and_spares_neighbours(weights):
    """A request cancelled mid-decode keeps its tokens so far, frees its
    slot at once, and the rest of the batch streams on unchanged."""
    script = [("submit", (p, n, {})) for p, n in _workload(3, 3, new_hi=9)]
    script += [("step", 4), ("cancel", "r2"), ("step", 1)]
    script += [("submit", (p, n, {})) for p, n in _workload(4, 2)]
    script.append(("run", None))
    _, teng, got = _same(weights, script, num_slots=3, max_len=32, prefill_chunk=4)
    assert got["r2"][0] == "cancelled" and 0 < len(got["r2"][1])
    assert teng.metrics.requests["r2"].status == "cancelled"


# --------------------------------------------------------------------- #
# slot reuse                                                            #
# --------------------------------------------------------------------- #


def _cache_bytes(cache):
    bufs = [t for name in ("k", "v", "k_scale", "v_scale") for t in getattr(cache, name, [])]
    return [t.clone() for t in bufs]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_slot_reuse_bitwise_clean(weights, kv_quant):
    """alloc -> decode -> free -> realloc THE SAME slots: streams equal a
    fresh pool's (stale rows and int8 scales are dead by masking) and the
    JAX engine's; a no-op row's cache bytes are untouched by a step."""
    first, second = _workload(2, 4), _workload(7, 4)
    hold_prompt = first[0][0][:3]
    kw = dict(num_slots=4, max_len=32, prefill_chunk=4, kv_quant=kv_quant)

    def serve(eng, reqs):
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run()
        return [eng.result(r).tolist() for r in rids]

    jdirty, dirty = _engines(weights, **kw)
    for eng in (jdirty, dirty):
        serve(eng, first)
        assert eng.pool.num_free == 4
        eng.submit(hold_prompt, 20, rid="hold")
        for _ in range(4):
            eng.step()
    # The held request's slot is a no-op row of the next prefill step:
    # none of its bytes may change.
    slot = dirty._requests["hold"].slot
    before = [t[slot].clone() for t in _cache_bytes(dirty.pool.cache)]
    dirty.submit(second[0][0], second[0][1], rid="probe")
    dirty.scheduler.admit()
    dirty.metrics.admitted("probe")
    dirty._run_prefill()
    after = [t[slot] for t in _cache_bytes(dirty.pool.cache)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    dirty.cancel("probe")
    got_dirty = serve(dirty, second)
    want = serve(jdirty, second)

    fresh = Engine(TCFG, weights[1], device="cpu", **kw)
    fresh.submit(hold_prompt, 20)
    for _ in range(4):
        fresh.step()
    assert got_dirty == serve(fresh, second) == want


# --------------------------------------------------------------------- #
# drain / resume                                                        #
# --------------------------------------------------------------------- #


def test_drain_resume_exact_and_jax_snapshot_restores(weights, tmp_path):
    """Preemption mid-burst through ``PreemptionHandler.simulate()``: the
    port drains to its CheckpointManager and a fresh engine resumes every
    stream to the never-preempted JAX stream.  The JAX engine's own drain
    snapshot, written by the reference's CheckpointManager, restores in
    the port the same way."""
    reqs = _workload(1, 6, new_hi=9)
    kw = dict(num_slots=2, max_len=48, prefill_chunk=4)
    jref, _ = _engines(weights, **kw)
    want = _drive(jref, [("submit", (p, n, {})) for p, n in reqs] + [("run", None)])

    def drain_then_resume(eng_cls, mgr_cls, restore_mgr_cls, params, d):
        handler = PreemptionHandler()      # not installed: simulate() only
        extra = {"device": "cpu"} if eng_cls is Engine else {}
        eng = eng_cls(JCFG if eng_cls is JEngine else TCFG, params,
                      preemption=handler if eng_cls is Engine else None,
                      checkpoint_manager=mgr_cls(str(d)), **kw, **extra)
        rids = [eng.submit(p, n) for p, n in reqs]
        for _ in range(7):
            eng.step()
        if eng_cls is Engine:
            handler.simulate()
            assert eng.run() == "preempted"
        else:
            eng.drain()
        snap = eng.metrics.snapshot()
        assert snap["drains"] == 1 and snap["preempted_requests"] > 0
        eng2 = Engine(TCFG, weights[1], device="cpu", **kw)
        restored = Engine.restore_requests(restore_mgr_cls(str(d)))
        assert restored
        for r in restored:
            eng2.submit(r.pop("prompt"), r.pop("max_new_tokens"), **r)
        eng2.run()
        return {r: ("finished", (eng2 if r in eng2._requests else eng).result(r).tolist())
                for r in rids}

    assert drain_then_resume(Engine, CheckpointManager, CheckpointManager,
                             weights[1], tmp_path / "port") == want
    assert drain_then_resume(JEngine, JCheckpointManager, CheckpointManager,
                             weights[0], tmp_path / "jax") == want


def test_drain_resume_same_engine(weights):
    """``request_drain`` mid-trace, ``resume_serving``, and the drain
    snapshot (caught by a drain hook) resubmitted to the SAME engine: the
    streams continue exactly, and nothing is rebuilt."""
    reqs = _workload(5, 5, new_hi=9)
    jeng, teng = _engines(weights, num_slots=2, max_len=48, prefill_chunk=(2, 4))
    want = _drive(jeng, [("submit", (p, n, {})) for p, n in reqs] + [("run", None)])
    snaps = []
    teng.drain_hooks.append(snaps.append)
    rids = [teng.submit(p, n) for p, n in reqs]
    for _ in range(6):
        teng.step()
    stats = teng.compile_stats
    teng.request_drain()
    assert teng.run() == "preempted"
    assert teng.scheduler.idle and teng.pool.num_free == 2
    restored = Engine.restore_requests(snaps[0])
    assert len(restored) == teng.metrics.snapshot()["preempted_requests"] > 0
    assert not teng.step()                    # drained: nothing admits
    teng.resume_serving()
    for r in restored:
        teng.submit(r.pop("prompt"), r.pop("max_new_tokens"), **r)
    teng.run()
    assert {r: ("finished", teng.result(r).tolist()) for r in rids} == want
    assert teng.compile_stats == stats == jeng.compile_stats


# --------------------------------------------------------------------- #
# swap_params, admission control, rejections                           #
# --------------------------------------------------------------------- #


def test_swap_params_equals_fresh_engine_and_refuses_reshape(weights):
    """After ``swap_params`` the engine streams what a fresh engine on the
    new weights streams (and the JAX engine swapped alike), with nothing
    rebuilt; a shape change is refused."""
    new_params, new_model = _weights(1)
    reqs = _workload(6, 4)
    script = [("submit", (p, n, {})) for p, n in reqs] + [("run", None)]
    _, old_model = _weights(0)            # a private copy: the swap writes into it
    eng = Engine(TCFG, old_model, num_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    _drive(eng, script)
    stats = eng.compile_stats
    eng.swap_params(new_model, version=1)
    assert eng.version == 1
    got = _drive(eng, [("submit", (p, n, {"rid": f"v1-{i}"})) for i, (p, n) in
                       enumerate(reqs)] + [("run", None)])
    assert eng.compile_stats == stats
    fresh = Engine(TCFG, new_model, num_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    want = _drive(fresh, [("submit", (p, n, {"rid": f"v1-{i}"})) for i, (p, n) in
                          enumerate(reqs)] + [("run", None)])
    jeng = JEngine(JCFG, weights[0], num_slots=2, max_len=32, prefill_chunk=4)
    jeng.swap_params(new_params, version=1)
    jwant = _drive(jeng, [("submit", (p, n, {"rid": f"v1-{i}"})) for i, (p, n) in
                          enumerate(reqs)] + [("run", None)])
    assert got == want == jwant
    wide = tt.llama(tt.TransformerConfig(**dict(KW, dim=64)), device="cpu")
    with pytest.raises(ValueError, match="signature"):
        eng.swap_params(wide, version=2)
    assert eng.version == 1


def test_admission_cap_equals_reference_donated(weights):
    """The cap is the reference's ``serving_max_slots(..., donated=True)``
    whatever ``donate`` says (the port's steps update the pool in place),
    and the pool itself is clamped to it.  The reference's pool also
    counts a 4-byte ``length`` scalar the port keeps on the host, so the
    budgets here sit mid-slot, away from that 4-byte band."""
    params, model = weights
    per_slot = j_cache_bytes(JCFG, 2, 32) - j_cache_bytes(JCFG, 1, 32)
    assert tune.serving_cache_bytes(TCFG, 2, 32) - tune.serving_cache_bytes(TCFG, 1, 32) \
        == per_slot
    assert tune.serving_cache_bytes(TCFG, 3, 32) == 3 * per_slot
    for kv_quant in (False, True):
        assert (tune.serving_cache_bytes(TCFG, 4, 32, kv_quant=kv_quant)
                == j_cache_bytes(JCFG, 4, 32, kv_quant=kv_quant) - 4)
    pbytes = j_tree_bytes(params)
    assert tune.tree_bytes(model) == pbytes
    for k in (1, 2, 3, 5):
        budget = pbytes + k * per_slot + per_slot // 2
        want = j_max_slots(JCFG, 32, budget, param_bytes=pbytes, donated=True)
        assert want == k
        for donate in (False, True):
            eng = Engine(TCFG, model, num_slots=4, max_len=32, prefill_chunk=4,
                         hbm_budget_bytes=budget, donate=donate, device="cpu")
            assert eng.scheduler.max_active == min(4, want) == eng.pool.num_slots
    eng = Engine(TCFG, model, num_slots=4, max_len=32, prefill_chunk=4,
                 hbm_budget_bytes=pbytes + 2 * per_slot + per_slot // 2, device="cpu")
    for p, n in _workload(4, 6):
        eng.submit(p, n)
    peak = 0
    while eng.step():
        peak = max(peak, eng.pool.num_active)
    assert peak == 2
    with pytest.raises(ValueError, match="admission cap is 0"):
        Engine(TCFG, model, num_slots=4, max_len=32, hbm_budget_bytes=1, device="cpu")


def test_rejections_leave_nothing_registered(weights):
    jeng, teng = _engines(weights, num_slots=2, max_len=16)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.arange(10, dtype=np.int32), 10)
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="unknown QoS tier"):
            eng.submit(np.arange(3, dtype=np.int32), 2, tier="premium")
        eng.submit(np.arange(3, dtype=np.int32), 2, rid="a")
        with pytest.raises(ValueError, match="duplicate request id"):
            eng.submit(np.arange(3, dtype=np.int32), 2, rid="a")
    assert teng._requests.keys() == jeng._requests.keys() == {"a"}
    assert len(teng.scheduler.queue) == 1


@pytest.mark.parametrize("kwargs,what", [
    (dict(role="prefill"), "role='prefill'"),
    (dict(role="decode"), "role='decode'"),
    (dict(prefix_cache=object()), "prefix_cache="),
    (dict(recorder=object()), "recorder="),
    (dict(reporter=object()), "reporter="),
    (dict(moe=MoEConfig(ep_axis="ep")), "moe="),   # MoE is served; ep (5.4) is not
])
def test_not_ported_arguments_name_their_item(weights, kwargs, what):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A item 5") as e:
        Engine(TCFG, weights[1], num_slots=2, max_len=16, device="cpu", **kwargs)
    assert what in str(e.value)
    with pytest.raises(ValueError, match="role must be"):
        Engine(TCFG, weights[1], num_slots=2, max_len=16, device="cpu", role="mixed")


@pytest.mark.parametrize("call", [
    lambda e: e.kv_row_specs(), lambda e: e.migration_pending,
    lambda e: e.take_migration_ready(), lambda e: e.export_kv_rows(None),
    lambda e: e.complete_migration(None), lambda e: e.ingest_migration(rid="x"),
])
def test_not_ported_methods_name_their_item(weights, call):
    eng = Engine(TCFG, weights[1], num_slots=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A item 5"):
        call(eng)


def test_engine_runs_on_the_card_unless_asked(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(TCFG, weights[1], num_slots=2, max_len=16)
    with pytest.raises(ValueError, match="generator"):
        Engine(TCFG, weights[1], num_slots=2, max_len=16, device="cpu", temperature=1.0)


# --------------------------------------------------------------------- #
# programs, the lengths buffer, retry                                   #
# --------------------------------------------------------------------- #


def test_program_specs_are_request_independent(weights):
    eng = Engine(TCFG, weights[1], num_slots=3, max_len=24, prefill_chunk=(2, 4),
                 kv_quant=True, device="cpu")
    specs = eng.step_input_specs()
    assert set(specs) == {"prefill@2", "prefill@4", "decode"} and eng.program_count == 3
    assert specs["prefill@4"]["tokens"] == ((3, 4), torch.int64)
    assert specs["decode"]["tokens"] == ((3, 1), torch.int64)
    assert specs["decode"]["lengths"] == ((3,), torch.int64)
    assert specs["decode"]["cache"]["k_scale"][0] == ((3, 2, 24), torch.float32)
    assert specs["decode"]["cache"]["k"][0] == ((3, 24, 2, 8), torch.int8)
    assert normalize_buckets([8, 2, 4, 2, 1]) == (1, 2, 4, 8)


def test_steady_decode_reuses_device_lengths(weights, monkeypatch):
    """The decode loop does not re-upload the frontiers each step: the
    program advances the device buffer in place, and the host mirror is
    copied only when admission or eviction changed it."""
    from torchgpipe_tpu_torch.serving import cache_pool

    uploads = {"n": 0}
    real = cache_pool.CachePool.lengths_device

    def counting(self, *a, **k):
        uploads["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(cache_pool.CachePool, "lengths_device", counting)
    jeng, teng = _engines(weights, num_slots=2, max_len=64, prefill_chunk=4)
    p = np.arange(4, dtype=np.int32)
    script = [("submit", (p, 24, {})), ("run", None)]
    assert _drive(teng, script) == _drive(jeng, script)
    assert teng.metrics.snapshot()["engine_steps"] > 10
    assert uploads["n"] <= 2, uploads


def test_dispatch_retries_transient_errors(weights):
    """A transient failure in a step is retried inside the engine
    (bounded backoff, counted in metrics), its lengths re-uploaded from
    the host mirror, and the stream still equals the reference's; a
    fatal one and ``donate=True`` re-raise."""
    sleeps = []
    jeng, teng = _engines(weights, num_slots=2, max_len=32, prefill_chunk=4)
    teng._sleep = sleeps.append
    prog = teng._programs["decode"]
    real = prog.run
    state = {"raised": 0}

    def flaky(engine):
        real(engine)          # the step ran, then the device "failed"
        if state["raised"] < 2:
            state["raised"] += 1
            raise ConnectionError("transient blip")

    prog.run = flaky
    p, n = _workload(9, 1)[0]
    script = [("submit", (p, n, {})), ("run", None)]
    assert _drive(teng, script) == _drive(jeng, script)
    assert state["raised"] == 2 and sleeps == [0.25, 0.5]
    assert teng.metrics.snapshot()["retries"] == 2

    for donate, err in ((True, ConnectionError("blip")), (False, RuntimeError("bug"))):
        eng = Engine(TCFG, weights[1], num_slots=2, max_len=32, prefill_chunk=4,
                     donate=donate, device="cpu")

        def broken(engine, err=err):
            raise err

        eng._programs["prefill"].run = broken
        eng.submit(p, n)
        with pytest.raises(type(err)):
            eng.run()
        assert eng.metrics.retries == 0


def test_classify_error_table():
    class PeerGone(ConnectionResetError):
        pass

    table = [
        (ConnectionError("x"), "transient"), (PeerGone("x"), "transient"),
        (TimeoutError("x"), "transient"), (torch.cuda.OutOfMemoryError("x"), "transient"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "fatal"),
        (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
        (ValueError("shape"), "fatal"), (KeyError("k"), "fatal"),
    ]
    assert [classify_error(e) for e, _ in table] == [c for _, c in table]
    pol = GuardPolicy()
    assert [pol.backoff(a) for a in range(7)] == [0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 8.0]


# --------------------------------------------------------------------- #
# metrics registry, checkpoints, preemption                             #
# --------------------------------------------------------------------- #


def test_registry_snapshot_equals_reference():
    """One event sequence through the port's ServingMetrics and the
    reference's, each on its own registry: equal snapshots and equal
    Prometheus and JSONL exports."""
    import io

    pair = []
    for reg_cls, met_cls in ((JRegistry, JServingMetrics), (MetricsRegistry, ServingMetrics)):
        clock = FakeClock()
        reg = reg_cls(clock=clock)
        m = met_cls(clock=clock, registry=reg)
        for rid in ("a", "b", "c"):
            m.arrived(rid)
        m.admitted("a")
        m.admitted("b")
        m.step("prefill", 2, 4)
        for _ in range(3):
            m.token("a")
            m.step("decode", 2, 4)
        m.token("b")
        m.finished("a")
        m.finished("b", status="cancelled")
        m.retries += 1
        m.drained(1)
        m.finished("c", status="preempted")
        lab = reg.labeled(replica="r0").counter("extra", labels=("tenant",))
        lab.inc(2, tenant="t")
        snap = m.snapshot()
        buf = io.StringIO()
        reg.write_jsonl(buf)
        pair.append((snap, reg.snapshot(), reg.to_prometheus(), buf.getvalue()))
    assert pair[0] == pair[1]


def test_checkpoint_manager_round_trips_with_reference(tmp_path):
    """Either manager restores what the other wrote (same layout, names,
    manifest and CRCs), verified restore skips a corrupt snapshot, and
    keep_last_k garbage-collects."""
    tree = {"r2": {"prompt": np.arange(5, dtype=np.int32),
                   "generated": np.zeros((0,), np.int32)},
            "b": [np.ones((2, 3), np.float32), (np.int64(7),)]}
    template = {"r2": {"prompt": np.zeros(5, np.int32), "generated": np.zeros(0, np.int32)},
                "b": [np.zeros((2, 3), np.float32), (np.int64(0),)]}
    for writer, reader in ((CheckpointManager, JCheckpointManager),
                           (JCheckpointManager, CheckpointManager)):
        d = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(d, keep_last_k=2)
        for step in (1, 2, 3):
            w.save(step, tree, metadata={"requests": {"r2": {"n": step}}})
        r = reader(d)
        assert r.steps() == [2, 3]
        snap = r.restore_latest(template)
        assert snap.step == 3 and snap.metadata == {"requests": {"r2": {"n": 3}}}
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: np.array_equal(a, b), snap.tree, tree))
        flat = r.restore_step(2).tree
        assert sorted(flat) == ["['b'][0]", "['b'][1][0]", "['r2']['generated']",
                                "['r2']['prompt']"]
        with open(f"{d}/step_0000000003/state.npz", "r+b") as f:
            f.seek(-8, 2)
            f.write(b"\0" * 8)
        assert reader(d).restore_latest(template).step == 2


def test_preemption_handler_and_injected_preemption():
    handler = PreemptionHandler()
    fired = []
    handler.add_callback(lambda: fired.append(1))
    assert not handler.preempted and not handler.check(5)
    with faults.inject(preempt_at_step=3):
        assert faults.should_preempt(3) and not faults.should_preempt(2)
        with pytest.raises(RuntimeError, match="do not nest"):
            with faults.inject(preempt_at_step=1):
                pass
        assert not handler.check(2)
        assert handler.check(3) and handler.preempted
    assert faults.active_plan() is None and fired == [1]
    handler.add_callback(lambda: fired.append(2))   # after the latch: fires now
    assert fired == [1, 2]


def test_sampled_engine_is_reproducible_from_the_generator(weights):
    """Sampling (temperature, top-k, top-p) draws from the engine's
    generator: two engines from equal seeds stream equal tokens, inside
    the vocabulary; another seed gives another stream."""
    reqs = _workload(8, 4, new_hi=12)
    script = [("submit", (p, n, {})) for p, n in reqs] + [("run", None)]

    def sampled(seed):
        eng = Engine(TCFG, weights[1], num_slots=2, max_len=32, prefill_chunk=4,
                     temperature=0.8, top_k=20, top_p=0.9, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
        return _drive(eng, script)

    a, b, c = sampled(0), sampled(0), sampled(1)
    assert a == b and a != c
    assert all(0 <= t < 64 for _, toks in a.values() for t in toks)


@pytest.mark.parametrize("g", [5, 11])
@pytest.mark.parametrize("quant", [False, True])
def test_scatter_rows_equals_a_per_token_loop(quant, g):
    """The slot step's one-shot bank write against writing each valid
    token on its own: rows at the end of the buffer (tokens past it are
    dropped), no-op rows, ragged ``n_valid``, and a chunk wider than the
    buffer (``g > L``)."""
    gen = torch.Generator().manual_seed(0)
    S, L, nkv, hd = 4, 8, TCFG.kv_heads, TCFG.head_dim
    cache = (tg.init_quant_cache if quant else tg.init_cache)(TCFG, S, L, device="cpu")
    for bufs in tg._buffers(cache):
        for t in bufs:
            t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    want = [[t.clone() for t in bufs] for bufs in tg._buffers(cache)]
    k, v = (torch.randn(S, g, nkv, hd, generator=gen) for _ in range(2))
    lengths = torch.tensor([0, 5, 6, 3])
    n_valid = torch.tensor([g, 3, 5, 0])
    news = tg._quant_rows(torch.stack([k, v])) if quant else None
    for s in range(S):
        for j in range(int(n_valid[s])):
            p = int(lengths[s]) + j
            if p >= L:
                continue
            if quant:
                (kq, vq), (ks, vs) = news
                vals = (kq[s, j], vq[s, j], ks[s, j], vs[s, j])
            else:
                vals = (k[s, j], v[s, j])
            for t, val in zip(want[0], vals):
                if t.ndim == 4:
                    t[s, p] = val.to(t.dtype)
                else:
                    t[s, :, p] = val
    tg._scatter_rows(cache, 0, k, v, lengths, n_valid)
    for got, ref in zip(tg._buffers(cache)[0], want[0]):
        assert torch.equal(got, ref)
    for got, ref in zip(tg._buffers(cache)[1], want[1]):
        assert torch.equal(got, ref)
