"""The port's fleet layer against the JAX reference's.

Both packages serve the same seeded workloads over the same weights
(``tests/torch_fleet_parity.py``): the router's streams, its
``RouterRecord`` placements and its registry counters; prefix reuse
against a cold prefill; the speculative engine against a plain engine;
the autoscaler's actions on a virtual clock; the rollout's events; and
the synthetic trace byte for byte.  ``program_count`` and
``compile_stats`` (traces there, first builds here) must be equal.
Behaviours the reference pins without a second package (drain, crash,
refcounts) are held here against the port's own cold engine, whose
streams ``tests/test_torch_serving.py`` holds against the reference's.

The CUDA graphs of the new programs are held to their eager bodies by
``tests/test_torch_cuda_serving.py`` on the card.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from torch_fleet_parity import (
    KW,
    Clock,
    JCFG,
    JDRAFT,
    TCFG,
    TDRAFT,
    counters,
    jengine,
    shared_prefix_workload,
    tengine,
    weights,
)
from torchgpipe_tpu import fleet as jfleet
from torchgpipe_tpu.obs import MetricsRegistry as JRegistry
from torchgpipe_tpu.resilience import faults as jfaults
from torchgpipe_tpu_torch import fleet
from torchgpipe_tpu_torch.obs import MetricsRegistry
from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.serving import ServingMetrics


@pytest.fixture(scope="module")
def w():
    return weights(0)


@pytest.fixture(scope="module")
def draft():
    return weights(1, JDRAFT, TDRAFT)


def _cold(model, reqs, **kw):
    """Each request's stream from a plain port engine."""
    eng = tengine(model, **kw)
    rids = [eng.submit(p, n) for p, n in reqs]
    eng.run()
    return [eng.result(r).tolist() for r in rids]


# --------------------------------------------------------------------- #
# the synthetic trace, byte for byte                                    #
# --------------------------------------------------------------------- #


TRACES = {
    "default": lambda m: m.TraceConfig(n_requests=300, seed=3),
    "prefill_heavy": lambda m: m.prefill_heavy_config(64, seed=5, max_len=64),
    "router_phase": lambda m: m.TraceConfig(
        n_requests=48, vocab=128256, n_tenants=4, prefix_len=(256, 512),
        suffix_len=(16, 128), new_tokens=(32, 96), max_len=1152),
    "disagg_phase": lambda m: m.prefill_heavy_config(32, max_len=1152, vocab=128256),
}


@pytest.mark.parametrize("which", sorted(TRACES))
def test_synthetic_trace_is_the_references_byte_for_byte(which):
    jcfg, tcfg = TRACES[which](jfleet), TRACES[which](fleet)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jstats, tstats = jfleet.TraceStats(), fleet.TraceStats()
    want = list(jfleet.synthetic_trace(jcfg, jstats))
    got = list(fleet.synthetic_trace(tcfg, tstats))
    assert len(got) == len(want) == tcfg.n_requests
    for a, b in zip(got, want):
        assert a.prompt.dtype == b.prompt.dtype
        assert a.prompt.tobytes() == b.prompt.tobytes()
        assert (a.index, a.arrival_s, a.tenant, a.session, a.prefix_len,
                a.max_new_tokens) == (b.index, b.arrival_s, b.tenant,
                                      b.session, b.prefix_len, b.max_new_tokens)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert [p.tobytes() for p in fleet.tenant_prefixes(tcfg)] == [
        p.tobytes() for p in jfleet.tenant_prefixes(jcfg)]
    assert fleet.trace_summary(tcfg, 64) == jfleet.trace_summary(jcfg, 64)


# --------------------------------------------------------------------- #
# the router                                                            #
# --------------------------------------------------------------------- #


def _records(router):
    return {rid: (r.replica, r.moves, r.tokens) for rid, r in router._records.items()}


def test_router_failover_matches_reference(w):
    """r0 dies at its step 3 mid-burst; its in-flight requests resume on
    r1.  Streams, placements, moves and the shared registry's counters
    equal the reference's, and the streams equal an undisturbed run."""
    reqs = shared_prefix_workload(seed=0, n=6)
    out = []
    for pkg, reg, make, flt, model in (
        (jfleet, JRegistry(), jengine, jfaults, w[0]),
        (fleet, MetricsRegistry(), tengine, faults, w[1]),
    ):
        # A still clock: the TPOT tie-break of power-of-two-choices reads
        # clock differences, which a wall clock would make differ between
        # the two runs.
        router = pkg.Router(
            {n: make(model, registry=reg.labeled(replica=n), clock=Clock())
             for n in ("r0", "r1")},
            registry=reg, seed=1)
        with flt.inject(die_at_step=(0, 3)):
            rids = [router.submit(p, n) for p, n in reqs]
            assert router.run() == "idle"
        assert not router.replicas["r0"].alive
        assert router._c_failovers.value() == 1 and router._c_moved.value() > 0
        out.append((rids, _records(router), counters(reg),
                    {n: r.engine.compile_stats for n, r in router.replicas.items()}))
    (jrids, jrec, jcnt, jstats), (trids, trec, tcnt, tstats) = out
    assert trids == jrids and trec == jrec and tcnt == jcnt and tstats == jstats
    assert [trec[r][2] for r in trids] == _cold(w[1], reqs)


def test_router_p2c_and_session_affinity_match_reference(w):
    """Power-of-two-choices (``RandomState(seed)``) spreads sessionless
    load over both replicas with the reference's choices; ``session=``
    pins all turns of one conversation to one replica."""
    reqs = shared_prefix_workload(seed=9, n=8)
    out = []
    for pkg, reg, make, model in ((jfleet, JRegistry(), jengine, w[0]),
                                  (fleet, MetricsRegistry(), tengine, w[1])):
        router = pkg.Router(
            {n: make(model, registry=reg.labeled(replica=n), clock=Clock())
             for n in ("r0", "r1")},
            registry=reg, seed=7)
        for p, n in reqs:
            router.submit(p, n)
            router.step()
        router.run()
        sess = [router.submit(p, n, session="conv") for p, n in reqs[:4]]
        assert len({router._records[r].replica for r in sess}) == 1
        router.run()
        routed = {n: router._c_routed.value(replica=n) for n in ("r0", "r1")}
        assert routed["r0"] > 0 and routed["r1"] > 0
        out.append((_records(router), routed))
    assert out[0] == out[1]


def _router(model, names=("r0", "r1"), seed=0, **kw):
    return fleet.Router({n: tengine(model, **kw) for n in names}, seed=seed)


@pytest.mark.parametrize("how", ["router", "engine", "request_drain", "crash"])
def test_drains_and_crashes_resume_on_the_survivor(w, how):
    """A pinned session's replica leaves mid-burst — drained by the
    router (it stays alive, out of rotation), drained by its own engine
    (the router's drain hook), through the engine's drain request under
    router stepping, or by a real crash escaping its step — and every
    stream finishes on the survivor as an undisturbed run's."""
    router = _router(w[1])
    reqs = shared_prefix_workload(seed={"router": 3, "engine": 5,
                                        "request_drain": 9, "crash": 7}[how], n=4)
    rids = [router.submit(p, n, session="s0") for p, n in reqs]
    pinned = router._records[rids[0]].replica
    for _ in range(2):
        router.step()
    rep = router.replicas[pinned]
    if how == "router":
        assert router.drain_replica(pinned)
    elif how == "engine":
        rep.engine.drain()
    elif how == "request_drain":
        rep.engine.request_drain()
    else:
        def boom():
            raise RuntimeError("device lost")
        rep.engine.step = boom
    assert router.run() == "idle"
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)
    if how == "crash":
        assert not rep.alive and router._c_failovers.value() == 1
    else:
        assert rep.alive and rep.draining
        survivor = "r1" if pinned == "r0" else "r0"
        assert router.pick_replica() == survivor


def test_failover_keeps_a_session_together(w):
    router = _router(w[1], names=("r0", "r1", "r2"), seed=2)
    reqs = shared_prefix_workload(seed=13, n=4)
    rids = [router.submit(p, n, session="conv") for p, n in reqs]
    pinned = router._records[rids[0]].replica
    router.step()
    moved = router.failover(pinned)
    assert len(moved) >= 2
    landed = {router._records[r].replica for r in moved}
    assert len(landed) == 1 and pinned not in landed
    assert router.run() == "idle"
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)


def test_router_edge_cases(w):
    """A refused submit leaves no record; a broken client callback is not
    a dead replica; the last replica dying strands its request with a
    greedy-exact prefix instead of crashing ``run``; ``die_at_step``
    counts the replica's OWN steps even with one shared metrics
    object."""
    router = fleet.Router({"r0": tengine(w[1])})
    with pytest.raises(ValueError):
        router.submit(np.arange(30, dtype=np.int32), 30, rid="big")
    assert "big" not in router._records
    rid = router.submit(np.arange(4, dtype=np.int32), 2, rid="big")

    def bad_callback(rid, tok):
        raise OSError("client went away")

    p = np.arange(4, dtype=np.int32)
    rid2 = router.submit(p, 4, on_token=bad_callback)
    assert router.run() == "idle" and router.replicas["r0"].alive
    assert router.result(rid).size == 2
    assert router.result(rid2).tolist() == _cold(w[1], [(p, 4)])[0]

    lone = fleet.Router({"r0": tengine(w[1])})
    rid = lone.submit(p, 4)
    with faults.inject(die_at_step=(0, 1)):
        assert lone.run() == "idle"
    assert not lone.replicas["r0"].alive
    assert lone.status(rid) in ("queued", "preempted")
    got = lone.result(rid).tolist()
    assert got == _cold(w[1], [(p, 4)])[0][:len(got)]

    shared = ServingMetrics()
    two = fleet.Router({n: tengine(w[1], metrics=shared) for n in ("r0", "r1")}, seed=1)
    reqs = shared_prefix_workload(seed=0, n=6)
    with faults.inject(die_at_step=(0, 3)):
        rids = [two.submit(p, n) for p, n in reqs]
        assert two.run() == "idle"
    assert two._replica_steps["r0"] == 3 and shared.engine_steps > 3
    assert [two.result(r).tolist() for r in rids] == _cold(w[1], reqs)


# --------------------------------------------------------------------- #
# the radix prefix cache                                                #
# --------------------------------------------------------------------- #


def test_prefix_reuse_matches_reference_and_cold_prefill(w):
    """Shared-prefix requests through a prefix-cached engine: streams
    equal a cold engine's and the reference's; fewer prefill steps; the
    trie's stats, the reuse counters, ``program_count`` (one more
    program) and ``compile_stats`` (``prefix_copy`` built once) equal
    the reference's."""
    reqs = shared_prefix_workload(seed=11, n=6, prefix_len=10)
    out = []
    for pkg, make, model in ((jfleet, jengine, w[0]), (fleet, tengine, w[1])):
        pc = pkg.RadixPrefixCache(min_prefix_len=4, max_entries=2)
        eng = make(model, prefix_cache=pc)
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run()
        m = eng.metrics
        out.append(([eng.result(r).tolist() for r in rids], pc.stats(),
                    eng.compile_stats, eng.program_count,
                    (m.prefix_hits, m.prefix_reused_tokens, m.prefill_steps),
                    sorted((e.slot, e.tokens) for e in pc.entries())))
        eng.pool.check_refcounts()
    assert out[1] == out[0]
    streams, stats, compiled, n_programs, (hits, reused, prefill_steps), _ = out[1]
    cold = tengine(w[1])
    for p, n in reqs:
        cold.submit(p, n)
    cold.run()
    assert streams == _cold(w[1], reqs)
    assert stats["hits"] == hits > 0 and stats["reused_tokens"] == reused > 0
    assert prefill_steps < cold.metrics.prefill_steps
    assert n_programs == cold.program_count + 1
    assert compiled["prefix_copy"] == 1


def test_prefix_reuse_int8_matches_cold(w):
    """The int8 branch of ``prefix_copy``: K/V banks and the scale banks,
    whose length axis sits elsewhere (``[S, kv_heads, L]``)."""
    reqs = shared_prefix_workload(seed=17, n=4, prefix_len=10)
    pc = fleet.RadixPrefixCache(min_prefix_len=4, max_entries=2)

    def serve(eng):
        first = eng.submit(*reqs[0])
        eng.run()                      # the first completes alone: a donor
        rids = [first] + [eng.submit(p, n) for p, n in reqs[1:]]
        eng.run()
        return [eng.result(r).tolist() for r in rids]

    warm = tengine(w[1], kv_quant=True, prefix_cache=pc)
    assert serve(warm) == serve(tengine(w[1], kv_quant=True))
    assert pc.hits > 0 and pc.reused_tokens > 0
    warm.pool.check_refcounts()


def test_prefix_refcounts_never_recycle_referenced_slots(w):
    pc = fleet.RadixPrefixCache(min_prefix_len=4, max_entries=2)
    eng = tengine(w[1], num_slots=2, prefix_cache=pc)
    for burst in range(4):
        for p, n in shared_prefix_workload(seed=20 + burst, n=3):
            eng.submit(p, n)
        eng.run()
        eng.pool.check_refcounts()
        for entry in pc.entries():
            assert entry.slot not in eng.pool._free
            assert eng.pool.refcount(entry.slot) >= 1
    pc.clear(eng.pool)
    eng.pool.check_refcounts()
    assert eng.pool.num_free == eng.pool.num_slots


class _Pool:
    """The refcount surface the trie calls, shared by both packages'
    tries in the op-sequence comparison."""

    def __init__(self):
        self.refs = {}

    def retain(self, slot):
        self.refs[slot] = self.refs.get(slot, 0) + 1

    def release(self, slot):
        self.refs[slot] -= 1

    def refcount(self, slot):
        return self.refs.get(slot, 0)

    def owner_of(self, slot):
        return None


def test_radix_trie_matches_reference_on_a_random_op_sequence():
    rng = np.random.RandomState(0)
    tries = [(m.RadixPrefixCache(min_prefix_len=3, max_entries=3), _Pool())
             for m in (jfleet, fleet)]
    base = [rng.randint(0, 4, (8,)).astype(np.int32) for _ in range(3)]
    log = [[], []]
    for step in range(300):
        op = rng.randint(4)
        p = np.concatenate([base[rng.randint(3)][:rng.randint(2, 9)],
                            rng.randint(0, 4, (rng.randint(0, 4),)).astype(np.int32)])
        slot, want = int(rng.randint(6)), int(rng.randint(1, 3))
        for i, (pc, pool) in enumerate(tries):
            if op == 0:
                log[i].append(pc.insert(p, slot, pool))
            elif op == 1:
                log[i].append(pc.reclaim(pool, want))
            else:
                log[i].append(pc.match(p, limit=int(p.size) - 1))
            log[i].append((pc.stats(), sorted((e.slot, e.tokens, e.last_used)
                                              for e in pc.entries()),
                           dict(pool.refs)))
    assert log[1] == log[0]
    for m in (jfleet, fleet):
        with pytest.raises(ValueError):
            m.RadixPrefixCache(min_prefix_len=0)
        with pytest.raises(ValueError):
            m.RadixPrefixCache(max_entries=0)


# --------------------------------------------------------------------- #
# the speculative engine                                                #
# --------------------------------------------------------------------- #


def test_speculative_engine_matches_reference_and_plain(w, draft):
    """A draft proposes gamma=3 tokens a round, verified through the
    engine's own prefill program: streams equal the reference's and a
    plain engine's; the round counters, ``program_count`` (the base
    bound plus one draft program per bucket and g=1) and the builds per
    program equal the reference's."""
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(0, 64, (int(rng.randint(3, 11)),)).astype(np.int32),
             int(rng.randint(4, 10))) for _ in range(7)]
    out = []
    for pkg, (params, dparams), make in (
        (jfleet, (w[0], draft[0]), jengine), (fleet, (w[1], draft[1]), None),
    ):
        kw = dict(gamma=3, num_slots=3, max_len=32, prefill_chunk=(4, 8))
        eng = (pkg.SpeculativeEngine(JCFG, params, JDRAFT, dparams, **kw)
               if make is not None else
               pkg.SpeculativeEngine(TCFG, params, TDRAFT, dparams, device="cpu", **kw))
        rids = [eng.submit(p, n) for p, n in reqs[:4]]
        eng.step()
        rids += [eng.submit(p, n) for p, n in reqs[4:]]
        eng.run()
        out.append(([eng.result(r).tolist() for r in rids], eng.compile_stats,
                    eng.program_count, eng.draft_buckets,
                    (eng._c_rounds.value(), eng._c_proposed.value(),
                     eng._c_accepted.value())))
    assert out[1] == out[0]
    assert out[1][0] == _cold(w[1], reqs, num_slots=3, prefill_chunk=(4, 8))
    assert out[1][2] == 2 + 1 + 3


def test_speculative_self_draft_accepts_everything(w):
    eng = fleet.SpeculativeEngine(TCFG, w[1], TCFG, w[1], gamma=3, num_slots=2,
                                  max_len=32, prefill_chunk=8, device="cpu")
    reqs = shared_prefix_workload(seed=21, n=3)
    rids = [eng.submit(p, n + 6) for p, n in reqs]
    eng.run()
    assert eng.acceptance_rate == 1.0
    assert [eng.result(r).tolist() for r in rids] == _cold(
        w[1], [(p, n + 6) for p, n in reqs], num_slots=2)


@pytest.mark.parametrize("kwargs,match", [
    (dict(gamma=0), "gamma must be"),
    (dict(temperature=1.0), "greedy-only"),
    (dict(role="prefill"), "unified-only"),
    (dict(prefix_cache=object()), "prefix_cache"),
    (dict(gamma=8), "verify chunk"),
])
def test_speculative_refusals(w, draft, kwargs, match):
    kwargs = dict(dict(gamma=3, num_slots=2, max_len=32, prefill_chunk=8), **kwargs)
    with pytest.raises(ValueError, match=match):
        fleet.SpeculativeEngine(TCFG, w[1], TDRAFT, draft[1], device="cpu", **kwargs)


# --------------------------------------------------------------------- #
# the autoscaler (policy on engine facades, then real engines)          #
# --------------------------------------------------------------------- #


class _FakeEngine:
    def __init__(self, role="unified"):
        self.role = role
        self.drain_hooks = []
        self.pool = type("P", (), {"num_slots": 1, "num_free": 1, "max_len": 32})()
        self.scheduler = type("S", (), {"queue": [], "active": {}, "idle": True})()
        self.migration_pending = False

    def drain(self):
        return {"tree": {}, "requests": {}}

    def resume_serving(self):
        pass

    def kv_row_specs(self):
        return {}


class _Burning:
    def active_alerts(self):
        return ["p95_ttft"]


def _scenario(pkg, reg_cls, name):
    """One autoscaler script on ``pkg``; returns its actions and the
    registry's counters."""
    clock = Clock()
    reg = reg_cls(clock=clock)
    acts = []
    if name == "disagg":
        roles = {"p0": "prefill", "p1": "prefill", "d0": "decode", "d1": "decode"}
        router = pkg.Router({n: _FakeEngine(r) for n, r in roles.items()}, registry=reg)
        scaler = pkg.Autoscaler(router, service_time_s=0.05, headroom=1.0, hold_ticks=1)
        for _ in range(3):
            clock.t += 0.1
            acts.append(scaler.tick())
        scaler.observe_arrival(60)
        acts.append((scaler.desired_replicas(role="prefill"),
                     scaler.desired_replicas(role="decode")))
        clock.t += 0.01
        scaler.observe_arrival(1)
        acts.append(scaler.tick())
        clock.t += 60.0
        for _ in range(3):
            clock.t += 0.5
            router._c_migrations.inc(30)
            acts.append(scaler.tick())
        return acts, list(scaler.parked), counters(reg)
    kw = dict(service_time_s=0.05, headroom=1.0, hold_ticks=2)
    router_kw = {}
    if name == "cooldown":
        kw["cooldown_s"] = 10.0
    if name == "slo_floor":
        router_kw["slo_min_in_rotation"] = 2
        kw.update(hold_ticks=1, min_replicas=1)
    if name == "burning":
        kw["slo"] = _Burning()
    router = pkg.Router({f"r{i}": _FakeEngine() for i in range(3)}, registry=reg,
                        **router_kw)
    scaler = pkg.Autoscaler(router, **kw)
    for _ in range(6):
        clock.t += 0.1
        acts.append(scaler.tick())
    if name == "cooldown":
        clock.t += 10.0
        acts.append(scaler.tick())
    scaler.observe_arrival(60)
    acts.append(scaler.desired_replicas())
    for _ in range(4):
        clock.t += 0.01
        scaler.observe_arrival(1)
        acts.append(scaler.tick())
    return acts, list(scaler.parked), counters(reg)


@pytest.mark.parametrize("name", ["trajectory", "cooldown", "slo_floor",
                                  "burning", "disagg"])
def test_autoscaler_actions_match_reference(name):
    """Little's-law pricing, hysteresis, cooldown, the SLO floor and burn
    override, and per-pool pricing of a disaggregated fleet: the same
    script on a virtual clock gives the reference's actions, parked
    list and registry counters."""
    want = _scenario(jfleet, JRegistry, name)
    got = _scenario(fleet, MetricsRegistry, name)
    assert got == want
    assert any(a is not None for a in got[0])


def test_autoscaler_cost_model_names_item_5_6():
    router = fleet.Router({"r0": _FakeEngine()})
    with pytest.raises(NotImplementedError, match=r"queue A item 5\.6"):
        fleet.Autoscaler(router, cost_model=object())
    with pytest.raises(NotImplementedError, match=r"queue A item 5\.6"):
        fleet.Autoscaler(router, service_time_s=0.05, pipe=object())
    with pytest.raises(ValueError, match="price"):
        fleet.Autoscaler(router)
    with pytest.raises(ValueError):
        fleet.Autoscaler(router, service_time_s=0.05, headroom=0.5)


def test_autoscaler_scale_down_keeps_every_stream(w):
    clock = Clock()
    reg = MetricsRegistry(clock=clock)
    router = fleet.Router(
        {n: tengine(w[1], registry=reg.labeled(replica=n)) for n in ("r0", "r1")},
        registry=reg, seed=0)
    scaler = fleet.Autoscaler(router, service_time_s=0.05, hold_ticks=1,
                              min_replicas=1)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 64, (6,)).astype(np.int32), 4) for _ in range(4)]
    rids = [router.submit(p, n, session="s0") for p, n in reqs]
    for _ in range(2):
        router.step()
    clock.t += 5.0
    action = scaler.tick()
    assert action is not None and action.startswith("down:")
    assert router.run() == "idle"
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)
    assert reg.counter("autoscaler_resizes_total",
                       labels=("direction",)).value(direction="down") == 1
    clock.t += 0.01
    scaler.observe_arrival(200)
    assert scaler.tick() is not None and not scaler.parked


# --------------------------------------------------------------------- #
# the rollout                                                           #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def v1():
    return weights(2)


def _rollout(pkg, make, v0, v1, reqs, rollback_after=None):
    reg = (JRegistry if pkg is jfleet else MetricsRegistry)()
    # The port swaps in place: each replica gets weights of its own (as
    # the reference's engines each hold their own params), and the
    # module's fixture is never written.
    own = (lambda m: m) if pkg is jfleet else copy.deepcopy
    router = pkg.Router({n: make(own(v0), registry=reg.labeled(replica=n), clock=Clock())
                         for n in ("r0", "r1")}, registry=reg, seed=0)
    ctl = pkg.RolloutController(router)
    rids = [router.submit(p, n) for p, n in reqs[:3]]
    router.step()
    assert ctl.publish(v1, 1) == 2
    acts = []
    for i in range(12):
        if i == 2:
            rids += [router.submit(p, n) for p, n in reqs[3:]]
        if rollback_after is not None and i == rollback_after:
            acts.append(ctl.rollback("drill"))
        acts.append(ctl.tick())
        acts.append(dict(ctl.versions()))
        router.step()
    router.run()
    return (acts, [router.result(r).tolist() for r in rids], ctl.baseline,
            ctl.target, counters(reg))


@pytest.mark.parametrize("rollback_after", [None, 1])
def test_rollout_matches_reference(w, v1, rollback_after):
    """publish -> one drain/swap/readmit per tick -> complete, or a
    rollback one tick in: the actions, the versions per tick, every
    stream (full length, zero dropped) and the registry's rollout
    counters equal the reference's."""
    reqs = shared_prefix_workload(seed=31, n=5)
    want = _rollout(jfleet, jengine, w[0], v1[0], reqs, rollback_after)
    got = _rollout(fleet, tengine, w[1], v1[1], reqs, rollback_after)
    assert got == want
    assert [len(s) for s in got[1]] == [n for _, n in reqs]
    assert any(isinstance(a, str) and a.startswith("swap:") for a in got[0])


def test_rollback_restores_the_booted_weights(w, v1):
    """The engine serves in place, so the rollback floor keeps a copy of
    every tensor the swap overwrote: publish v1, swap, roll back, and
    the booted model holds v0 again, its streams a fresh engine's."""
    reqs = shared_prefix_workload(seed=33, n=3)
    boot = copy.deepcopy(w[1])
    router = fleet.Router({"r0": tengine(boot)})
    ctl = fleet.RolloutController(router)
    ctl.publish(v1[1], 1)
    assert ctl.tick() == "swap:r0:v1"
    rids = [router.submit(p, n) for p, n in reqs]
    router.run()
    assert [router.result(r).tolist() for r in rids] == _cold(v1[1], reqs)
    assert ctl.rollback("drill") == "rollback:v0"
    assert ctl.tick() == "swap:r0:v0" and ctl.versions() == {"r0": 0}
    for a, b in zip(boot.parameters(), w[1].parameters()):
        assert torch.equal(a, b)
    rids = [router.submit(p, n) for p, n in reqs]
    router.run()
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)


def test_rollout_swaps_replicas_that_share_weights_together(w, v1):
    """Two replicas serving one model's tensors change version in one
    visit (a swap into shared tensors is seen by both)."""
    model = copy.deepcopy(w[1])
    router = fleet.Router({n: tengine(model) for n in ("r0", "r1")}, seed=0)
    assert router.replicas["r0"].engine.weights_key() == \
        router.replicas["r1"].engine.weights_key()
    ctl = fleet.RolloutController(router)
    reqs = shared_prefix_workload(seed=35, n=4)
    rids = [router.submit(p, n) for p, n in reqs]
    router.step()
    ctl.publish(v1[1], 1)
    assert ctl.tick() == "swap:r0:v1"
    assert ctl.versions() == {"r0": 1, "r1": 1}
    assert ctl.tick() == "complete:v1"
    router.run()
    assert all(router.result(r).size == n for r, (_, n) in zip(rids, reqs))
    ctl.publish(w[1], 2)
    assert ctl.tick() == "swap:r0:v2"
    ctl.rollback("drill")
    assert ctl.tick() == "swap:r0:v1" and ctl.versions() == {"r0": 1, "r1": 1}
    for a, b in zip(model.parameters(), v1[1].parameters()):
        assert torch.equal(a, b)


def test_publish_refusals(w):
    router = fleet.Router({"r0": tengine(w[1])})
    ctl = fleet.RolloutController(router)
    with pytest.raises(ValueError, match="not above"):
        ctl.publish(w[1], 0)
    _, other = weights(3, JCFG.__class__(**dict(KW, dim=48)),
                       TCFG.__class__(**dict(KW, dim=48)))
    with pytest.raises(ValueError, match="publish refused"):
        ctl.publish(other, 1)
    assert ctl.target == 0 and ctl.versions() == {"r0": 0}
