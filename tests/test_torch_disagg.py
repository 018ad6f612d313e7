"""The port's phase-disaggregated serving against the JAX reference's.

A prefill-role engine runs only its prefill ladder and parks each
request at prompt completion; ``fleet.migration.migrate`` ships the
slot's KV rows to a decode-role engine, whose one ``migrate_ingest``
program writes them.  On the same weights and trace (the reference
tests' tiny float32 Llama, ``tests/torch_fleet_parity.py``) the split
fleet's streams equal the reference split fleet's and a unified
replica's token for token; the migration counters, the per-role
``program_count`` and ``compile_stats`` equal the reference's; the rows
the decode pool holds are bitwise the exported ones.
"""

import copy

import numpy as np
import pytest
import torch

from torch_fleet_parity import (
    JCFG,
    Clock,
    TCFG,
    counters,
    jengine,
    tengine,
    weights,
)
from torchgpipe_tpu import fleet as jfleet
from torchgpipe_tpu.obs import MetricsRegistry as JRegistry
from torchgpipe_tpu_torch import fleet, obs
from torchgpipe_tpu_torch.fleet.migration import MigrationError
from torchgpipe_tpu_torch.obs import MetricsRegistry
from torchgpipe_tpu_torch.obs.flightrec import FlightRecorder, dump_from_dict
from torchgpipe_tpu_torch.serving import Engine


@pytest.fixture(scope="module")
def w():
    return weights(0)


def _workload(seed, n, plen=(3, 9), new=(2, 7)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (int(rng.randint(*plen)),)).astype(np.int32),
             int(rng.randint(*new))) for _ in range(n)]


def _cold(model, reqs, **kw):
    eng = tengine(model, **kw)
    rids = [eng.submit(p, n) for p, n in reqs]
    eng.run()
    return [eng.result(r).tolist() for r in rids]


def _split(pkg, make, model, roles, seed=1, **kw):
    reg = (JRegistry if pkg is jfleet else MetricsRegistry)()
    router = pkg.Router(
        {name: make(model, role=role, registry=reg.labeled(replica=name), clock=Clock(), **kw)
         for name, role in roles},
        registry=reg, seed=seed)
    return router, reg


PAIR = [("p0", "prefill"), ("d0", "decode")]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_split_fleet_matches_reference_and_unified(w, kv_quant):
    """Every request prefills on p0, hands off once, finishes on d0: the
    streams, the records' placements, the registry's counters and each
    role's program set equal the reference's; the streams equal a
    unified engine's (int8 pools ship rows AND scales)."""
    reqs = _workload(seed=3 if kv_quant else 0, n=6)
    out = []
    for pkg, make, model in ((jfleet, jengine, w[0]), (fleet, tengine, w[1])):
        router, reg = _split(pkg, make, model, PAIR, kv_quant=kv_quant)
        rids = [router.submit(p, n, session=f"s{i % 2}")
                for i, (p, n) in enumerate(reqs)]
        assert router.run() == "idle"
        assert reg.counter("fleet_migrations").value() == len(reqs)
        peng, deng = (router.replicas[n].engine for n in ("p0", "d0"))
        assert all(r.status == "migrated" for r in peng.metrics.requests.values())
        assert all(deng.metrics.requests[r].status == "finished" for r in rids)
        out.append(([router.result(r).tolist() for r in rids],
                    {r: (x.replica, x.moves) for r, x in router._records.items()},
                    counters(reg),
                    (peng.program_count, peng.compile_stats),
                    (deng.program_count, deng.compile_stats)))
    assert out[1] == out[0]
    streams, _, _, (p_count, p_stats), (d_count, d_stats) = out[1]
    assert streams == _cold(w[1], reqs, kv_quant=kv_quant)
    assert p_count == 1 and "decode" not in p_stats
    assert d_count == 2 and d_stats == {"decode": 1, "migrate_ingest": 1}


def test_migrated_rows_are_the_exported_rows_bitwise(w):
    """``migrate`` by hand, through the host-staged transport and in
    place: the decode pool's rows [0, n) of the target slot are bitwise
    the donor's export, rows above n keep what the target slot held."""
    reqs = _workload(seed=7, n=2, plen=(6, 9), new=(5, 7))
    for stage_host in (False, True):
        peng = tengine(w[1], role="prefill", kv_quant=stage_host)
        deng = tengine(w[1], role="decode", kv_quant=stage_host)
        fleet.validate_pools(peng, deng)
        with torch.inference_mode():        # the pool's tensors are inference tensors
            for c in (deng.pool.cache.k + deng.pool.cache.v):
                c.fill_(3 if c.dtype == torch.int8 else 0.5)
        for p, n in reqs:
            peng.submit(p, n)
        while not peng.migration_pending or len(peng._migration_ready) < 2:
            peng.step()
        for req in peng.take_migration_ready():
            rows = {k: [t.clone() for t in v]
                    for k, v in peng.export_kv_rows(req).items()}
            fleet.migrate(peng, deng, req, stage_host=stage_host)
            slot, n = deng.scheduler.active[req.rid].slot, req.prompt_len
            for kind, leaves in rows.items():
                axis = 0 if kind in ("k", "v") else 1
                for got, want in zip(getattr(deng.pool.cache, kind), leaves):
                    g = got[slot].movedim(axis, 0)
                    wnt = want.movedim(axis, 0)
                    assert torch.equal(g[:n], wnt[:n])
                    fill = 3 if g.dtype == torch.int8 else 0.5
                    if kind in ("k", "v"):
                        assert bool((g[n:] == fill).all())
        assert peng.pool.num_free == peng.pool.num_slots
        deng.run()
    assert deng.compile_stats["migrate_ingest"] == 1


def test_role_and_fleet_validation(w):
    model = w[1]
    with pytest.raises(ValueError, match="role"):
        tengine(model, role="draft")
    with pytest.raises(ValueError, match="prefix cache"):
        tengine(model, role="decode", prefix_cache=fleet.RadixPrefixCache())
    with pytest.raises(ValueError):
        fleet.Router({"u0": tengine(model), "p0": tengine(model, role="prefill")})
    with pytest.raises(ValueError, match="decode"):
        fleet.Router({"p0": tengine(model, role="prefill")})
    with pytest.raises(ValueError, match="unified-only"):
        fleet.SpeculativeEngine(TCFG, model, TCFG, model, gamma=2, num_slots=2,
                                max_len=32, role="prefill", device="cpu")
    with pytest.raises(MigrationError, match="max_len"):
        fleet.validate_pools(tengine(model, role="prefill"),
                             tengine(model, role="decode", max_len=40))
    with pytest.raises(MigrationError, match="row specs"):
        fleet.validate_pools(tengine(model, role="prefill"),
                             tengine(model, role="decode", kv_quant=True))
    with pytest.raises(MigrationError, match="prefill-role"):
        fleet.validate_pools(tengine(model, role="decode"),
                             tengine(model, role="decode"))


def test_wrong_role_calls_are_refused(w):
    deng = tengine(w[1], role="decode", num_slots=2)
    with pytest.raises(ValueError, match="ingest_migration"):
        deng.submit(np.zeros(3, np.int32), 4)
    ueng = tengine(w[1], num_slots=2)
    with pytest.raises(ValueError, match="role"):
        ueng.ingest_migration(rid="q0", prompt=np.zeros(3, np.int32),
                              max_new_tokens=4, rows={}, last_token=1)
    assert ueng.kv_row_specs() == deng.kv_row_specs()
    assert not ueng.migration_pending and ueng.take_migration_ready() == []
    with pytest.raises(ValueError, match="no slot"):
        ueng.export_kv_rows(type("R", (), {"rid": "x", "slot": None})())
    full = tengine(w[1], role="decode", num_slots=1)
    rows = {k: [torch.zeros(s.shape, dtype=s.dtype) for s in v]
            for k, v in full.kv_row_specs().items()}
    full.ingest_migration(rid="a", prompt=np.arange(3, dtype=np.int32),
                          max_new_tokens=4, rows=rows, last_token=1)
    with pytest.raises(RuntimeError, match="decode pool full"):
        full.ingest_migration(rid="b", prompt=np.arange(3, dtype=np.int32),
                              max_new_tokens=4, rows=rows, last_token=1)
    assert "b" not in full._requests


def test_prefix_hits_never_repin_on_the_decode_pool(w):
    pc = fleet.RadixPrefixCache(min_prefix_len=4)
    reg = MetricsRegistry()
    peng = tengine(w[1], role="prefill", prefix_cache=pc,
                   registry=reg.labeled(replica="p0"))
    deng = tengine(w[1], role="decode", registry=reg.labeled(replica="d0"))
    router = fleet.Router({"p0": peng, "d0": deng}, registry=reg, seed=1)
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, 64, (8,)).astype(np.int32)
    reqs = [(np.concatenate([prefix, rng.randint(0, 64, (int(rng.randint(1, 5)),))
                             .astype(np.int32)]), int(rng.randint(2, 6)))
            for _ in range(6)]
    rids = [router.submit(p, n) for p, n in reqs]
    assert router.run() == "idle"
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)
    assert pc.hits > 0
    assert deng.pool.num_pinned == 0
    assert deng.pool.num_free == deng.pool.num_slots
    peng.pool.check_refcounts()
    assert peng.program_count == 2 and peng.compile_stats["prefix_copy"] == 1


def test_session_pins_bind_decode_placement_only(w):
    router, _ = _split(fleet, tengine, w[1],
                       [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")],
                       seed=2)
    reqs = _workload(seed=9, n=8)
    rids = [router.submit(p, n, session=f"s{i % 2}") for i, (p, n) in enumerate(reqs)]
    assert router.run() == "idle"
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)
    for s in ("s0", "s1"):
        assert router._sessions[s] in router.pools["decode"]
        homes = {name for name in ("d0", "d1")
                 for rid, r in router.replicas[name].engine.metrics.requests.items()
                 if r.status == "finished" and rid in rids[int(s[1])::2]}
        assert len(homes) == 1, (s, homes)


def test_decode_replica_death_reprefills_and_remigrates(w):
    """A decode replica dying mid-stream: its requests re-prefill on the
    prefill pool (teacher-forced), re-migrate to the surviving decode
    replica, and every stream equals a unified run's."""
    from torchgpipe_tpu_torch.resilience import faults

    router, reg = _split(fleet, tengine, w[1],
                         [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")])
    reqs = _workload(seed=13, n=6, new=(5, 9))
    with faults.inject(die_at_step=(1, 4)):
        rids = [router.submit(p, n) for p, n in reqs]
        assert router.run() == "idle"
    assert not router.replicas["d0"].alive
    assert router._c_moved.value() > 0
    assert reg.counter("fleet_migrations").value() > len(reqs)
    assert [router.result(r).tolist() for r in rids] == _cold(w[1], reqs)


def test_stitched_trace_tells_the_handoff_story(w):
    """One rid's flight events across the prefill replica, the decode
    replica and the router stitch into one complete tree: a
    prefill-phase attempt ending in the handoff, an explicit kv-handoff
    migration span, a decode-phase attempt ending in the finish."""
    recs = {n: FlightRecorder(worker=n) for n in ("p0", "d0")}
    router_rec = FlightRecorder(worker="router")
    reg = MetricsRegistry()
    router = fleet.Router(
        {n: tengine(w[1], role=role, recorder=recs[n], registry=reg.labeled(replica=n))
         for n, role in PAIR},
        registry=reg, seed=1, recorder=router_rec)
    reqs = _workload(seed=11, n=3)
    rids = [router.submit(p, n) for p, n in reqs]
    assert router.run() == "idle"
    dumps = [dump_from_dict(r.to_dict()) for r in (*recs.values(), router_rec)]
    for rid in rids:
        trace = obs.stitch_request(dumps, rid)
        assert trace.replicas == ["p0", "d0"] and trace.migrations == 1
        assert trace.orphans == [] and trace.complete
        names = [s.name for s in trace.root.children]
        assert {"attempt@p0:prefill", "attempt@d0:decode",
                "migration p0->d0"} <= set(names)
        mig = next(s for s in trace.root.children if s.name == "migration p0->d0")
        assert "kv handoff" in mig.detail
        p_att = next(s for s in trace.root.children if s.name == "attempt@p0:prefill")
        assert [c.name for c in p_att.children][-1] == "handoff"
        d_att = next(s for s in trace.root.children if s.name == "attempt@d0:decode")
        kinds = [c.name for c in d_att.children]
        assert "decode" in kinds and kinds[-1] == "finish"
        assert "phase=decode" in d_att.detail        # opened by req_ingest
        assert "attempt@d0:decode" in obs.format_request_tree(trace)


def test_prefill_engine_drain_snapshots_parked_requests(w):
    """A prefill replica draining with requests parked between prompt
    completion and handoff snapshots them too (and frees their slots):
    restoring the snapshot onto a unified engine finishes every stream
    as a unified run's."""
    peng = tengine(w[1], role="prefill")
    reqs = _workload(seed=17, n=3)
    rids = [peng.submit(p, n) for p, n in reqs]
    while len(peng._migration_ready) < len(reqs):
        peng.step()
    snap = peng.drain()
    assert set(snap["requests"]) == set(rids)
    assert peng.pool.num_free == peng.pool.num_slots and not peng.migration_pending
    fresh = tengine(copy.deepcopy(w[1]))
    for kw in Engine.restore_requests(snap):
        fresh.submit(kw.pop("prompt"), kw.pop("max_new_tokens"), **kw)
    fresh.run()
    assert [fresh.result(r).tolist() for r in rids] == _cold(w[1], reqs)
    assert JCFG.vocab == TCFG.vocab
