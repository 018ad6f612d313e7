"""The port's serving observability against the JAX reference's.

* **SLO monitor** — the same observations on both packages' registries,
  on one hand-stepped clock: the same breach/recovery events (burn rates
  included), ``breaching`` sets and registry series.
* **Request traces** — the reference's stitcher and the port's read the
  same flight dumps (a port router failover and a disaggregated
  handoff, recorded live): equal trees, renderings and Chrome traces,
  no orphan.
* **The engine's flight recorder** — a JAX engine and a port engine on
  the same weights, script and tick clock record the same rid-keyed
  events (kind, rid, duration, detail, time stamp).
* **The step reporter** — the same step sequence gives the same
  summary and log line; an engine ticks it once per iteration.
* **measured_step_flops** — counted on the meta device against the
  reference's jaxpr walk (the tolerance is derived at the test).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_fleet_parity import (
    JCFG,
    TCFG,
    Clock,
    TickClock,
    counters,
    jengine,
    shared_prefix_workload,
    tengine,
    weights,
)
from torchgpipe_tpu import fleet as jfleet
from torchgpipe_tpu import obs as jobs
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.obs.flightrec import FlightRecorder as JRecorder
from torchgpipe_tpu_torch import fleet, obs
from torchgpipe_tpu_torch.obs.flightrec import FlightRecorder, dump_from_dict
from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.utils import hw


@pytest.fixture(scope="module")
def w():
    return weights(0)


# --------------------------------------------------------------------- #
# the SLO monitor                                                       #
# --------------------------------------------------------------------- #


def _slo_script(m, name):
    """One monitor script on package ``m`` (its ``obs``); returns every
    tick's events, the breaching sets asked along the way and the
    registry's counters and gauges."""
    clock = Clock()
    reg = m.MetricsRegistry(clock=clock)
    win = dict(short_window=10.0, long_window=40.0, burn_threshold=2.0,
               min_count=2)
    log = []
    if name == "error_rate":
        bad = reg.counter("serving_retries_by", labels=("replica",))
        total = reg.counter("serving_steps_by", labels=("replica",))
        mon = m.SloMonitor(reg, [m.Objective(
            name="retries", kind="error_rate", series="serving_retries_by",
            total_series="serving_steps_by", budget=0.05)], **win)
        for i in range(100):
            clock.t += 1.0
            total.inc(replica="r0")
            if i >= 50:
                bad.inc(replica="r0")
            log.append(mon.tick())
        return log, counters(reg)
    if name == "phases":
        h = reg.histogram("serving_tpot_seconds", labels=("replica",))
        mon = m.SloMonitor(reg, [
            m.Objective(name="ttft-p95", series="serving_ttft_seconds",
                        threshold=0.1, phase="prefill"),
            m.Objective(name="tpot-p95", series="serving_tpot_seconds",
                        threshold=0.1, phase="decode"),
        ], min_interval=0.0, **win)
        for _ in range(50):
            clock.t += 1.0
            h.observe(9.0, replica="d0")
            log.append(mon.tick())
        log.append([mon.breaching(), mon.breaching(phase="decode"),
                    mon.breaching(phase="prefill")])
        return log, counters(reg)
    if name == "tenant_split":
        h = reg.histogram("tenant_ttft_seconds", labels=("tenant",))
        mon = m.SloMonitor(reg, [m.Objective(
            name="tenant-ttft", series="tenant_ttft_seconds", threshold=0.1,
            target=0.95, split_by="tenant")], **win)
        for _ in range(50):
            clock.t += 1.0
            h.observe(9.0, tenant="r1")
            log.append(mon.tick())
        log.append([mon.breaching(), mon.breaching(split_by="replica"),
                    mon.breaching(split_by="tenant")])
        return log, counters(reg)
    h = reg.histogram("serving_ttft_seconds", labels=("replica",))
    mon = m.SloMonitor(reg, [m.Objective(
        name="ttft-p95", series="serving_ttft_seconds", threshold=0.1,
        target=0.95)], **dict(win, min_count=3 if name == "min_count" else 2))
    bad_at = {"breach_recover": range(40, 72), "min_count": range(10, 11),
              "quiet": range(0)}[name]
    for i in range(120):
        clock.t += 1.0
        if i in bad_at:
            h.observe(9.0, replica="r0")
            if name == "min_count":
                h.observe(9.0, replica="r0")
        elif i < 72 and name != "min_count":
            h.observe(0.01, replica="r0")
        h.observe(0.01, replica="r1")
        log.append(mon.tick())
        if i in (41, 71, 119):
            log.append([mon.breaching(), mon.active_alerts()])
    return log, counters(reg)


@pytest.mark.parametrize("name", ["quiet", "breach_recover", "min_count",
                                  "error_rate", "phases", "tenant_split"])
def test_slo_monitor_matches_reference(name):
    want, want_reg = _slo_script(jobs, name)
    got, got_reg = _slo_script(obs, name)
    assert [[e.__dict__ if hasattr(e, "__dict__") else e for e in row] for row in got] == \
        [[e.__dict__ if hasattr(e, "__dict__") else e for e in row] for row in want]
    assert got_reg == want_reg
    fired = [e for row in got for e in row if hasattr(e, "kind")]
    if name in ("breach_recover", "error_rate"):
        assert fired and fired[0].kind == "breach"
        assert "breach" in fired[0].describe()
    if name in ("quiet", "min_count"):
        assert fired == []


def test_slo_validation_matches_reference():
    for m in (jobs, obs):
        reg = m.MetricsRegistry()
        obj = m.Objective(name="x", series="s", threshold=0.1)
        with pytest.raises(ValueError, match="phase"):
            m.Objective(name="x", series="s", threshold=0.1, phase="draft")
        for kw, match in ((dict(short_window=10.0, long_window=5.0), "short"),
                          (dict(burn_threshold=0.0), "burn_threshold"),
                          (dict(min_count=0), "min_count")):
            with pytest.raises(ValueError, match=match):
                m.SloMonitor(reg, [obj], **kw)
        with pytest.raises(ValueError, match="objective"):
            m.SloMonitor(reg, [])
        with pytest.raises(ValueError, match="duplicate"):
            m.SloMonitor(reg, [obj, obj])


# --------------------------------------------------------------------- #
# request traces over live flight dumps                                 #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def failover_dumps(w):
    """Flight dumps of a port fleet: r0 dies at its step 3 (failover),
    one request per replica recorder plus the router's."""
    recs = {n: FlightRecorder(worker=n) for n in ("r0", "r1")}
    router_rec = FlightRecorder(worker="router")
    router = fleet.Router({n: tengine(w[1], recorder=recs[n]) for n in recs},
                          seed=1, recorder=router_rec)
    reqs = shared_prefix_workload(seed=0, n=6)
    with faults.inject(die_at_step=(0, 3)):
        rids = [router.submit(p, n) for p, n in reqs]
        assert router.run() == "idle"
    return [dump_from_dict(r.to_dict()) for r in (*recs.values(), router_rec)], rids, router


def test_request_traces_match_reference_stitcher(failover_dumps, tmp_path):
    """Every request's tree, its rendering and its Chrome trace from the
    port's stitcher equal the reference stitcher's on the same dumps;
    no orphan anywhere, and the failed-over requests show both replicas
    and one migration span."""
    dumps, rids, router = failover_dumps
    assert obs.request_ids(dumps) == jobs.request_ids(dumps) == sorted(rids)
    moved = [r for r in rids if router._records[r].moves]
    assert moved
    for rid in rids:
        got, want = obs.stitch_request(dumps, rid), jobs.stitch_request(dumps, rid)
        assert got.orphans == [] and got.complete
        assert obs.format_request_tree(got) == jobs.format_request_tree(want)
        assert (got.replicas, got.migrations) == (want.replicas, want.migrations)
        obs.request_chrome_trace(got, str(tmp_path / "t.json"))
        jobs.request_chrome_trace(want, str(tmp_path / "j.json"))
        assert json.loads((tmp_path / "t.json").read_text()) == \
            json.loads((tmp_path / "j.json").read_text())
        if rid in moved:
            assert got.replicas == ["r0", "r1"] and got.migrations == 1
    with pytest.raises(ValueError, match="no dump"):
        obs.stitch_request(dumps, "nope")


def test_orphans_are_named(tmp_path):
    """An engine event without its replica's ``req_submit`` is an orphan
    on both stitchers."""
    clock = Clock()
    recs = [m(worker="r0", clock=clock) for m in (FlightRecorder, JRecorder)]
    for rec in recs:
        clock.t = 1.0
        rec.record("req_prefill", rid="a", dur=0.5, detail="g=8 take=8")
        rec.record("req_submit", rid="b", detail="prompt=3 new=2 queued=0")
        rec.record("req_finish", rid="b", detail="status=finished tokens=2")
    got = obs.stitch_request([dump_from_dict(recs[0].to_dict())], "a")
    want = jobs.stitch_request([dump_from_dict(recs[1].to_dict())], "a")
    assert [(o.replica, o.kind) for o in got.orphans] == \
        [(o.replica, o.kind) for o in want.orphans] == [("r0", "req_prefill")]
    assert not got.complete
    assert obs.format_request_tree(got) == jobs.format_request_tree(want)


# --------------------------------------------------------------------- #
# the engine's flight recorder                                          #
# --------------------------------------------------------------------- #


def _recorded(make, model, pkg, rec_cls):
    """A script with prefix reuse, a cancel, a drain and a swap on one
    engine; returns the recorder's events (seq dropped)."""
    rec = rec_cls(clock=TickClock())
    eng = make(model, prefix_cache=pkg.RadixPrefixCache(min_prefix_len=4),
               recorder=rec, clock=TickClock(), num_slots=3)
    reqs = shared_prefix_workload(seed=41, n=6, prefix_len=9)
    first = eng.submit(*reqs[0])
    eng.run()
    rids = [first] + [eng.submit(p, n) for p, n in reqs[1:]]
    eng.step()
    eng.cancel(rids[-1])
    for _ in range(3):
        eng.step()
    snap = eng.drain()
    eng.resume_serving()
    for kw in type(eng).restore_requests(snap):
        eng.submit(kw.pop("prompt"), kw.pop("max_new_tokens"), **kw)
    eng.run()
    eng.swap_params(model, 1)
    return [(e.kind, e.rid, e.dur, e.detail, e.t) for e in rec.events()]


def test_engine_flight_events_match_reference(w):
    got = _recorded(tengine, w[1], fleet, FlightRecorder)
    want = _recorded(jengine, w[0], jfleet, JRecorder)
    assert got == want
    kinds = {k for k, *_ in got}
    assert {"req_submit", "req_admit", "req_prefix_copy", "req_prefill",
            "req_decode", "req_finish", "req_preempt", "drain",
            "param_swap"} <= kinds


def test_recorder_costs_nothing_to_the_streams(w):
    """Recording is host-side only: the same script with and without a
    recorder gives the same streams and the same programs."""
    reqs = shared_prefix_workload(seed=43, n=5)
    out = []
    for rec in (None, FlightRecorder()):
        eng = tengine(w[1], recorder=rec)
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run()
        out.append(([eng.result(r).tolist() for r in rids], eng.compile_stats))
    assert out[0] == out[1]


# --------------------------------------------------------------------- #
# the step reporter                                                     #
# --------------------------------------------------------------------- #


def _report(m):
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    lines = []
    rep = m.StepReporter(items_per_step=64, items_label="tokens",
                         flops_per_step=2e9, peak_flops=1e10,
                         real_token_fraction=0.75, clock=clock, log_every=3,
                         emit=lines.append, label="train")
    for i in range(7):
        rep.step(loss=1.0 / (i + 1), items=None if i % 2 else 32)
    return rep.summary(), rep.line(), lines, counters(rep.registry)


def test_step_reporter_matches_reference():
    assert _report(obs) == _report(jobs)
    summary = _report(obs)[0]
    # dt = 0.25 s: mfu = 2e9 * 0.75 / (0.25 * 1e10)
    assert summary["measured_mfu"] == pytest.approx(0.6)


def test_engine_ticks_its_reporter_once_per_iteration(w):
    reqs = shared_prefix_workload(seed=45, n=5)
    steps = []
    for make, model, m in ((jengine, w[0], jobs), (tengine, w[1], obs)):
        rep = m.StepReporter(label="serve")
        eng = make(model, reporter=rep)
        for p, n in reqs:
            eng.submit(p, n)
        eng.run()
        assert rep.steps == eng.metrics.engine_steps > 0
        steps.append(rep.steps)
    assert steps[0] == steps[1]


def test_mfu_is_omitted_without_a_known_card(monkeypatch):
    assert hw.chip_peak_bf16_flops("cpu") is None
    assert hw.peak_bf16_flops_for_name("NVIDIA H100 80GB HBM3") == 989e12
    assert hw.peak_bf16_flops_for_name("NVIDIA H100 PCIe") == 756e12
    assert hw.peak_bf16_flops_for_name("TPU v5 lite") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hw.chip_peak_bf16_flops() is None
    assert obs.StepReporter().peak_flops is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert hw.chip_peak_bf16_flops() == 989e12 == obs.StepReporter().peak_flops
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some GPU")
    assert hw.chip_peak_bf16_flops(0) is None


# --------------------------------------------------------------------- #
# measured_step_flops                                                   #
# --------------------------------------------------------------------- #


def test_measured_step_flops_against_the_reference(w):
    """The tiny Llama's forward, and its forward+backward, counted on the
    meta device, against the reference's jaxpr walk of the same step.

    The forward counts are EQUAL: both price every matmul at 2·M·N·K and
    attention's two products over the full S×S square.  Forward plus
    backward differs by exactly one term: the plain attention's
    backward (the CPU and meta twin of the hand-written backward
    kernels) recomputes the score product Q·Kᵀ from Q and K instead of
    keeping the probabilities, which the reference's autodiff keeps.
    That adds 2·B·H·S²·d per layer, so the tolerance is that term,
    exactly, and nothing else."""
    params, model = w
    B, S = 2, 16
    x = np.random.RandomState(0).randint(0, 64, (B, S)).astype(np.int32)
    layers = jt.llama(JCFG)

    def jloss(ps, xx):
        h = xx
        for layer, p in zip(layers, ps):
            h, _ = layer.apply(p, {}, h, rng=None, train=True)
        logp = jax.nn.log_softmax(h)
        return -jnp.mean(jnp.take_along_axis(logp, xx[..., None], -1))

    def tfwd(m, xx):
        with torch.no_grad():
            m(xx)

    def tstep(m, xx):
        out = m(xx)
        F.cross_entropy(out.float().reshape(-1, out.shape[-1]), xx.reshape(-1)).backward()

    xt = torch.from_numpy(x).long()
    jx = jnp.asarray(x)
    assert obs.measured_step_flops(tfwd, model, xt) == jobs.measured_step_flops(jloss, params, jx)
    recompute = TCFG.n_layers * 2 * B * TCFG.n_heads * S * S * TCFG.head_dim
    got = obs.measured_step_flops(tstep, model, xt)
    want = jobs.measured_step_flops(
        lambda ps, xx: jax.value_and_grad(jloss)(ps, xx), params, jx)
    assert got == want + recompute
    half = obs.measured_step_flops(tstep, model, xt, real_token_fraction=0.5)
    assert half == got * 0.5
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert obs.measured_step_flops(lambda m: m.undefined, model) is None
    with pytest.raises(ValueError):
        obs.measured_step_flops(tfwd, model, xt, real_token_fraction=2.0)
