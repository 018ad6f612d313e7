"""QoS-tier scheduling in the port's serving Engine, against the reference.

The reference's ``tests/test_qos.py`` contracts, each run on the JAX
engine and the port's over the same trace and weights (the small float32
Llama of ``tests/test_torch_serving.py``, converted with
``params_from_jax``): tier-ordered admission, FIFO for uniform tiers,
over-budget demotion that never drops, batch-tier preemption resuming
bitwise, no interactive-for-interactive preemption, tiers through a drain
snapshot, and rejected submits minting no registry series.  Greedy
streams and first-token orders must be EQUAL (the float32 networks differ
only in summation order, ~1e-6 relative on the logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.serving import Engine as JEngine
from torchgpipe_tpu.serving import QosConfig as JQosConfig
from torchgpipe_tpu.serving import QosPolicy as JQosPolicy
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.obs import MetricsRegistry
from torchgpipe_tpu_torch.serving import Engine, QosConfig, QosPolicy
from torchgpipe_tpu_torch.serving.qos import TIERS, check_tier

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


@pytest.fixture(scope="module")
def weights():
    params, _, _ = sequential_init(
        jt.llama(JCFG), jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, 8), jnp.int32)
    )
    model = params_from_jax(TCFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def _both(weights, config=None, **kw):
    """``[(engine, policy)]`` for the reference and the port, each with
    its own QosPolicy from the same config."""
    kw.setdefault("num_slots", 1)
    kw.setdefault("max_len", 32)
    kw.setdefault("prefill_chunk", 8)
    params, model = weights
    jpol = JQosPolicy(JQosConfig(**config) if config is not None else None)
    tpol = QosPolicy(QosConfig(**config) if config is not None else None)
    return [(JEngine(JCFG, params, qos=jpol, **kw), jpol),
            (Engine(TCFG, model, qos=tpol, device="cpu", **kw), tpol)]


def _first_token_order(eng, submits, steps_between=None):
    """Submit ``submits`` (``(rid, prompt, new, kw)``), stepping
    ``steps_between[i]`` times after the i-th; run; return the order of
    first tokens and every stream."""
    order = []

    def on_token(rid, tok):
        if rid not in order:
            order.append(rid)

    for i, (rid, prompt, new, kw) in enumerate(submits):
        eng.submit(prompt, new, rid=rid, on_token=on_token, **kw)
        for _ in range((steps_between or {}).get(i, 0)):
            eng.step()
    eng.run()
    return order, {rid: (eng.status(rid), eng.result(rid).tolist()) for rid, *_ in submits}


def _ar(n, shift=0):
    return (np.arange(n, dtype=np.int32) + shift) % 64


def test_qos_config_validation():
    with pytest.raises(ValueError, match="unknown QoS tier"):
        QosConfig(demote_tier="vip")
    with pytest.raises(ValueError, match="unknown QoS tier"):
        QosConfig(preemptible_tiers=("background",))
    with pytest.raises(ValueError, match="budget must be >= 1"):
        QosConfig(tenant_budgets={"t": 0})
    with pytest.raises(ValueError, match="unknown QoS tier"):
        check_tier("premium")
    assert TIERS == ("interactive", "standard", "batch")


def test_budget_accounting_and_demotion():
    pol = QosPolicy(QosConfig(tenant_budgets={"acme": 5}))
    assert pol.spent("acme") == 0 and pol.budget("acme") == 5
    assert not pol.over_budget("acme")
    pol.spend("acme", 5)
    assert pol.over_budget("acme")
    assert pol.effective_tier("interactive", "acme") == "batch"
    assert pol.effective_tier("batch", "acme") == "batch"
    assert pol.effective_tier("interactive", "other") == "interactive"
    assert pol.effective_tier("interactive", None) == "interactive"
    before = set(pol._c_tokens.series().keys())
    assert pol.spent("never-seen") == 0
    assert set(pol._c_tokens.series().keys()) == before


def test_interactive_admits_before_earlier_batch(weights):
    """One slot, three tiers queued while it is busy: the free slot goes
    interactive -> standard -> batch (preemption off)."""
    submits = [("head", _ar(4), 3, {}), ("bg", _ar(3), 2, {"tier": "batch"}),
               ("std", _ar(3), 2, {"tier": "standard"}),
               ("ia", _ar(3), 2, {"tier": "interactive"})]
    runs = [_first_token_order(eng, submits, {0: 1})
            for eng, _ in _both(weights, dict(preemptible_tiers=()))]
    assert runs[1] == runs[0]
    assert runs[1][0] == ["head", "ia", "std", "bg"]


def test_uniform_tiers_admit_fifo(weights):
    submits = [(f"r{i}", _ar(3), 2, {}) for i in range(4)]
    runs = [_first_token_order(eng, submits) for eng, _ in _both(weights)]
    assert runs[1] == runs[0] and runs[1][0] == ["r0", "r1", "r2", "r3"]


def test_over_budget_tenant_demoted_not_dropped(weights):
    """A tenant past its budget keeps being served — its later requests
    queue behind standard traffic (batch tier)."""
    runs = []
    for eng, pol in _both(weights, dict(tenant_budgets={"acme": 2}, preemptible_tiers=())):
        first, _ = _first_token_order(eng, [("a0", _ar(4), 2, {"tenant": "acme"})])
        assert pol.spent("acme") == 2 and pol.over_budget("acme")
        order, streams = _first_token_order(
            eng, [("busy", _ar(4), 3, {}),
                  ("a1", _ar(3), 2, {"tier": "interactive", "tenant": "acme"}),
                  ("other", _ar(3), 2, {})], {0: 1})
        assert streams["a1"][0] == "finished"          # demoted, not dropped
        assert pol._c_demotions.value(tenant="acme") >= 1
        assert pol.spent("acme") == 4
        runs.append((first + order, streams))
    assert runs[1] == runs[0] and runs[1][0] == ["a0", "busy", "other", "a1"]


def test_submit_rejects_unknown_tier(weights):
    for eng, _ in _both(weights):
        with pytest.raises(ValueError, match="unknown QoS tier"):
            eng.submit(_ar(3), 2, tier="premium")
        assert eng.scheduler.idle


def test_preempted_batch_stream_resumes_bitwise(weights):
    """Interactive pressure evicts the batch stream mid-decode; the
    resumed stream is bitwise the reference's (and the unpreempted one)."""
    runs = []
    for eng, pol in _both(weights):
        rb = eng.submit(_ar(4), 6, tier="batch", tenant="bg")
        for _ in range(3):
            eng.step()
        ri = eng.submit(_ar(4, 7), 4, tier="interactive", tenant="fg")
        eng.run()
        assert int(pol._c_preemptions.value()) == 1
        assert pol.spent("bg") == 6 and pol.spent("fg") == 4
        assert eng.metrics.requests[rb].status == "finished"
        runs.append((eng.result(rb).tolist(), eng.result(ri).tolist()))
    eng, _ = _both(weights)[1]
    eng.submit(_ar(4), 6)
    eng.run()
    assert runs[1] == runs[0] and runs[1][0] == eng.result("r1").tolist()


def test_interactive_never_preempted_for_interactive(weights):
    for eng, pol in _both(weights):
        r0 = eng.submit(_ar(4), 4, tier="interactive")
        for _ in range(2):
            eng.step()
        r1 = eng.submit(_ar(3), 2, tier="interactive")
        eng.run()
        assert int(pol._c_preemptions.value()) == 0
        assert eng.status(r0) == eng.status(r1) == "finished"


def test_tier_survives_drain_snapshot(weights):
    """drain()/restore_requests round-trips tier and tenant (and a
    snapshot without them restores to the defaults)."""
    for eng, _ in _both(weights, num_slots=2):
        eng.submit(_ar(4), 4, rid="a", tier="batch", tenant="bg")
        eng.step()
        snap = eng.drain()
        kwargs = {kw["rid"]: kw for kw in type(eng).restore_requests(snap)}
        assert kwargs["a"]["tier"] == "batch" and kwargs["a"]["tenant"] == "bg"
        for meta in snap["requests"].values():
            meta.pop("tier"), meta.pop("tenant")
        kwargs = {kw["rid"]: kw for kw in type(eng).restore_requests(snap)}
        assert kwargs["a"]["tier"] == "standard" and kwargs["a"]["tenant"] is None


def test_rejected_submits_mint_no_series(weights):
    """A REJECTED submit carrying tier/tenant labels leaves every series
    of a shared registry exactly as it was."""
    shared = MetricsRegistry()
    pol = QosPolicy(QosConfig(tenant_budgets={"acme": 10}), registry=shared)
    eng = Engine(TCFG, weights[1], num_slots=2, max_len=32, prefill_chunk=8, qos=pol,
                 registry=shared.labeled(replica="r0"), device="cpu")
    eng.submit(_ar(3), 2, tier="interactive", tenant="acme")
    assert eng.run() == "idle"
    before = {m.name: set(m.series()) for m in shared.metrics()}
    with pytest.raises(ValueError):
        eng.submit(_ar(30), 30, tier="interactive", tenant="acme")
    with pytest.raises(ValueError):
        eng.submit(_ar(3), 2, tier="premium", tenant="acme")
    assert not eng.step()
    assert {m.name: set(m.series()) for m in shared.metrics()} == before
    assert pol.spent("acme") == 2
