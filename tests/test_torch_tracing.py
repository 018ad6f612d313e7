"""The tracer (``utils.tracing``) of torchgpipe_tpu_torch against the
JAX reference.

The same schedule recorded by both packages' ``Timeline`` (a float32
Llama of 2 blocks, 4 layers, cut [2, 2], 3 micro-batches) gives the
same sequence of (phase, stage, micro-batch) cells, in the same order:
fill-drain under each checkpoint mode, 1F1B, and the no-grad ``apply``.
``simulate_pipeline`` is plain float arithmetic over the events' own
durations, so on the same events it equals the reference's to 1e-12
relative (the two sum the cells in the same order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.utils import tracing as jtr
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.utils import tracing as ttr

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
BALANCE, CHUNKS = [2, 2], 3


@pytest.fixture(scope="module")
def weights():
    params, _, _ = sequential_init(jt.llama(JCFG), jax.random.PRNGKey(0),
                                   jax.ShapeDtypeStruct((6, 8), jnp.int32))
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (6, 8)).astype(np.int32)
    return [jax.tree_util.tree_map(np.asarray, p) for p in params], tokens


def _jloss(out, tok):
    return jt.cross_entropy(out[:, :-1], tok[:, 1:])


def _tloss(out, tok):
    return tt.cross_entropy(out[:, :-1], tok[:, 1:])


def _cells(timeline):
    return [(e.name, e.stage, e.mbatch) for e in timeline.events]


@pytest.mark.parametrize("kw", [{"checkpoint": "never"}, {"checkpoint": "except_last"},
                                {"checkpoint": "always"}, {"checkpoint": "offload"},
                                {"schedule": "1f1b", "loss_reduction": "mean"}])
def test_timeline_cells_match_jax(weights, kw):
    params, tokens = weights
    jtl, ttl = jtr.Timeline(), ttr.Timeline()
    jpipe = JGPipe(jt.llama(JCFG), BALANCE, chunks=CHUNKS, tracer=jtl, **kw)
    jp = jpipe.place((params[:2], params[2:]))
    jst = jpipe.place(([(), ()], [(), ()]))
    jpipe.value_and_grad(jp, jst, jnp.asarray(tokens), jnp.asarray(tokens), _jloss)
    pipe = GPipe(list(params_from_jax(TCFG, params, device="cpu")), BALANCE,
                 devices=["cpu"], chunks=CHUNKS, tracer=ttl, **kw)
    t = torch.from_numpy(tokens).long()
    pipe.value_and_grad(t, t, _tloss)
    assert _cells(ttl) == _cells(jtl)
    assert {s: len(e) for s, e in ttl.by_stage().items()} == \
        {s: len(e) for s, e in jtl.by_stage().items()}
    assert all(e.t_end >= e.t_start >= 0 for e in ttl.events)
    # The no-grad forward records one fwd cell per (micro-batch, stage).
    jtl.reset()
    ttl.reset()
    jpipe.apply(jp, jst, jnp.asarray(tokens))
    pipe.apply(t)
    assert _cells(ttl) == _cells(jtl) and ttl.events


def test_sync_timeline_serializes_cells_and_writes_a_trace(weights, tmp_path):
    """``sync=True`` spans do not overlap (each waits for its cell);
    the summary and the Chrome trace cover every cell."""
    params, tokens = weights
    tl = ttr.Timeline(sync=True)
    pipe = GPipe(list(params_from_jax(TCFG, params, device="cpu")), BALANCE,
                 devices=["cpu"], chunks=CHUNKS, tracer=tl)
    t = torch.from_numpy(tokens).long()
    pipe.value_and_grad(t, t, _tloss)
    ev = sorted(tl.events, key=lambda e: e.t_start)
    assert all(a.t_end <= b.t_start + 1e-9 for a, b in zip(ev, ev[1:]))
    assert tl.summary().startswith(f"timeline: {len(tl.events)} cells") and \
        "sync/serialized" in tl.summary()
    path = tmp_path / "trace.json"
    tl.to_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    assert sum(e["ph"] == "X" for e in trace) == len(tl.events)
    assert ttr.Timeline().summary() == jtr.Timeline().summary()
    with ttr.device_trace(str(tmp_path / "prof")):
        pipe.apply(t)
    assert (tmp_path / "prof" / "trace.json").exists()


def _events(module, cells):
    return [module.TimelineEvent(n, j, i, t0, t1) for n, j, i, t0, t1 in cells]


@pytest.mark.parametrize("m, n", [(4, 2), (8, 3), (3, 4)])
def test_simulate_pipeline_matches_jax(m, n):
    """Measured-looking cells (uneven stages, each cell observed twice,
    a loss barrier at micro-batch -1) projected by both packages."""
    rng = np.random.default_rng(m * 10 + n)
    cells, t = [], 0.0
    for _ in range(2):
        for name in ("fwd", "bwd"):
            for i in range(m):
                for j in range(n):
                    d = float(rng.uniform(0.5, 1.5)) * (1.0 + j)
                    cells.append((name, j, i, t, t + d))
                    t += d
        cells.append(("loss", n - 1, -1, t, t + 0.3))
        t += 0.3
    got = ttr.simulate_pipeline(_events(ttr, cells), n)
    want = jtr.simulate_pipeline(_events(jtr, cells), n)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    uniform = [(nm, j, i, 0.0, 1.0) for nm in ("fwd", "bwd") for i in range(m)
               for j in range(n)]
    _, _, bubble = ttr.simulate_pipeline(_events(ttr, uniform), n)
    assert bubble == pytest.approx((n - 1) / (m + n - 1))
    assert ttr.simulate_pipeline([], n) is None is jtr.simulate_pipeline([], n)


def test_simulate_pipeline_refusals():
    ev = _events(ttr, [("fwd", 0, 0, 0.0, 1.0)])
    with pytest.raises(ValueError) as je:
        jtr.simulate_pipeline(_events(jtr, [("fwd", 0, 0, 0.0, 1.0)]), 1, "gpipe")
    with pytest.raises(ValueError) as te:
        ttr.simulate_pipeline(ev, 1, "gpipe")
    assert str(te.value) == str(je.value)
    for schedule, n, v in (("1f1b", 2, 2), ("interleaved", 2, 1), ("interleaved", 3, 2)):
        with pytest.raises(ValueError) as je:
            jtr.simulate_pipeline(_events(jtr, [("fwd", 0, 0, 0.0, 1.0)]), n, schedule, v)
        with pytest.raises(ValueError) as te:
            ttr.simulate_pipeline(ev, n, schedule, v)
        assert str(te.value) == str(je.value)


def test_fused_tracer_refusal_text():
    with pytest.raises(ValueError) as je:
        JGPipe(jt.llama(JCFG), [4], devices=[jax.devices()[0]], fused=True,
               tracer=jtr.Timeline())
    with pytest.raises(ValueError) as te:
        GPipe([torch.nn.Linear(2, 2)], [1], devices=["cpu"], fused=True,
              tracer=ttr.Timeline())
    assert str(te.value) == str(je.value)
