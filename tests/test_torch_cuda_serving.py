"""The serving Engine's CUDA graphs against its eager bodies, on the card.

Needs an NVIDIA GPU; every test skips without one.  This file imports
neither JAX nor the JAX package (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_serving.py

A small bf16 Llama (vocab 256, dim 256, 2 layers, 4 heads, 2 kv heads,
head dim 64), random from a seed.  A replayed graph runs the same kernels
on the same inputs as the eager body, so tokens AND cache bytes must be
bitwise equal; any difference is a fault, not rounding.
"""

import numpy as np
import pytest
import torch

from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.serving import Engine

CFG = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                           dtype=torch.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the engine's programs are CUDA graphs there)")
    return torch.device("cuda")


def _model(seed):
    return tt.llama(CFG, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))


def _trace(seed, n, plen_hi=40, new_hi=12):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, CFG.vocab, (int(rng.randint(1, plen_hi)),)).astype(np.int32),
             int(rng.randint(1, new_hi))) for _ in range(n)]


def _serve(eng, reqs, steps_between=1, cancel=None):
    rids = []
    for i, (p, n) in enumerate(reqs):
        rids.append(eng.submit(p, n))
        if cancel is not None and i == cancel:
            eng.cancel(rids[-1])
        for _ in range(steps_between):
            eng.step()
    eng.run()
    return {r: (eng.status(r), eng.result(r).tolist()) for r in rids}


def _pool_bytes(eng):
    c = eng.pool.cache
    return [t for name in ("k", "v", "k_scale", "v_scale") for t in getattr(c, name, [])]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_graph_replay_bitwise_equals_eager_body(cuda_device, kv_quant):
    """Prefill (every bucket of the ladder) and decode: the captured
    engine and the eager one give equal tokens and equal cache bytes, and
    the graph engine captured each program exactly once under churn."""
    model = _model(0)
    reqs = _trace(1, 10)
    kw = dict(num_slots=4, max_len=64, prefill_chunk=(4, 16), kv_quant=kv_quant)
    graph = Engine(CFG, model, **kw)
    eager = Engine(CFG, model, cuda_graph=False, **kw)
    got, want = _serve(graph, reqs, cancel=3), _serve(eager, reqs, cancel=3)
    assert got == want
    short = [(np.arange(3, dtype=np.int32), 4)]     # served alone: the 4-token bucket
    assert _serve(graph, short) == _serve(eager, short)
    for a, b in zip(_pool_bytes(graph), _pool_bytes(eager)):
        assert torch.equal(a, b)
    assert graph.compile_stats == {"prefill@4": 1, "prefill@16": 1, "decode": 1}
    assert all(p.graph is not None for p in graph._programs.values())
    assert all(p.graph is None for p in eager._programs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["moe_dropless", "moe_sparse", "int8_weights"])
def test_moe_and_int8_weight_replays_bitwise_equal_eager(cuda_device, kind):
    """A dropless MoE model (grouped products over device offsets, no host
    read), a capacity MoE model and an int8-weight model serve as captured
    graphs whose tokens and cache bytes equal the eager bodies'."""
    from torchgpipe_tpu_torch.models import moe as tm
    from torchgpipe_tpu_torch.models.quant import quantize_params_int8

    kw = dict(num_slots=4, max_len=64, prefill_chunk=(4, 16))
    gen = torch.Generator("cuda").manual_seed(0)
    if kind == "int8_weights":
        model = quantize_params_int8(CFG, _model(0))
    else:
        kw["moe"] = tm.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0,
                                 dispatch=kind.split("_")[1])
        model = tm.llama_moe(CFG, kw["moe"], device="cuda", generator=gen)
    reqs = _trace(6, 8)
    graph = Engine(CFG, model, **kw)
    eager = Engine(CFG, model, cuda_graph=False, **kw)
    assert _serve(graph, reqs) == _serve(eager, reqs)
    for a, b in zip(_pool_bytes(graph), _pool_bytes(eager)):
        assert torch.equal(a, b)
    # One capture per program the trace used: the eager engine's first runs.
    assert graph.compile_stats == eager.compile_stats
    assert set(graph.compile_stats.values()) <= {0, 1} and graph.compile_stats["decode"] == 1


@pytest.mark.cuda
def test_one_capture_per_program_under_churn(cuda_device):
    model = _model(0)
    eng = Engine(CFG, model, num_slots=3, max_len=64, prefill_chunk=8)
    first = _serve(eng, _trace(2, 6))
    stats = eng.compile_stats
    assert stats == {"prefill": 1, "decode": 1}
    rng = np.random.RandomState(3)
    for _ in range(3):
        _serve(eng, _trace(int(rng.randint(100)), 5), steps_between=int(rng.randint(3)))
    assert eng.compile_stats == stats
    assert all(s == "finished" for s, _ in first.values())
    eng.pool.check_refcounts()


@pytest.mark.cuda
def test_replay_after_swap_params_reads_new_weights(cuda_device):
    reqs = _trace(4, 6)
    eng = Engine(CFG, _model(0), num_slots=3, max_len=64, prefill_chunk=8)
    old = _serve(eng, reqs)
    stats = eng.compile_stats
    new_model = _model(1)
    eng.swap_params(new_model, version=1)
    got = _serve(eng, reqs)
    fresh = Engine(CFG, new_model, num_slots=3, max_len=64, prefill_chunk=8)
    assert list(got.values()) == list(_serve(fresh, reqs).values())
    assert list(got.values()) != list(old.values())
    assert eng.compile_stats == stats


@pytest.mark.cuda
def test_sampled_replay_equals_eager_from_equal_generator_states(cuda_device):
    model = _model(0)
    reqs = _trace(5, 6)
    runs = []
    for cuda_graph in (True, False):
        gen = torch.Generator("cuda").manual_seed(7)
        eng = Engine(CFG, model, num_slots=3, max_len=64, prefill_chunk=8, temperature=0.9,
                     top_k=50, top_p=0.95, generator=gen, cuda_graph=cuda_graph)
        runs.append((_serve(eng, reqs), gen.get_state()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])     # the replays advanced it alike


def _fleet_serve(make, reqs):
    """A two-replica router over ``make(name)`` engines, r0 dying at its
    step 3; returns the streams and the engines."""
    from torchgpipe_tpu_torch import fleet
    from torchgpipe_tpu_torch.resilience import faults

    router = fleet.Router({n: make(n) for n in ("r0", "r1")}, seed=1)
    with faults.inject(die_at_step=(0, 3)):
        rids = [router.submit(p, n) for p, n in reqs]
        assert router.run() == "idle"
    return [router.result(r).tolist() for r in rids], router


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefix_copy_and_migrate_ingest_replays_bitwise_equal_eager(cuda_device, kv_quant):
    """The fleet's two row-copy programs, captured with ``src``/``dst``/
    ``n`` in a device tensor: a prefix-cached engine and a prefill/decode
    pair give the eager bodies' tokens and cache bytes, each program
    captured once and replayed for every reuse and every migration."""
    from torchgpipe_tpu_torch import fleet

    model = _model(0)
    prefix = np.arange(20, dtype=np.int32) % CFG.vocab
    rng = np.random.RandomState(8)
    reqs = [(np.concatenate([prefix, rng.randint(0, CFG.vocab, (int(rng.randint(1, 9)),))
                             .astype(np.int32)]), int(rng.randint(2, 9))) for _ in range(8)]
    runs = []
    for cuda_graph in (True, False):
        kw = dict(num_slots=4, max_len=64, prefill_chunk=(4, 16), kv_quant=kv_quant,
                  cuda_graph=cuda_graph)
        pc = fleet.RadixPrefixCache(min_prefix_len=4)
        eng = Engine(CFG, model, prefix_cache=pc, **kw)
        first = _serve(eng, reqs[:1])
        out = [first, _serve(eng, reqs[1:], steps_between=2), pc.stats()]
        P = Engine(CFG, model, role="prefill", **kw)
        D = Engine(CFG, model, role="decode", **kw)
        router = fleet.Router({"p0": P, "d0": D})
        rids = [router.submit(p, n) for p, n in reqs]
        assert router.run() == "idle"
        out.append([router.result(r).tolist() for r in rids])
        runs.append((out, _pool_bytes(eng) + _pool_bytes(D), eng, P, D))
    (got, gbytes, geng, gP, gD), (want, wbytes, *_) = runs
    assert got == want and got[2]["hits"] > 0
    for a, b in zip(gbytes, wbytes):
        assert torch.equal(a, b)
    assert geng.compile_stats["prefix_copy"] == 1 and gD.compile_stats == {
        "decode": 1, "migrate_ingest": 1}
    assert geng._programs["prefix_copy"].graph is not None
    assert gD._programs["migrate_ingest"].graph is not None


@pytest.mark.cuda
def test_replicas_share_weights_but_not_graph_pools(cuda_device):
    """Two replicas on one model: one copy of the weights, a graph pool
    each; r0 dies mid-trace and r1's replays go on, every stream the
    eager fleet's."""
    model = _model(0)
    reqs = _trace(9, 8)
    kw = dict(num_slots=3, max_len=64, prefill_chunk=(4, 16))
    got, router = _fleet_serve(lambda n: Engine(CFG, model, **kw), reqs)
    want, _ = _fleet_serve(lambda n: Engine(CFG, model, cuda_graph=False, **kw), reqs)
    assert got == want
    e0, e1 = (router.replicas[n].engine for n in ("r0", "r1"))
    assert e0.weights_key() == e1.weights_key()
    assert e0._graph_pool is not None and e1._graph_pool is not None
    assert e0._graph_pool != e1._graph_pool
    assert e1.compile_stats["decode"] == 1


@pytest.mark.cuda
def test_speculative_engine_replays_equal_eager(cuda_device):
    from torchgpipe_tpu_torch import fleet

    draft_cfg = tt.TransformerConfig(vocab=256, dim=128, n_layers=1, n_heads=2,
                                     n_kv_heads=1, dtype=torch.bfloat16)
    model = _model(0)
    draft = tt.llama(draft_cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    reqs = _trace(10, 6, plen_hi=30)
    kw = dict(gamma=3, num_slots=3, max_len=64, prefill_chunk=(4, 16))
    graph = fleet.SpeculativeEngine(CFG, model, draft_cfg, draft, **kw)
    eager = fleet.SpeculativeEngine(CFG, model, draft_cfg, draft, cuda_graph=False, **kw)
    got = _serve(graph, reqs)
    assert got == _serve(eager, reqs)
    assert set(graph.compile_stats.values()) <= {0, 1}
    assert graph.compile_stats == eager.compile_stats
    assert graph.program_count == 3 + 3


@pytest.mark.cuda
def test_capture_failure_raises_instead_of_running_eagerly(cuda_device, monkeypatch):
    """A body that synchronises with the host cannot be captured: the
    step raises, nothing is counted, and no token is emitted."""
    real = tg._scatter_rows

    def syncing(cache, i, k, v, lengths, n_valid):
        int(lengths.max())               # a host sync: illegal inside a capture
        return real(cache, i, k, v, lengths, n_valid)

    monkeypatch.setattr(tg, "_scatter_rows", syncing)
    eng = Engine(CFG, _model(0), num_slots=2, max_len=32, prefill_chunk=8)
    rid = eng.submit(np.arange(5, dtype=np.int32), 3)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.compile_stats == {"prefill": 0, "decode": 0}
    assert eng.result(rid).size == 0
    assert all(p.graph is None for p in eng._programs.values())
