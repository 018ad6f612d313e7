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
