"""The port's int8 KV cache against the JAX reference.

``_quant_rows`` must be bitwise the reference's (the same float32 ops in
the same order).  The int8 decode read is held against the reference's
Pallas decode kernel in interpret mode on identical int8/scale inputs at
the reference test's own tolerance, 2e-5 (``tests/test_flash_attention.py``
``test_decode_kernel_quant_matches_dense_dequant``): both dequantize in
float32 and sum over at most 512 keys in another order.

Models: the tiny float32 Llama of ``tests/test_torch_generation.py``
(dim 256, 2 heads, 1 kv head, head dim 128, 2 layers, vocab 512) and a
GQA one (dim 128, 4 heads, 2 kv heads, head dim 32), initialised by the
reference and converted with ``params_from_jax``.  LOGIT_TOL is that
file's: the same float32 network summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.ops import flash_attention as jfa
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import flash_attention as tfa

LOGIT_TOL = 5e-5
DECODE_TOL = 2e-5


def _model(seed=0, **kw):
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    params, _, _ = sequential_init(
        jt.llama(jcfg), jax.random.PRNGKey(seed), jax.ShapeDtypeStruct((1, 8), jnp.int32)
    )
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def tiny():
    return _model(vocab=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1)


@pytest.fixture(scope="module")
def gqa():
    return _model(vocab=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2)


def _prompt(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize(
    "shape,scale,zero_row",
    [((2, 7, 3, 128), 1.0, False), ((4, 5, 2, 64), 30.0, True), ((3, 1, 8, 16), 1e-3, False)],
)
def test_quant_rows_bitwise_equals_jax(shape, scale, zero_row):
    rows = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * scale
    if zero_row:
        rows[0, 0, 0] = 0.0   # amax 0: the 1e-8 floor
    jq, js = jg._quant_rows(jnp.asarray(rows))
    q, s = tg._quant_rows(torch.from_numpy(rows))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quant_rows_bitwise_equals_jax_on_bfloat16_rows():
    rows = np.random.default_rng(2).standard_normal((2, 9, 2, 128)).astype(np.float32)
    jrows = jnp.asarray(rows).astype(jnp.bfloat16)
    trows = torch.from_numpy(rows).bfloat16()
    jq, js = jg._quant_rows(jrows)
    q, s = tg._quant_rows(trows)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_dequant_rows_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (2, 6, 3, 32)).astype(np.int8)
    sc = rng.random((2, 3, 6)).astype(np.float32)
    ref = jg._dequant_rows(jnp.asarray(q), jnp.asarray(sc))
    out = tg._dequant_rows(torch.from_numpy(q), torch.from_numpy(sc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "g,pos0,window,r",
    [(1, 100, None, 2), (4, 200, 64, 2), (1, 511, None, 2),
     (5, 300, None, 4)],   # 5 queries x 4 heads = 20 rows per kv head
)
def test_int8_decode_matches_jax_kernel(g, pos0, window, r):
    b, S, nkv, hd = 2, 512, 2, 128
    nh = nkv * r
    rng = np.random.default_rng(pos0 + g)
    q = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    kf = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    vf = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    ck, cks = (np.array(a) for a in jg._quant_rows(jnp.asarray(kf)))
    cv, cvs = (np.array(a) for a in jg._quant_rows(jnp.asarray(vf)))
    cks, cvs = np.ascontiguousarray(cks.transpose(0, 2, 1)), np.ascontiguousarray(
        cvs.transpose(0, 2, 1))
    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos0),
        window=window, k_scale=jnp.asarray(cks), v_scale=jnp.asarray(cvs),
        interpret=True,
    )
    before = (tfa.flash_decode_attention.launches,
              tfa.flash_decode_attention.launches_int8)
    out = tfa.flash_decode_attention(
        *(torch.from_numpy(a) for a in (q, ck, cv)), pos0, window=window,
        k_scale=torch.from_numpy(cks), v_scale=torch.from_numpy(cvs),
    )
    assert out.dtype == torch.float32 and out.shape == (b, g, nh * hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DECODE_TOL, rtol=DECODE_TOL)
    # CPU tensors run the plain version: no launch is counted.
    assert (tfa.flash_decode_attention.launches,
            tfa.flash_decode_attention.launches_int8) == before


def test_int8_decode_refusals_on_any_device():
    q = torch.zeros(1, 1, 4, 64)
    c8 = torch.zeros(1, 16, 2, 64, dtype=torch.int8)
    sc = torch.ones(1, 2, 16)
    with pytest.raises(ValueError, match="pass both k_scale and v_scale, or neither"):
        tfa.flash_decode_attention(q, c8, c8, 3, k_scale=sc)
    with pytest.raises(ValueError, match="v_scale must be float32"):
        tfa.flash_decode_attention(q, c8, c8, 3, k_scale=sc, v_scale=sc[:, :, :8])
    with pytest.raises(ValueError, match="k_scale must be float32"):
        tfa.flash_decode_attention(q, c8, c8, 3, k_scale=sc.double(), v_scale=sc)
    with pytest.raises(TypeError, match="int8 cache"):
        tfa.flash_decode_attention(q, c8.float(), c8.float(), 3, k_scale=sc, v_scale=sc)
    with pytest.raises(TypeError, match="int8 cache"):
        tfa.flash_decode_attention(q, c8, c8, 3)


def test_prefill_kv_quant_matches_jax(tiny):
    """Prefill attention stays float32; only the banked rows are int8.
    Logits within LOGIT_TOL.  The int8 cache may differ from the
    reference's by one unit where K/V, computed in another summation
    order (~1e-7 relative), sit on a rounding edge of ``x / scale``: the
    chance per entry is about that relative error times |x|/scale <= 127,
    ~1e-5, so at most 0.1% of entries may differ, none by more than 1."""
    jcfg, tcfg, params, model = tiny
    prompt = _prompt(2, 96, 512)
    ref, jc = jg.prefill(jcfg, params, jnp.asarray(prompt), 128, kv_quant=True,
                         use_flash=True)
    out, cache = tg.prefill(tcfg, model, prompt, 128, kv_quant=True, device="cpu")
    assert isinstance(cache, tg.QuantKVCache) and cache.length == 96
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=0)
    for mine, theirs in ((cache.k, jc.k), (cache.v, jc.v)):
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.int8 and a.shape == b.shape
            d = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for mine, theirs in ((cache.k_scale, jc.k_scale), (cache.v_scale, jc.v_scale)):
        for a, b in zip(mine, theirs):
            assert tuple(a.shape) == (2, 1, 128)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=0)


@pytest.mark.parametrize("fixture,new", [("tiny", 24), ("gqa", 16)])
def test_greedy_generate_kv_quant_equals_jax(request, fixture, new):
    jcfg, tcfg, params, model = request.getfixturevalue(fixture)
    prompt = _prompt(2, 40, jcfg.vocab, seed=5)
    ref = np.asarray(jg.generate(jcfg, params, jnp.asarray(prompt), new, kv_quant=True))
    out, cache = tg.generate(tcfg, model, prompt, new, kv_quant=True, return_state=True,
                             device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    assert isinstance(cache, tg.QuantKVCache) and cache.length == 40 + new


def test_decode_chunk_quant_equals_sequential_steps(gqa):
    """The chunked int8 read (speculative verification's primitive) and
    g single-token steps write the same int8 rows and give the same
    hidden states (the reference's ``test_decode_chunk_matches_sequential_steps``
    for the port)."""
    _, tcfg, _, model = gqa
    embed_p, block_p, _ = tg._split_params(tcfg, model)
    prompt = _prompt(2, 12, tcfg.vocab, seed=6)
    toks = torch.from_numpy(_prompt(2, 5, tcfg.vocab, seed=7)).long()
    with torch.inference_mode():
        _, c1 = tg.prefill(tcfg, model, prompt, 20, kv_quant=True, device="cpu")
        _, c2 = tg.prefill(tcfg, model, prompt, 20, kv_quant=True, device="cpu")
        xc, _ = tg._decode_chunk(tcfg, block_p, tg._embed(tcfg, embed_p, toks), c1)
        xs = []
        for j in range(5):
            x, _ = tg._decode_step(tcfg, block_p, tg._embed(tcfg, embed_p, toks[:, j:j + 1]), c2)
            xs.append(x)
    np.testing.assert_allclose(xc.numpy(), torch.cat(xs, 1).numpy(), atol=1e-5, rtol=0)
    assert c1.length == c2.length == 17
    for a, b in zip(c1.k + c1.v, c2.k + c2.v):
        d = (a.int() - b.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


@pytest.mark.parametrize(
    "g,pos0,window,hd,qdtype",
    [(1, 300, None, 128, torch.bfloat16), (5, 250, 64, 64, torch.float32),
     (2, 0, None, 64, torch.bfloat16)],
)
def test_int8_decode_tensor_pos0_equals_int_and_jax(g, pos0, window, hd, qdtype):
    """An int8 cache with pos0 as a 0-d int32 tensor: the host int's bits,
    and the reference kernel's output for ``jnp.asarray(pos0, jnp.int32)``
    within the int8 read's tolerance."""
    b, S, nkv, r = 2, 512, 2, 4
    rng = np.random.default_rng(11 + g)
    q = rng.standard_normal((b, g, nkv * r, hd)).astype(np.float32)
    tq = torch.from_numpy(q).to(qdtype)
    ck, cks = (np.array(a) for a in jg._quant_rows(
        jnp.asarray(rng.standard_normal((b, S, nkv, hd)).astype(np.float32))))
    cv, cvs = (np.array(a) for a in jg._quant_rows(
        jnp.asarray(rng.standard_normal((b, S, nkv, hd)).astype(np.float32))))
    cks, cvs = (np.ascontiguousarray(a.transpose(0, 2, 1)) for a in (cks, cvs))
    ref = jfa.flash_decode_attention(
        jnp.asarray(tq.float().numpy()), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos0, jnp.int32), window=window, k_scale=jnp.asarray(cks),
        v_scale=jnp.asarray(cvs), interpret=True,
    )
    kw = dict(window=window, k_scale=torch.from_numpy(cks), v_scale=torch.from_numpy(cvs))
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    host = tfa.flash_decode_attention(tq, tk, tv, pos0, **kw)
    dev = tfa.flash_decode_attention(tq, tk, tv, torch.tensor(pos0, dtype=torch.int32), **kw)
    assert torch.equal(host, dev)
    np.testing.assert_allclose(dev.numpy(), np.asarray(ref), atol=DECODE_TOL, rtol=DECODE_TOL)
