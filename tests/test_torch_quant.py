"""torchgpipe_tpu_torch.models.quant (weight-only int8) against the JAX
reference's ``models/quant.py``.

Config: the reference's ``tests/test_quant_weights.py`` float32 model
(vocab 32, dim 32, 2 blocks, 4 heads, 2 kv heads) and a GPT-2-class one
(LayerNorm, learned positions, classic MLP, tied head), weights drawn by
the reference's init and loaded with ``params_from_jax``.

Tolerances.  ``q8`` and ``sc`` must be BITWISE equal: both sides take
the float32 max, divide by 127, divide and round half to even (``jnp``'s
and ``torch``'s ``round``), so one float32 input gives one result.  The
round trip is held to the reference's bound, half a quantization step of
the channel (``|deq - w| <= sc / 2``, plus 1e-7 for the float32 product).
With equal int8 leaves both sides run the same float32 network on equal
dequantized weights, so prefill logits agree to 5e-5 absolute (as
``tests/test_torch_generation.py`` derives) and greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import quant as jq
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.serving import Engine as JEngine
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import quant as tq
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.serving import Engine

LOGIT_TOL = 5e-5
KW = dict(vocab=32, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
GPT2 = dict(vocab=32, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, norm="layernorm",
            pos_emb="learned", max_pos=32, mlp_impl="classic", act="gelu_tanh",
            attn_bias=True, attn_out_bias=True, tie_embeddings=True)


def _params(kw, seed=0):
    jcfg = jt.TransformerConfig(**kw)
    layers = [jt.token_embedding(jcfg)]
    layers += [jt.transformer_block(jcfg, name=f"b{i}") for i in range(jcfg.n_layers)]
    layers.append(jt.lm_head(jcfg))
    specs = [jax.ShapeDtypeStruct((2, 8), jnp.int32)] + \
        [jax.ShapeDtypeStruct((2, 8, jcfg.dim), jnp.float32)] * (len(layers) - 1)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(layers))
    params = [jax.tree_util.tree_map(np.asarray, layer.init(k, spec)[0])
              for layer, k, spec in zip(layers, keys, specs)]
    if jcfg.tie_embeddings:
        params[-1] = dict(params[-1], table=params[0]["table"])
    return jcfg, tt.TransformerConfig(**kw), params


@pytest.fixture(scope="module")
def llama_q():
    jcfg, tcfg, params = _params(KW)
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    jqp = jq.quantize_params_int8(jcfg, jp)
    model = params_from_jax(tcfg, params, device="cpu")
    return jcfg, tcfg, jp, jqp, model, tq.quantize_params_int8(tcfg, model)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quant_matrix_bitwise_equals_jax(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 48)) * np.linspace(0.1, 3.0, 48)).astype(np.float32)
    w[:, 5] = 0.0                     # an all-zero channel: the 1e-12 floor
    w[3, 7] = 127.5 * 0.01            # exact halves round to even
    w[:, 7] = np.where(np.arange(64) == 0, 1.27, w[:, 7])
    jw = jnp.asarray(w) if dtype is np.float32 else jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(w) if dtype is np.float32 else torch.from_numpy(w).bfloat16()
    want = jq._quant_matrix(jw)
    got = tq._quant_matrix(tw)
    assert got["q8"].dtype == torch.int8 and got["sc"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["sc"].numpy(), np.asarray(want["sc"]))
    deq = tq.dequantize_weight(got, torch.float32)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(jq.dequantize_weight(want, jnp.float32)))


def test_round_trip_error_bound():
    """Per-output-channel symmetric int8: ``|deq - w| <= sc / 2``."""
    w = torch.randn(64, 48, generator=torch.Generator().manual_seed(0)) * \
        torch.linspace(0.1, 3.0, 48)
    [q] = tq.quantize_params_int8(None, [{"wq": w}])
    assert tq.is_quantized(q["wq"]) and q["wq"]["q8"].dtype == torch.int8
    err = (tq.dequantize_weight(q["wq"], torch.float32) - w).abs()
    assert bool((err <= q["wq"]["sc"][None, :] / 2 + 1e-7).all())
    assert tq.dequantize_weight(w, torch.float32) is w


def test_quantized_leaves_and_bytes_equal_jax(llama_q):
    jcfg, tcfg, jp, jqp, model, qmodel = llama_q
    assert not tq.is_quantized(qmodel[0].params()["table"])
    blk = qmodel[1].params()
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert tq.is_quantized(blk[k]), k
        np.testing.assert_array_equal(blk[k]["q8"].numpy(), np.asarray(jqp[1][k]["q8"]))
        np.testing.assert_array_equal(blk[k]["sc"].numpy(), np.asarray(jqp[1][k]["sc"]))
    assert not tq.is_quantized(blk["ln1"])
    assert tq.is_quantized(qmodel[-1].params()["w"])
    assert tq.quantized_bytes(qmodel) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(qmodel, torch.bfloat16) == jq.quantized_bytes(jqp, jnp.bfloat16)
    qb, fb = tq.quantized_bytes(qmodel)
    assert qb < 0.30 * fb
    # The original model is untouched, and the rest is shared.
    assert "wq" in model[1]._parameters and model[1].wq.dtype == torch.float32
    assert qmodel[1].ln1 is model[1].ln1 and qmodel[0] is model[0]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_quantized_generate_equals_jax(llama_q, kv_quant):
    """Prefill logits and greedy tokens of the quantized model (and with
    an int8 KV cache as well) against the reference's on its own
    quantized params; the reference's int8 leaves loaded by ``convert``
    give the same tokens."""
    jcfg, tcfg, jp, jqp, model, qmodel = llama_q
    prompt = np.random.default_rng(1).integers(0, 32, (4, 6)).astype(np.int32)
    want_l, _ = jg.prefill(jcfg, jqp, jnp.asarray(prompt), 16)
    got_l, _ = tg.prefill(tcfg, qmodel, prompt, 16, device="cpu")
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0, atol=LOGIT_TOL)
    want = np.asarray(jg.generate(jcfg, jqp, jnp.asarray(prompt), 8, kv_quant=kv_quant))
    got = tg.generate(tcfg, qmodel, prompt, 8, kv_quant=kv_quant, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    loaded = params_from_jax(tcfg, [jax.tree_util.tree_map(np.asarray, p) for p in jqp],
                             device="cpu")
    assert isinstance(loaded[1].wq, tq.QuantWeight)
    np.testing.assert_array_equal(
        tg.generate(tcfg, loaded, prompt, 8, kv_quant=kv_quant, device="cpu").numpy(), want)


def test_classic_arch_and_tied_head_quantize_as_jax():
    """The classic schema quantizes ``w_fc``/``w_proj``; the tied head
    keeps reading the float embedding table (nothing to quantize in it)."""
    jcfg, tcfg, params = _params(GPT2)
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    jqp = jq.quantize_params_int8(jcfg, jp)
    qmodel = tq.quantize_params_int8(tcfg, params_from_jax(tcfg, params, device="cpu"))
    blk = qmodel[1].params()
    assert tq.is_quantized(blk["w_fc"]) and tq.is_quantized(blk["w_proj"])
    assert not tq.is_quantized(blk["b_fc"])
    assert not tq.is_quantized(qmodel[-1].params()["table"])
    prompt = np.random.default_rng(2).integers(0, 32, (2, 5)).astype(np.int32)
    want = np.asarray(jg.generate(jcfg, jqp, jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(tg.generate(tcfg, qmodel, prompt, 6, device="cpu").numpy(),
                                  want)


def test_speculative_and_beam_on_quantized_weights(llama_q):
    jcfg, tcfg, jp, jqp, model, qmodel = llama_q
    prompt = np.random.default_rng(3).integers(0, 32, (2, 5)).astype(np.int32)
    want = np.asarray(jg.generate(jcfg, jqp, jnp.asarray(prompt), 6))
    got = tg.speculative_generate(tcfg, qmodel, tcfg, qmodel, prompt, 6, gamma=2,
                                  device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    beams, _ = tg.beam_search(tcfg, qmodel, prompt, 6, num_beams=1, device="cpu")
    np.testing.assert_array_equal(beams.numpy(), want)


def test_engine_on_quantized_weights_equals_jax(llama_q):
    jcfg, tcfg, jp, jqp, model, qmodel = llama_q
    kw = dict(num_slots=2, max_len=24, prefill_chunk=4)
    je, te = JEngine(jcfg, jqp, **kw), Engine(tcfg, qmodel, device="cpu", **kw)
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(0, 32, (int(rng.randint(2, 8)),)).astype(np.int32), 5)
            for _ in range(3)]
    ids = [(je.submit(p, n), te.submit(p, n)) for p, n in reqs]
    je.run()
    te.run()
    for a, b in ids:
        np.testing.assert_array_equal(te.result(b), np.asarray(je.result(a)))
    te.swap_params(qmodel, 1)      # nested int8 leaves copy in place
    assert te.version == 1


def test_training_refuses_quantized_layers(llama_q):
    *_, qmodel = llama_q
    pipe = GPipe(list(qmodel), [4], devices=["cpu"])
    tokens = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="for decode only"):
        pipe.value_and_grad(tokens, tokens, lambda out, t: out.float().mean())
    with pytest.raises(ValueError, match="train first, then quantize"):
        qmodel[1](torch.zeros(1, 4, 32))
    with pytest.raises(ValueError, match="weight-only int8"):
        qmodel[-1](torch.zeros(1, 4, 32))


def test_rejects_layout_with_nothing_to_quantize():
    with pytest.raises(ValueError, match="spmd_params_for_generation"):
        tq.quantize_params_int8(None, [{"table": torch.zeros(8, 4)}])
    with pytest.raises(ValueError, match="FLAT per-layer"):
        tq.quantize_params_int8(None, [{"wq": torch.zeros(2, 8, 8)}])


def test_double_quantization_named(llama_q):
    *_, qmodel = llama_q
    with pytest.raises(ValueError, match="already weight-only int8"):
        tq.quantize_params_int8(None, qmodel)
    [q] = tq.quantize_params_int8(None, [{"wq": torch.ones(4, 4)}])
    with pytest.raises(ValueError, match="already weight-only int8"):
        tq.quantize_params_int8(None, [q])
