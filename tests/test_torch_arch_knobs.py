"""The GPT-2/BERT architecture knobs of models.transformer against the
JAX reference: learned positions (``pos_emb='learned'``, ``max_pos``,
``pos_emb_offset``), the embedding LayerNorm (``embed_layernorm``),
post-norm blocks (``norm_position='post'``) and tied embeddings
(``tie_embeddings``), with ``generate`` and the serving ``Engine``
reading the tied head and the per-row position rows.

Configs: a GPT-2-class decoder (LayerNorm, learned positions, classic
gelu_tanh MLP, biases on every projection, tied head) and a BERT-class
encoder (post-norm, embedding LayerNorm, bidirectional attention), at
vocab 128, dim 64, 4 heads, 2 blocks, float32, drawn by the reference's
init and loaded through ``convert.params_from_jax``.

Tolerances.  One float32 network in another summation order (products
over 64-256 terms, softmax over <= 40 keys, LayerNorm over 64): ~1e-7
relative per op, through 2 blocks and up to 6 LayerNorms.  Logits to
1e-5 of their max, loss to 1e-5 relative, each gradient leaf to 1e-4 of
its max |value| with a scale of at least 1e-3 of the largest leaf's max
(the key bias ``bk`` takes a gradient that is 0 in exact arithmetic:
the softmax cancels a constant shift of each query's scores).  Greedy
tokens must be equal: the two paths' logits differ by ~1e-6, and this
seed's top-two gaps are far larger.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.serving import Engine
from tests.torch_parity import assert_trees_close, flat, grad_of, per_stage, ref_tree

OUT_REL_TOL, LOSS_RTOL, GRAD_REL_TOL, ZERO_FLOOR = 1e-5, 1e-5, 1e-4, 1e-3
GPT2 = dict(vocab=128, dim=64, n_layers=2, n_heads=4, norm="layernorm",
            pos_emb="learned", max_pos=40, mlp_impl="classic", act="gelu_tanh",
            attn_bias=True, attn_out_bias=True, tie_embeddings=True)
BERT = dict(vocab=128, dim=64, n_layers=2, n_heads=4, norm="layernorm",
            pos_emb="learned", max_pos=40, mlp_impl="classic", act="gelu",
            attn_bias=True, attn_out_bias=True, causal=False, norm_position="post",
            embed_layernorm=True)


def _cfgs(**kw):
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _jax_params(jcfg, seed=0):
    """The reference's per-layer params (a tied head's dict spliced with
    the embedding's table, as its importers and extractors hand it to
    decode), as numpy trees."""
    layers = [jt.token_embedding(jcfg)]
    layers += [jt.transformer_block(jcfg, name=f"block{i}") for i in range(jcfg.n_layers)]
    layers.append(jt.lm_head(jcfg))
    # Layer by layer: the tied head cannot run in sequential_init's shape
    # pass, as no splice has happened there.
    specs = [jax.ShapeDtypeStruct((2, 8), jnp.int32)] + \
        [jax.ShapeDtypeStruct((2, 8, jcfg.dim), jcfg.dtype)] * (len(layers) - 1)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(layers))
    params = [jax.tree_util.tree_map(np.asarray, layer.init(k, spec)[0])
              for layer, k, spec in zip(layers, keys, specs)]
    if jcfg.tie_embeddings:
        params[-1] = dict(params[-1], table=params[0]["table"])
    return layers, params


def _prompts(b=3, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


@pytest.mark.parametrize("offset", [0, 2])
def test_gpt2_class_generate_matches_jax(offset):
    jcfg, tcfg = _cfgs(**GPT2, pos_emb_offset=offset)
    _, params = _jax_params(jcfg)
    model = params_from_jax(tcfg, params, device="cpu")
    head = model[-1]
    assert "w" not in head.params() and head.table is model[0].table
    assert len(list(model.parameters())) == len({id(p) for p in model.parameters()})
    prompt = _prompts()
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    L = 40 - offset   # the table's rows past the reserved ones
    ref_logits, _ = jg.prefill(jcfg, jparams, jnp.asarray(prompt), L)
    logits, _ = tg.prefill(tcfg, model, prompt, L, device="cpu")
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=0,
                               atol=OUT_REL_TOL * np.abs(ref_logits).max())
    n = L - 12
    ref = np.array(jg.generate(jcfg, jparams, jnp.asarray(prompt), n))
    out = tg.generate(tcfg, model, prompt, n, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    # The head given no table (the reference's unspliced tied head) reads
    # the embedding's: the same tokens.
    untied_head = dict(params[-1])
    del untied_head["table"]
    model2 = params_from_jax(tcfg, params[:-1] + [untied_head], device="cpu")
    assert torch.equal(tg.generate(tcfg, model2, prompt, 4, device="cpu"), out[:, :4])
    # Continuation and beam search read the rows at the cache's length.
    # A continuation absorbing ref's token 5 goes on with ref's 6, 7, 8.
    first, cache = tg.generate(tcfg, model, prompt, 5, return_state=True, max_len=L,
                               device="cpu")
    nxt = tg.generate(tcfg, model, ref[:, 5:6], 3, cache=cache, device="cpu")
    np.testing.assert_array_equal(first.numpy(), ref[:, :5])
    np.testing.assert_array_equal(nxt.numpy(), ref[:, 6:9])
    beams, _ = tg.beam_search(tcfg, model, prompt, 6, num_beams=1, device="cpu")
    np.testing.assert_array_equal(beams.numpy(), ref[:, :6])


def test_gpt2_class_engine_streams_match_jax_generate():
    """The serving Engine on the tied, learned-position model: prompts of
    several lengths at per-slot frontiers (the learned rows gathered per
    row), chunked prefill and decode; every stream equals the reference's
    greedy generate of that prompt alone."""
    jcfg, tcfg = _cfgs(**GPT2)
    _, params = _jax_params(jcfg, seed=1)
    model = params_from_jax(tcfg, params, device="cpu")
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    eng = Engine(tcfg, model, num_slots=3, max_len=40, prefill_chunk=(4, 8), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 128, (int(n),)).astype(np.int32), int(m))
            for n, m in ((5, 9), (17, 6), (3, 12), (11, 7), (23, 5))]
    rids = [eng.submit(p, m) for p, m in reqs]
    eng.run()
    for rid, (p, m) in zip(rids, reqs):
        ref = np.array(jg.generate(jcfg, jparams, jnp.asarray(p[None]), m))[0]
        np.testing.assert_array_equal(eng.result(rid), ref, err_msg=rid)
    with pytest.raises(ValueError, match="learned position table has max_pos=40"):
        Engine(tcfg, model, num_slots=2, max_len=41, device="cpu")


def _loss_j(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def _loss_t(logits, labels):
    return -torch.log_softmax(logits.float(), -1).gather(-1, labels[..., None].long()).mean()


@pytest.mark.parametrize("family", ["gpt2_untied", "bert"])
@pytest.mark.parametrize("balance", [[2, 2], [1, 1, 2]])
def test_pipelined_forward_and_gradients_match_jax(family, balance):
    """Forward and gradients through ``GPipe``: the GPT-2 class untied
    (the MPMD pipeline refuses a tie across stages, as the reference's
    does) with a position offset, and the BERT class (post-norm,
    embedding LayerNorm, no causal mask)."""
    kw = dict(GPT2, tie_embeddings=False, pos_emb_offset=3) if family != "bert" else BERT
    jcfg, tcfg = _cfgs(**kw)
    jl, params = _jax_params(jcfg, seed=2)
    model = params_from_jax(tcfg, params, device="cpu")
    x = _prompts(4, 16, seed=4)
    y = _prompts(4, 16, seed=5)
    jpipe = JGPipe(jl, balance, chunks=2)
    jparams = per_stage(jpipe, params)
    jstates = per_stage(jpipe, [() for _ in params])
    jout = np.asarray(jpipe.apply(jparams, jstates, jnp.asarray(x))[0])
    jloss, jgrads, _, _ = jpipe.value_and_grad(jparams, jstates, jnp.asarray(x),
                                               jnp.asarray(y), _loss_j)
    pipe = GPipe(list(model), balance, devices=["cpu"], chunks=2)
    out = pipe.apply(torch.from_numpy(x).long())
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=OUT_REL_TOL * np.abs(jout).max())
    loss, _, _ = pipe.value_and_grad(torch.from_numpy(x).long(),
                                     torch.from_numpy(y).long(), _loss_t)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    got, want = [ref_tree(layer, grad_of)[0] for layer in model], flat(jgrads)
    top = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(want))
    assert_trees_close(got, want, GRAD_REL_TOL, "grads", floor=ZERO_FLOOR * top)


def test_tied_forward_and_gradient_sum_both_uses():
    """A tied model unpipelined (or in one stage): the head's product
    reads the embedding's table, and the table's gradient sums the
    lookup's and the head's, as the reference's SPMD splice does."""
    jcfg, tcfg = _cfgs(**GPT2)
    _, params = _jax_params(jcfg, seed=3)
    model = params_from_jax(tcfg, params, device="cpu")
    x = _prompts(2, 10, seed=6)
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    jl = [jt.token_embedding(jcfg)] + [jt.transformer_block(jcfg) for _ in range(2)] + \
        [jt.lm_head(jcfg)]

    def jloss(table):
        ps = [dict(jparams[0], table=table)] + jparams[1:-1] + \
            [dict(jparams[-1], table=table)]
        h = jnp.asarray(x)
        for layer, p in zip(jl, ps):
            h, _ = layer.apply(p, (), h)
        return _loss_j(h, jnp.asarray(x))

    ref_loss, ref_grad = jax.value_and_grad(jloss)(jparams[0]["table"])
    pipe = GPipe(list(model), [4], devices=["cpu"], chunks=1)
    loss, _, _ = pipe.value_and_grad(torch.from_numpy(x).long(),
                                     torch.from_numpy(x).long(), _loss_t)
    assert loss.item() == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(model[0].table.grad.numpy(), ref_grad, rtol=0,
                               atol=GRAD_REL_TOL * np.abs(ref_grad).max())


def test_learned_positions_and_embedding_norm_match_jax():
    """The embedding alone: token + position rows (at an offset), the
    embedding LayerNorm, and a packed batch's within-document rows."""
    jcfg, tcfg = _cfgs(**dict(BERT, pos_emb_offset=2))
    layer = jt.token_embedding(jcfg)
    p, _ = layer.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, 8), jnp.int32))
    emb = tt.token_embedding(tcfg, device="cpu")
    for k, v in p.items():
        getattr(emb, k).data.copy_(torch.from_numpy(np.array(v)))
    x = _prompts(2, 20)
    ref, _ = layer.apply(p, (), jnp.asarray(x))
    out = emb(torch.from_numpy(x).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    pos = np.tile(np.concatenate([np.arange(12), np.arange(8)]), (2, 1)).astype(np.int32)
    batch = {"tokens": x, "segment_ids": (np.arange(20) >= 12).astype(np.int32)[None]
             .repeat(2, 0) + 1, "positions": pos}
    (ref, _, _), _ = layer.apply(p, (), {k: jnp.asarray(v) for k, v in batch.items()})
    out, _, _ = emb({k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_refusals_copy_the_reference_texts():
    with pytest.raises(ValueError, match="pos_emb='learned' needs max_pos"):
        tt.TransformerConfig(pos_emb="learned").validate_arch()
    with pytest.raises(ValueError, match="norm_position='post' and parallel_residual"):
        tt.TransformerConfig(norm_position="post", parallel_residual=True).validate_arch()
    _, gcfg = _cfgs(**GPT2)
    with pytest.raises(ValueError, match="tie_embeddings is an SPMD-engine feature"):
        tt.llama(gcfg, device="cpu")
    with pytest.raises(ValueError, match="llama_tied needs"):
        tt.llama_tied(dataclasses.replace(gcfg, tie_embeddings=False), device="cpu")
    model = tt.llama_tied(gcfg, device="cpu")
    with pytest.raises(ValueError, match="held by stages 0 and 1"):
        GPipe(list(model), [2, 2], devices=["cpu"])
    with pytest.raises(ValueError, match="received neither 'w' nor"):
        tt.lm_head(gcfg, device="cpu")(torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="sequence length 41 \\+ pos_emb_offset 0 exceeds"):
        model[0](torch.zeros((1, 41), dtype=torch.long))
    packed = {"tokens": torch.zeros((1, 41), dtype=torch.long),
              "segment_ids": torch.ones((1, 41), dtype=torch.long),
              "positions": torch.zeros((1, 41), dtype=torch.long)}
    with pytest.raises(ValueError, match="packed block length 41"):
        model[0](packed)
    prompt = np.zeros((1, 30), np.int32)
    with pytest.raises(ValueError, match="reaches position 40 but the learned position "
                                         "table has max_pos=40 rows \\(GPT-2-class"):
        tg.generate(gcfg, model, prompt, 11, device="cpu")
    ocfg = dataclasses.replace(gcfg, pos_emb_offset=2)
    omodel = tt.llama_tied(ocfg, device="cpu")
    with pytest.raises(ValueError, match="max_pos=40 rows minus 2 reserved rows"):
        tg.generate(ocfg, omodel, prompt, 9, device="cpu")
    _, bcfg = _cfgs(**dict(BERT, causal=True))
    bert = tt.llama(bcfg, device="cpu")
    with pytest.raises(ValueError, match="BERT-class post-norm\\) models are encoders"):
        tg.generate(bcfg, bert, prompt[:, :4], 2, device="cpu")
    with pytest.raises(ValueError, match="causal by construction"):
        tg.generate(dataclasses.replace(bcfg, causal=False), bert, prompt[:, :4], 2,
                    device="cpu")
    with pytest.raises(ValueError, match="transformer_block mlp 'BatchNorm1d' must be "
                                         "stateless"):
        tt.transformer_block(gcfg, device="cpu", mlp=torch.nn.BatchNorm1d(64))


def test_load_refuses_a_nested_dict_by_its_key():
    """A nested dict where the port holds a tensor names its key (one
    that is neither a MoE block's ``"mlp"`` nor an int8 ``{"q8", "sc"}``
    pair, which load)."""
    jcfg, tcfg = _cfgs(**dict(GPT2, tie_embeddings=False))
    _, params = _jax_params(jcfg)
    params[1] = dict(params[1], w_fc={"q": params[1]["w_fc"], "scale": np.ones(1)})
    with pytest.raises(ValueError, match="layer 1 param 'w_fc' \\(dict where "
                                                  "the port holds Parameter"):
        params_from_jax(tcfg, params, device="cpu")
