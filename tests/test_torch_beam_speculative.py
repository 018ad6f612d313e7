"""``beam_search`` and ``speculative_generate`` against the JAX reference.

Small float32 Llamas (target: dim 64, 4 heads, 2 kv heads, 2 layers;
draft: dim 32, 2 heads, 1 kv head, 1 layer; vocab 64), initialised by
the reference and converted with ``params_from_jax``.  Greedy paths are
deterministic on both sides, so tokens, beam scores' ranking and
``SpecStats`` must be EQUAL (the same float32 network in another
summation order moves logits by ~1e-6 relative, which these seeded
cases never let decide an argmax); beam log-probs agree to 1e-4 (a sum
of up to 8 log-softmax terms of magnitude ~4, each ~1e-6 apart).
Sampled speculative decoding is checked by distribution: a JAX key and a
``torch.Generator`` draw different streams.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt

TARGET = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
DRAFT = dict(vocab=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1)


def _model(kw, seed):
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    params, _, _ = sequential_init(
        jt.llama(jcfg), jax.random.PRNGKey(seed), jax.ShapeDtypeStruct((1, 8), jnp.int32)
    )
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def target():
    return _model(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    return _model(DRAFT, 123)


def _prompt(b, s, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# --------------------------------------------------------------------- #
# beam search                                                           #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("beams,new,eos", [(1, 5, None), (3, 6, None), (4, 8, None),
                                           (2, 6, "early")])
def test_beam_search_equals_jax(target, beams, new, eos):
    jcfg, tcfg, params, model = target
    prompt = _prompt(2, 5, seed=beams)
    if eos == "early":
        first, _ = tg.beam_search(tcfg, model, prompt, 2, num_beams=beams, device="cpu")
        eos = int(first[0, 1])
    ref, ref_lp = jg.beam_search(jcfg, params, jnp.asarray(prompt), new, num_beams=beams,
                                 eos_id=eos)
    out, lp = tg.beam_search(tcfg, model, prompt, new, num_beams=beams, eos_id=eos,
                             device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=0)
    if eos is not None:
        for row in out.numpy():
            hits = np.where(row == eos)[0]
            if len(hits):
                assert (row[hits[0]:] == eos).all()


def test_one_beam_is_greedy_generate(target):
    _, tcfg, _, model = target
    prompt = _prompt(3, 6, seed=9)
    beams, lp = tg.beam_search(tcfg, model, prompt, 7, num_beams=1, device="cpu")
    greedy = tg.generate(tcfg, model, prompt, 7, device="cpu")
    assert torch.equal(beams, greedy) and torch.isfinite(lp).all()


def test_beam_search_refusals(target):
    _, tcfg, _, model = target
    with pytest.raises(ValueError, match="num_beams must be >= 1"):
        tg.beam_search(tcfg, model, _prompt(1, 4), 2, num_beams=0, device="cpu")


def test_top_k_breaks_ties_to_the_lower_index_as_lax():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    v, i = tg._top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# --------------------------------------------------------------------- #
# speculative decoding                                                  #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_speculative_equals_jax(target, draft, gamma):
    """Tokens and SpecStats equal the reference's, and the tokens equal
    greedy generate (an unrelated draft changes the acceptance, never the
    output)."""
    jcfg, tcfg, params, model = target
    jdcfg, dcfg, dparams, dmodel = draft
    prompt = _prompt(2, 6, seed=gamma)
    ref, rs = jg.speculative_generate(jcfg, params, jdcfg, dparams, jnp.asarray(prompt),
                                      12, gamma=gamma, return_stats=True)
    out, st = tg.speculative_generate(tcfg, model, dcfg, dmodel, prompt, 12, gamma=gamma,
                                      return_stats=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for mine, theirs in zip(st, rs):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(out.numpy(),
                                  tg.generate(tcfg, model, prompt, 12, device="cpu").numpy())
    assert (st.drafted == gamma * st.rounds).all()
    assert ((st.rounds + st.accepted) >= 11).all()


def test_self_draft_accepts_everything(target):
    """draft == target: every proposal is accepted and the round count is
    ceil((T-1)/(gamma+1)), as in the reference's test."""
    _, tcfg, _, model = target
    T, g = 10, 3
    prompt = _prompt(2, 4, seed=11)
    out, st = tg.speculative_generate(tcfg, model, tcfg, model, prompt, T, gamma=g,
                                      return_stats=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(),
                                  tg.generate(tcfg, model, prompt, T, device="cpu").numpy())
    assert (st.rounds == math.ceil((T - 1) / (g + 1))).all()
    assert (st.accepted == st.rounds * g).all()


def test_speculative_eos_freezes_like_jax(target, draft):
    jcfg, tcfg, params, model = target
    jdcfg, dcfg, dparams, dmodel = draft
    prompt = _prompt(2, 5, seed=12)
    free = tg.generate(tcfg, model, prompt, 8, device="cpu").numpy()
    eos = int(free[0, 2])
    ref = jg.speculative_generate(jcfg, params, jdcfg, dparams, jnp.asarray(prompt), 8,
                                  gamma=3, eos_id=eos)
    out = tg.speculative_generate(tcfg, model, dcfg, dmodel, prompt, 8, gamma=3,
                                  eos_id=eos, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        out.numpy(), tg.generate(tcfg, model, prompt, 8, eos_id=eos, device="cpu").numpy())


def test_speculative_refusals_as_jax(target, draft):
    jcfg, tcfg, params, model = target
    jdcfg, dcfg, dparams, dmodel = draft
    prompt = _prompt(1, 4)
    other = dict(DRAFT, vocab=32)
    jo, to = jt.TransformerConfig(**other), tt.TransformerConfig(**other)
    cases = [(dict(gamma=0), ValueError, "gamma must be >= 1"),
             (dict(temperature=1.0), ValueError, "temperature sampling needs")]
    for kw, err, match in cases:
        with pytest.raises(err, match=match):
            jg.speculative_generate(jcfg, params, jdcfg, dparams, jnp.asarray(prompt), 4, **kw)
        with pytest.raises(err, match=match):
            tg.speculative_generate(tcfg, model, dcfg, dmodel, prompt, 4, device="cpu", **kw)
    with pytest.raises(ValueError, match="shared tokenizer"):
        jg.speculative_generate(jcfg, params, jo, dparams, jnp.asarray(prompt), 4)
    with pytest.raises(ValueError, match="shared tokenizer"):
        tg.speculative_generate(tcfg, model, to, dmodel, prompt, 4, device="cpu")


@pytest.mark.parametrize("top_p", [None, 0.8])
def test_sampled_speculative_matches_target_distribution(top_p):
    """Port-only (the two packages' random streams differ): sampling
    through the accept / resample rule leaves the output distributed as
    target-only sampling (Leviathan et al., thm. 1).  N rows of one
    prompt, each drawn independently; the marginals of both new tokens
    (the second went through a full draft-verify round) of speculative
    and plain ``generate`` agree.  The standard error of a frequency at
    N=768 is <= 0.018, so 0.08 is > 4 sigma (the reference's test,
    ``tests/test_speculative.py``)."""
    tk = dict(vocab=8, dim=16, n_layers=1, n_heads=2, n_kv_heads=1)
    dk = dict(vocab=8, dim=8, n_layers=1, n_heads=1, n_kv_heads=1)
    _, tcfg, _, model = _model(tk, 7)
    _, dcfg, _, dmodel = _model(dk, 99)
    N, s, T = 768, 3, 2
    prompt = np.tile(_prompt(1, s, seed=13, vocab=8), (N, 1))
    spec = tg.speculative_generate(
        tcfg, model, dcfg, dmodel, prompt, T, gamma=1, temperature=1.0, top_p=top_p,
        generator=torch.Generator().manual_seed(5), device="cpu")
    plain = tg.generate(tcfg, model, prompt, T, temperature=1.0, top_p=top_p,
                        generator=torch.Generator().manual_seed(11), device="cpu")
    for col in range(T):
        f_spec = np.bincount(spec[:, col].numpy(), minlength=8) / N
        f_plain = np.bincount(plain[:, col].numpy(), minlength=8) / N
        assert np.abs(f_spec - f_plain).max() < 0.08, (col, f_spec, f_plain)
