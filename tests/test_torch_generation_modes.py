"""The rest of ``generate`` against the JAX reference: ring caches (bf16
or int8), multi-turn continuation (``cache=``), ``early_exit``, per-row
frontiers (``row_frontiers``, ``row_lengths=``, ``decode_slots``) and
the validation errors of each.

Small float32 Llamas (dim 64, 4 heads, 2 kv heads, head dim 16, 2
layers, vocab 64; ``attn_window`` where a ring needs it), initialised by
the reference and converted with ``params_from_jax``, prompts from numpy
seeds.  Greedy tokens must be EQUAL: both sides compute the same float32
network in another summation order (~1e-6 relative on the logits), which
flips an argmax only at a near-tie these seeded cases do not have.
Logits are held to 5e-5 (``tests/test_torch_generation.py``'s LOGIT_TOL).
"""

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

LOGIT_TOL = 5e-5
KW = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2)


def _model(seed=0, **kw):
    kw = dict(KW, **kw)
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    params, _, _ = sequential_init(
        jt.llama(jcfg), jax.random.PRNGKey(seed), jax.ShapeDtypeStruct((1, 8), jnp.int32)
    )
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def full():
    return _model()


def _prompt(b, s, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# --------------------------------------------------------------------- #
# ring caches                                                           #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("window,s,new", [(3, 5, 6), (4, 2, 5), (8, 6, 4)])
@pytest.mark.parametrize("quant", [False, True])
def test_ring_generate_equals_jax(window, s, new, quant):
    """Prompts shorter than the window and runs across the wrap-around."""
    jcfg, tcfg, params, model = _model(attn_window=window)
    prompt = _prompt(2, s, seed=window)
    kw = dict(cache_mode="ring", kv_quant=quant)
    ref = np.asarray(jg.generate(jcfg, params, jnp.asarray(prompt), new, **kw))
    out, cache = tg.generate(tcfg, model, prompt, new, return_state=True, device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert all(k.shape[1] == window for k in cache.k) and cache.length == s + new
    # The ring reproduces the masked full-cache decode.
    np.testing.assert_array_equal(
        out.numpy(), tg.generate(tcfg, model, prompt, new, kv_quant=quant,
                                 device="cpu").numpy())


def test_ring_prefill_banks_the_window_like_jax():
    jcfg, tcfg, params, model = _model(attn_window=4)
    prompt = _prompt(1, 6)
    _, jc = jg.prefill(jcfg, params, jnp.asarray(prompt), 64, ring=True)
    _, cache = tg.prefill(tcfg, model, prompt, 64, ring=True, device="cpu")
    for a, b in zip(cache.k + cache.v, jc.k + jc.v):
        assert a.shape == (1, 4, 2, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LOGIT_TOL, rtol=0)


def test_ring_validation_errors_as_jax(full):
    jcfg, tcfg, params, model = full   # no attn_window
    prompt = _prompt(1, 4)
    for kw, match in (({"cache_mode": "ring"}, "attn_window"),
                      ({"cache_mode": "rang"}, "cache_mode")):
        with pytest.raises(ValueError, match=match):
            jg.generate(jcfg, params, jnp.asarray(prompt), 2, **kw)
        with pytest.raises(ValueError, match=match):
            tg.generate(tcfg, model, prompt, 2, device="cpu", **kw)
    with pytest.raises(ValueError, match="ring caches hold exactly the attention window"):
        jg.prefill(jcfg, params, jnp.asarray(prompt), 8, ring=True)
    with pytest.raises(ValueError, match="ring caches hold exactly the attention window"):
        tg.prefill(tcfg, model, prompt, 8, ring=True, device="cpu")


# --------------------------------------------------------------------- #
# multi-turn continuation                                               #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode,quant", [("full", False), ("ring", False),
                                        ("full", True), ("ring", True)])
def test_two_turn_continuation_equals_jax_and_one_shot(mode, quant):
    jcfg, tcfg, params, model = _model(attn_window=4 if mode == "ring" else None)
    b, s1, t1, s2, t2 = 2, 4, 3, 3, 4
    p1, p2 = _prompt(b, s1, seed=1), _prompt(b, s2, seed=2)
    kw = dict(cache_mode=mode, kv_quant=quant)
    total = s1 + t1 + s2 + t2
    j1, jstate = jg.generate(jcfg, params, jnp.asarray(p1), t1, return_state=True,
                             max_len=total, **kw)
    j2 = jg.generate(jcfg, params, jnp.asarray(p2), t2, cache=jstate, **kw)
    o1, state = tg.generate(tcfg, model, p1, t1, return_state=True, max_len=total,
                            device="cpu", **kw)
    o2 = tg.generate(tcfg, model, p2, t2, cache=state, device="cpu", **kw)
    np.testing.assert_array_equal(o1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(o2.numpy(), np.asarray(j2))
    history = np.concatenate([p1, o1.numpy(), p2], axis=1)
    one_shot = tg.generate(tcfg, model, history, t2, max_len=total, device="cpu", **kw)
    np.testing.assert_array_equal(o2.numpy(), one_shot.numpy())


# --------------------------------------------------------------------- #
# early exit                                                            #
# --------------------------------------------------------------------- #


def _shared_early_eos(out, new):
    """A token every row emits, the slowest row before the last step."""
    for eos in sorted(set(out.flatten().tolist())):
        firsts = [np.where(row == eos)[0] for row in out]
        if all(len(f) for f in firsts):
            longest = max(int(f[0]) for f in firsts)
            if longest < new - 1:
                return eos, longest
    pytest.fail("no shared early token in this seeded model's outputs")


@pytest.mark.parametrize("quant", [False, True])
def test_early_exit_equals_jax_and_fixed_length(full, quant):
    jcfg, tcfg, params, model = full
    b, s, new = 3, 5, 16
    prompt = _prompt(b, s, seed=23)   # a seed whose rows share an early token
    free = tg.generate(tcfg, model, prompt, new, device="cpu").numpy()
    eos, _ = _shared_early_eos(free, new)
    kw = dict(eos_id=eos, kv_quant=quant)
    ref, jc = jg.generate(jcfg, params, jnp.asarray(prompt), new, early_exit=True,
                          return_state=True, **kw)
    out, cache = tg.generate(tcfg, model, prompt, new, early_exit=True, return_state=True,
                             device="cpu", **kw)
    fixed = tg.generate(tcfg, model, prompt, new, device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), fixed.numpy())
    # The loop stopped at the longest row, as the reference's while_loop.
    longest = max(int(np.where(row == eos)[0][0]) for row in out.numpy())
    assert cache.length == int(jc.length) == s + longest + 1 < s + new


def test_early_exit_needs_eos_as_jax(full):
    jcfg, tcfg, params, model = full
    prompt = _prompt(1, 4)
    with pytest.raises(ValueError, match="early_exit terminates"):
        jg.generate(jcfg, params, jnp.asarray(prompt), 2, early_exit=True)
    with pytest.raises(ValueError, match="early_exit terminates"):
        tg.generate(tcfg, model, prompt, 2, early_exit=True, device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_finished_rows_leave_their_cache_untouched(full, quant):
    """After its eos a row's K/V (and int8 scales) past its frontier stay
    zero, as in the reference."""
    jcfg, tcfg, params, model = full
    b, s, new = 2, 4, 6
    prompt = _prompt(b, s, seed=4)
    free = tg.generate(tcfg, model, prompt, new, device="cpu").numpy()
    eos = int(free[0, 1])
    kw = dict(eos_id=eos, max_len=16, kv_quant=quant)
    _, jc = jg.generate(jcfg, params, jnp.asarray(prompt), new, return_state=True, **kw)
    out, cache = tg.generate(tcfg, model, prompt, new, return_state=True, device="cpu", **kw)
    frontier = s + int(np.where(out.numpy()[0] == eos)[0][0]) + 1
    bufs = [cache.k[0]] + ([cache.k_scale[0].transpose(1, 2)] if quant else [])
    for t in bufs:
        assert (t[0, frontier:] == 0).all() and (t[0, :frontier] != 0).any()
    for a, b_ in zip(cache.k + cache.v, jc.k + jc.v):
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b_).astype(np.float64))
        assert d.max() <= (1 if quant else LOGIT_TOL)


# --------------------------------------------------------------------- #
# per-row frontiers                                                     #
# --------------------------------------------------------------------- #


def test_row_frontiers_equals_jax():
    out = np.array([[3, 5, 9, 9], [1, 2, 3, 4], [9, 0, 0, 9]], np.int32)
    for eos in (None, 9):
        ref = np.asarray(jg.row_frontiers(7, jnp.asarray(out), eos_id=eos))
        got = tg.row_frontiers(7, torch.from_numpy(out).long(), eos_id=eos)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("quant", [False, True])
def test_row_lengths_continuation_equals_jax(full, quant):
    """An eos-ragged first turn, then a second turn where every row goes
    on from its own frontier: tokens and new frontiers equal the
    reference's, and each row equals that row decoded alone from its
    true history."""
    jcfg, tcfg, params, model = full
    b, s, new1, L = 3, 4, 6, 32
    prompt = _prompt(b, s, seed=5)
    free = tg.generate(tcfg, model, prompt, new1, device="cpu").numpy()
    eos = int(free[1, 1])
    kw = dict(kv_quant=quant)
    j1, jcache = jg.generate(jcfg, params, jnp.asarray(prompt), new1, eos_id=eos,
                             max_len=L, return_state=True, **kw)
    o1, cache = tg.generate(tcfg, model, prompt, new1, eos_id=eos, max_len=L,
                            return_state=True, device="cpu", **kw)
    np.testing.assert_array_equal(o1.numpy(), np.asarray(j1))
    rl = tg.row_frontiers(s, o1, eos_id=eos)
    assert int(rl[1]) < s + new1
    p2 = _prompt(b, 2, seed=6)
    j2, _, jrl2 = jg.generate(jcfg, params, jnp.asarray(p2), 3, cache=jcache,
                              row_lengths=jnp.asarray(rl.numpy()), return_state=True)
    o2, cache2, rl2 = tg.generate(tcfg, model, p2, 3, cache=cache, row_lengths=rl,
                                  return_state=True, device="cpu")
    np.testing.assert_array_equal(o2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(rl2.numpy(), np.asarray(jrl2))
    np.testing.assert_array_equal(rl2.numpy(), rl.numpy() + 2 + 3)
    for r in range(b):
        hist = np.concatenate([prompt[r], o1.numpy()[r, :int(rl[r]) - s], p2[r]])
        solo = tg.generate(tcfg, model, hist[None], 3, device="cpu", **kw)
        np.testing.assert_array_equal(o2.numpy()[r], solo.numpy()[0])


def test_row_lengths_after_eos_freezes_rows_as_jax(full):
    """eos inside a row-mode turn: finished rows write nothing and their
    frontiers freeze."""
    jcfg, tcfg, params, model = full
    b, s = 2, 4
    prompt, p2 = _prompt(b, s, seed=7), _prompt(b, 3, seed=8)
    rl = np.full((b,), s + 2, np.int32)

    def first_turn():
        _, jcache = jg.generate(jcfg, params, jnp.asarray(prompt), 2, max_len=24,
                                return_state=True)
        _, cache = tg.generate(tcfg, model, prompt, 2, max_len=24, return_state=True,
                               device="cpu")
        return jcache, cache

    free = tg.generate(tcfg, model, p2, 8, cache=first_turn()[1], row_lengths=rl,
                       device="cpu").numpy()
    eos = int(free[0, 2])
    jcache, cache = first_turn()
    j2, _, jrl = jg.generate(jcfg, params, jnp.asarray(p2), 8, cache=jcache,
                             row_lengths=jnp.asarray(rl), eos_id=eos, return_state=True)
    o2, _, trl = tg.generate(tcfg, model, p2, 8, cache=cache, row_lengths=rl, eos_id=eos,
                             return_state=True, device="cpu")
    np.testing.assert_array_equal(o2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(trl.numpy(), np.asarray(jrl))
    # Row 0 wrote up to and including its first eos, then froze.
    wrote = int(np.where(o2.numpy()[0] == eos)[0][0]) + 1
    assert int(trl[0]) == s + 2 + 3 + wrote < s + 2 + 3 + 8


def test_row_lengths_validation_errors_as_jax(full):
    jcfg, tcfg, params, model = full
    b, s = 2, 4
    prompt = _prompt(b, s, seed=9)
    _, jcache = jg.generate(jcfg, params, jnp.asarray(prompt), 2, max_len=12,
                            return_state=True)
    _, cache = tg.generate(tcfg, model, prompt, 2, max_len=12, return_state=True,
                           device="cpu")
    rl = np.full((b,), s + 2, np.int32)
    cases = [
        (dict(row_lengths=rl), "row_lengths continues PER-ROW frontiers"),
        (dict(cache=True, row_lengths=rl, cache_mode="ring"), "attn_window"),
        (dict(cache=True, row_lengths=rl, early_exit=True, eos_id=1),
         "early_exit is not supported with row_lengths"),
        (dict(cache=True, row_lengths=rl, max_len=12), "max_len sizes a NEW cache"),
        (dict(cache=True, row_lengths=np.zeros((b + 1,), np.int32)),
         "one frontier per prompt row"),
        (dict(cache=True, row_lengths=rl, n=8), "deepest row"),
    ]
    for kw, match in cases:
        kw = dict(kw)
        n = kw.pop("n", 2)
        if kw.pop("cache", False):
            jkw, tkw = dict(kw, cache=jcache), dict(kw, cache=cache)
        else:
            jkw, tkw = kw, kw
        with pytest.raises(ValueError, match=match):
            jg.generate(jcfg, params, jnp.asarray(prompt[:, :2]), n, **jkw)
        with pytest.raises(ValueError, match=match):
            tg.generate(tcfg, model, prompt[:, :2], n, device="cpu", **tkw)


def test_row_lengths_with_a_ring_is_refused_as_jax():
    jcfg, tcfg, params, model = _model(attn_window=4)
    prompt = _prompt(2, 4)
    _, jcache = jg.generate(jcfg, params, jnp.asarray(prompt), 2, return_state=True)
    _, cache = tg.generate(tcfg, model, prompt, 2, return_state=True, device="cpu")
    rl = np.full((2,), 6, np.int32)
    with pytest.raises(ValueError, match="ring caches defeat"):
        jg.generate(jcfg, params, jnp.asarray(prompt), 2, cache=jcache, row_lengths=rl,
                    cache_mode="ring")
    with pytest.raises(ValueError, match="ring caches defeat"):
        tg.generate(tcfg, model, prompt, 2, cache=cache, row_lengths=rl,
                    cache_mode="ring", device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_decode_slots_equals_jax_and_noop_rows_stay_untouched(full, quant):
    """Per-slot positions and valid counts: logits within LOGIT_TOL of
    the reference's; a slot with ``n_valid = 0`` keeps its cache (K, V
    and scales) bit for bit, and a masked tail token writes nothing."""
    jcfg, tcfg, params, model = full
    S, L = 3, 20
    prompt = _prompt(S, 6, seed=10)
    _, jcache = jg.prefill(jcfg, params, jnp.asarray(prompt), L, kv_quant=quant)
    _, cache = tg.prefill(tcfg, model, prompt, L, kv_quant=quant, device="cpu")
    before = [t.clone() for t in tg._buffers(cache)[0] + tg._buffers(cache)[1]]
    toks = _prompt(S, 3, seed=11)
    lengths = np.array([6, 2, 4], np.int32)
    n_valid = np.array([3, 0, 2], np.int32)
    ref, jc2, jl = jg.decode_slots(jcfg, params, jnp.asarray(toks), jcache,
                                   jnp.asarray(lengths), jnp.asarray(n_valid))
    logits, cache2, nl = tg.decode_slots(tcfg, model, toks, cache, lengths, n_valid,
                                         device="cpu")
    assert logits.shape == (S, 3, 64)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(jl))
    for i, j in ((0, 0), (0, 1), (0, 2), (2, 0), (2, 1)):   # the valid tokens
        np.testing.assert_allclose(logits[i, j].numpy(), np.asarray(ref)[i, j],
                                   atol=LOGIT_TOL, rtol=0)
    after = tg._buffers(cache2)[0] + tg._buffers(cache2)[1]
    for old, new in zip(before, after):
        pos = 1 if new.ndim == 4 else 2
        assert torch.equal(old[1], new[1])                        # no-op slot
        assert torch.equal(old[2].narrow(pos - 1, 6, L - 6),      # past 4 + 2
                           new[2].narrow(pos - 1, 6, L - 6))
    for a, b in zip(cache2.k + cache2.v, jc2.k + jc2.v):
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b).astype(np.float64))
        assert d.max() <= (1 if quant else LOGIT_TOL)
