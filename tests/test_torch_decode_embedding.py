"""The embedding LayerNorm in decode: the port departs from the reference.

A pre-norm causal model with ``embed_layernorm=True`` trains with the
embedding LayerNorm (``eln``/``elnb``) applied to the token embedding.
The port's decode applies it too (``models/generation.py`` ``_embed``
is the training embedding's body), so ``prefill`` and ``generate``
compute the function the model was trained as.  The reference's decode
``_embed`` leaves it out (``torchgpipe_tpu/models/generation.py:154-175``),
so there such a model decodes another function than it trains.  The
port's choice is held here against the reference's TRAINING forward
(``token_embedding``, the blocks, the head, through ``apply``), not
against ``jg.generate``; the last test records the departure.

Tolerances: one float32 network in another summation order (products
over 32-64 terms, softmax over <= 20 keys, LayerNorm over 32): logits to
5e-5 absolute (as ``tests/test_torch_generation.py`` derives).  Greedy
tokens must each be the reference forward's argmax at the position
before them (teacher forcing); the seeded logits have no near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np

from torchgpipe_tpu.layers import sequential_apply, sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt

LOGIT_TOL = 5e-5
KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, embed_layernorm=True)


def _setup():
    jcfg, tcfg = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
    layers = jt.llama(jcfg)
    params, states, _ = sequential_init(layers, jax.random.PRNGKey(3),
                                        jax.ShapeDtypeStruct((2, 8), jnp.int32))
    # Move the LayerNorm off its identity init, so leaving it out shows.
    params[0] = dict(params[0], eln=params[0]["eln"] * 1.5 + 0.25,
                     elnb=params[0]["elnb"] + 0.1)
    params = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    model = params_from_jax(tcfg, params, device="cpu")
    prompt = np.random.default_rng(4).integers(0, 64, (3, 7)).astype(np.int32)
    return jcfg, tcfg, layers, params, states, model, prompt


def _train_forward(layers, params, states, tokens):
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    out, _ = sequential_apply(layers, jp, states, jnp.asarray(tokens), rng=None,
                              train=False)
    return np.asarray(out, np.float32)


def test_prefill_and_greedy_decode_follow_the_training_forward():
    jcfg, tcfg, layers, params, states, model, prompt = _setup()
    logits, _ = tg.prefill(tcfg, model, prompt, 20, device="cpu")
    ref = _train_forward(layers, params, states, prompt)
    np.testing.assert_allclose(logits.numpy(), ref[:, -1], atol=LOGIT_TOL, rtol=0)
    n = 8
    out = tg.generate(tcfg, model, prompt, n, device="cpu").numpy()
    full = np.concatenate([prompt, out], axis=1)
    ref = _train_forward(layers, params, states, full)
    s = prompt.shape[1]
    np.testing.assert_array_equal(out, ref[:, s - 1:s - 1 + n].argmax(-1))


def test_the_reference_decode_leaves_the_embedding_layernorm_out():
    """The departure itself: the reference's prefill logits are not its
    training forward's (the LayerNorm is missing from its decode
    embedding), the port's are."""
    jcfg, tcfg, layers, params, states, model, prompt = _setup()
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    ref_decode, _ = jg.prefill(jcfg, jp, jnp.asarray(prompt), 20)
    ref_train = _train_forward(layers, params, states, prompt)[:, -1]
    assert np.abs(np.asarray(ref_decode) - ref_train).max() > 1e2 * LOGIT_TOL
