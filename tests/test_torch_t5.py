"""torchgpipe_tpu_torch.models.t5 against the JAX reference.

A t5-small-shaped model cut down to 2 + 2 layers, dim 32, 4 heads, d_ff
64, vocab 64, float32, drawn by the reference's init and loaded into the
port through ``convert.layers_from_jax``: the pipelined forward, loss
and every gradient (the tuple carrier crosses the cut, the batch-1 bias
carriers whole: the encoder's and the decoder's bias each cross a cut
of the second balance) at two balances, ``t5_encode``, greedy ``t5_generate``
(tokens equal), ``t5_shift_right``, and ``_rel_bucket``'s ids bit for
bit over relative positions -4096..4096.

Tolerances.  Both sides compute one float32 network in another
summation order (products over 32-64 terms, softmax over 8-12 keys):
~1e-7 relative per op, through 4 blocks and 2 final norms.  Logits and
encoder output to 1e-5 of their max, loss to 1e-5 relative, each
gradient leaf to 1e-4 of its max |value| (the loss's softmax and the
norms' 1/rms multiply the per-op error by up to ~100 in the backward).
Greedy tokens must be equal: this seed's top-two logit gaps (printed on
failure) are far above the 1e-5 the two paths can differ by.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.models import t5 as tt5
from tests.torch_parity import assert_trees_close, flat, grad_of, per_stage, ref_tree

# The package exports a function of the module's name: take the module.
jt5 = importlib.import_module("torchgpipe_tpu.models.t5")

OUT_REL_TOL, LOSS_RTOL, GRAD_REL_TOL = 1e-5, 1e-5, 1e-4
SIZES = dict(vocab=64, dim=32, n_enc_layers=2, n_dec_layers=2, n_heads=4,
             mlp_hidden=64)
B, SE, SD = 4, 12, 8


def _cfgs(**kw):
    return jt5.T5Config(**SIZES, **kw), tt5.T5Config(**SIZES, **kw)


def _ids():
    rng = np.random.default_rng(0)
    enc = rng.integers(0, 64, (B, SE)).astype(np.int32)
    labels = rng.integers(0, 64, (B, SD)).astype(np.int32)
    return enc, labels


def _models(jcfg, tcfg):
    """The reference's init and the port's layers holding it."""
    jl = jt5.t5_layers(jcfg)
    enc, labels = _ids()
    spec = (jax.ShapeDtypeStruct(enc.shape, jnp.int32),
            jax.ShapeDtypeStruct(labels.shape, jnp.int32))
    jp, js, _ = sequential_init(jl, jax.random.PRNGKey(3), spec)
    jp = [jax.tree_util.tree_map(np.asarray, p) for p in jp]
    layers = tt5.t5_layers(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    layers_from_jax(layers, jp, [() for _ in jp])
    return jl, jp, js, layers


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def _torch_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, labels[..., None].long()).mean()


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (16, 64), (32, 256)])
def test_rel_bucket_ids_bitwise(bidirectional, buckets, max_dist):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(jt5._rel_bucket(jnp.asarray(rel), bidirectional=bidirectional,
                                     buckets=buckets, max_dist=max_dist))
    out = tt5._rel_bucket(torch.from_numpy(rel), bidirectional=bidirectional,
                          buckets=buckets, max_dist=max_dist)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("balance", [[3, 4], [2, 3, 2]])
def test_pipelined_forward_and_gradients_match_jax(balance):
    jcfg, tcfg = _cfgs()
    jl, jp, js, layers = _models(jcfg, tcfg)
    enc, labels = _ids()
    dec = np.array(jt5.t5_shift_right(jcfg, jnp.asarray(labels)))
    jpipe = JGPipe(jl, balance, chunks=2)
    jparams, jstates = per_stage(jpipe, jp), per_stage(jpipe, js)
    x = (jnp.asarray(enc), jnp.asarray(dec))
    jout = np.asarray(jpipe.apply(jparams, jstates, x)[0])
    jloss, jgrads, _, _ = jpipe.value_and_grad(jparams, jstates, x, jnp.asarray(labels),
                                               _jax_loss)
    pipe = GPipe(layers, balance, devices=["cpu"], chunks=2)
    tx = (torch.from_numpy(enc).long(), torch.from_numpy(dec).long())
    out = pipe.apply(tx)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=OUT_REL_TOL * np.abs(jout).max())
    loss, _, _ = pipe.value_and_grad(tx, torch.from_numpy(labels).long(), _torch_loss)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    got = [ref_tree(layer, grad_of)[0] for layer in layers]
    assert_trees_close(got, flat(jgrads), GRAD_REL_TOL, "grads")


def test_encode_and_greedy_generate_match_jax():
    jcfg, tcfg = _cfgs()
    _, jp, _, layers = _models(jcfg, tcfg)
    enc, _ = _ids()
    ref = np.asarray(jt5.t5_encode(jcfg, [jax.tree_util.tree_map(jnp.asarray, p)
                                          for p in jp], jnp.asarray(enc)))
    out = tt5.t5_encode(tcfg, layers, enc, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=OUT_REL_TOL * np.abs(ref).max())
    jtoks = np.asarray(jt5.t5_generate(jcfg, [jax.tree_util.tree_map(jnp.asarray, p)
                                              for p in jp], jnp.asarray(enc), 10))
    toks = tt5.t5_generate(tcfg, layers, enc, 10, device="cpu")
    assert toks.dtype == torch.int64
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    # Teacher forcing reproduces the greedy tokens through the training layers.
    dec = tt5.t5_shift_right(tcfg, toks)
    with torch.no_grad():
        h = (torch.from_numpy(enc).long(), dec)
        for layer in layers:
            h = layer(h)
    assert torch.equal(h.argmax(-1), toks)


def test_generate_with_eos_freezes_rows_and_matches_jax():
    jcfg, tcfg = _cfgs(tie_word_embeddings=False)
    _, jp, _, layers = _models(jcfg, tcfg)
    enc, _ = _ids()
    first = tt5.t5_generate(tcfg, layers, enc, 6, device="cpu")
    eos = int(first[0, 2])
    jtoks = np.asarray(jt5.t5_generate(jcfg, [jax.tree_util.tree_map(jnp.asarray, p)
                                              for p in jp], jnp.asarray(enc), 6,
                                       eos_id=eos))
    toks = tt5.t5_generate(tcfg, layers, enc, 6, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert (toks[0, 2:] == eos).all()


def test_shift_right_and_sampling_and_refusals():
    _, tcfg = _cfgs()
    labels = torch.tensor([[5, 6, 7], [8, 9, 10]])
    assert tt5.t5_shift_right(tcfg, labels).tolist() == [[0, 5, 6], [0, 8, 9]]
    layers = tt5.t5_layers(tcfg, device="cpu")
    enc = torch.zeros((2, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="generator"):
        tt5.t5_generate(tcfg, layers, enc, 3, temperature=1.0, device="cpu")
    a = tt5.t5_generate(tcfg, layers, enc, 4, temperature=0.9, top_k=8,
                        generator=torch.Generator().manual_seed(2), device="cpu")
    b = tt5.t5_generate(tcfg, layers, enc, 4, temperature=0.9, top_k=8,
                        generator=torch.Generator().manual_seed(2), device="cpu")
    assert torch.equal(a, b) and a.shape == (2, 4)
    with pytest.raises(ValueError, match="t5_layers"):
        tt5.t5_encode(tcfg, layers[:-1], enc, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        tt5.t5_encode(tcfg, layers, enc, device="meta")


def test_layer_list_has_the_reference_structure():
    """The port's layer list has the reference's length and every
    layer's parameter tree (nested ``attn``/``xattn``/``ff`` dicts, the
    first blocks' ``rel`` tables), so the two load into each other."""
    jcfg, tcfg = _cfgs(gated_mlp=True, act="gelu_tanh", tie_word_embeddings=False)
    jl, jp, _, layers = _models(jcfg, tcfg)
    assert len(layers) == len(jl) == 2 + 2 + 3
    mine = [ref_tree(layer)[0] for layer in layers]
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
