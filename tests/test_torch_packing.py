"""Sequence packing in torchgpipe_tpu_torch against the JAX reference
(``tests/test_packing.py``'s contracts, on the port).

The corpus is the reference test's: 8 documents of lengths (5, 9, 3,
16, 7, 2, 11, 6), tokens from ``RandomState(0)``, packed into 16-token
blocks; the model is its float32 Llama (vocab 37, dim 16, 2 layers, 2
heads), initialised by the reference and converted with
``convert.params_from_jax``.

Tolerances.  The packer, the batches and ``real_token_fraction`` are
integer and host arithmetic: equal.  Logits of one float32 network in
another summation order (matmuls over at most 64 terms, softmax over at
most 16 keys): 5e-5 absolute (``test_torch_gpipe.py``), losses to 1e-5
relative, gradients to 1e-4 of each leaf's max.  A packed row and a
document alone attend to the same keys with the other documents'
scores masked to -1e30 (exp underflows to exactly 0), so the per-token
math is the same up to summation order: per-document losses to the
reference's pinned 5e-4, and attention outputs to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_apply, sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.parallel.ring_attention import full_attention
from torchgpipe_tpu.utils import data as jdata
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.utils import data as tdata

KW = dict(vocab=37, dim=16, n_layers=2, n_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
S = 16
DOC_LENS = (5, 9, 3, 16, 7, 2, 11, 6)
TOL = 5e-4
LOGIT_TOL, LOSS_RTOL, GRAD_REL_TOL = 5e-5, 1e-5, 1e-4
FIELDS = ("tokens", "segment_ids", "positions", "labels", "weights")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(0)
    docs = [rng.randint(1, KW["vocab"], size=n).astype(np.int32) for n in DOC_LENS]
    pk = tdata.pack_documents(docs, S)
    x, y = next(tdata.packed_batches(pk, pk.n_blocks))
    xt, yt = next(tdata.padded_batches(docs, S, batch_rows=len(docs)))
    return docs, pk, (x, y), (xt, yt)


@pytest.fixture(scope="module")
def weights(corpus):
    _, _, (x, _), _ = corpus
    spec = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), x)
    params, _, _ = sequential_init(jt.llama(JCFG), jax.random.PRNGKey(0), spec)
    return [jax.tree_util.tree_map(np.asarray, p) for p in params]


def _t(tree):
    """numpy batch -> tensors (int64 ids, float32 weights)."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).long() if a.dtype.kind == "i"
        else torch.from_numpy(a), tree)


def _seg_number(pk, doc_index):
    r, off, _ = pk.doc_locs[doc_index]
    return sum(1 for rr, oo, _n in pk.doc_locs if rr == r and oo <= off)


def test_packer_deterministic_and_whole(corpus):
    docs, pk, _, _ = corpus
    jpk = jdata.pack_documents(docs, S)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pk, f), getattr(jpk, f))
        assert getattr(pk, f).dtype == getattr(jpk, f).dtype
    assert pk.doc_locs == jpk.doc_locs and pk.pad_fraction == jpk.pad_fraction
    pk2 = tdata.pack_documents(docs, S)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pk, f), getattr(pk2, f))
    for i, (r, off, n) in enumerate(pk.doc_locs):
        np.testing.assert_array_equal(pk.tokens[r, off:off + n], docs[i])
        np.testing.assert_array_equal(pk.positions[r, off:off + n], np.arange(n))
        np.testing.assert_array_equal(pk.labels[r, off:off + n - 1], docs[i][1:])
        assert pk.weights[r, off + n - 1] == 0.0
    free = np.full((pk.n_blocks,), S)
    for i, (r, off, n) in enumerate(pk.doc_locs):
        assert all(free[:r] < n), f"doc {i} skipped a block with room"
        free[r] -= n


@pytest.mark.parametrize("docs, block", [([np.arange(S + 1)], S), ([np.arange(0)], S),
                                         ([np.arange(2)], 1)])
def test_packer_errors(docs, block):
    with pytest.raises(ValueError) as je:
        jdata.pack_documents(docs, block)
    with pytest.raises(ValueError) as te:
        tdata.pack_documents(docs, block)
    assert str(te.value) == str(je.value)


def test_packed_batches_resume_replays(corpus):
    docs, pk, _, _ = corpus
    jpk = jdata.pack_documents(docs, S)
    full = list(tdata.packed_batches(pk, 3))
    jfull = list(jdata.packed_batches(jpk, 3))
    resumed = list(tdata.packed_batches(pk, 3, start=1))
    assert len(full) == len(jfull) and len(resumed) == len(full) - 1
    for (xa, ya), (xb, yb) in zip(full, jfull):
        jax.tree_util.tree_map(np.testing.assert_array_equal, (xa, ya), (xb, yb))
    for (xa, ya), (xb, yb) in zip(full[1:], resumed):
        jax.tree_util.tree_map(np.testing.assert_array_equal, (xa, ya), (xb, yb))
    assert all(x["tokens"].shape == (3, S) for x, _ in full)
    for (xa, ya), (xb, yb) in zip(tdata.padded_batches(docs, S, 3),
                                  jdata.padded_batches(docs, S, 3)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, (xa, ya), (xb, yb))


def test_real_token_fraction(corpus):
    docs, pk, (x, _), (xt, _) = corpus
    assert tdata.real_token_fraction(x) == jdata.real_token_fraction(x)
    assert tdata.real_token_fraction(x) == pytest.approx(1.0 - pk.pad_fraction)
    assert tdata.real_token_fraction(xt) == jdata.real_token_fraction(xt) == \
        pytest.approx(sum(DOC_LENS) / (len(DOC_LENS) * S))
    a = np.array([[0, 5, 0, 7], [1, 2, 0, 0]], np.int32)
    assert tdata.real_token_fraction(a) == jdata.real_token_fraction(a) == pytest.approx(6 / 8)
    # The prefetcher hands the batch over as tensors, unchanged.
    (got,) = list(tdata.prefetch_to_device([x], device="cpu"))
    for k in x:
        np.testing.assert_array_equal(got[k].numpy(), x[k])


def test_packed_per_document_losses_match_unpacked(corpus, weights):
    """Per-document losses of the packed batch equal each document run
    alone (the port's model both ways) to the reference's pinned 5e-4,
    and the packed logits and losses equal the reference's."""
    docs, pk, (x, y), _ = corpus
    model = params_from_jax(TCFG, weights, device="cpu")
    with torch.no_grad():
        logits = model(_t(x))
    jlogits, _ = sequential_apply(jt.llama(JCFG), weights, [()] * len(weights),
                                  jax.tree_util.tree_map(jnp.asarray, x),
                                  rng=None, train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGIT_TOL)
    max_seg = int(pk.segment_ids.max())
    pls = tt.per_document_losses(logits, _t(y), _t(x)["segment_ids"], max_seg)
    jpls = jt.per_document_losses(jlogits, jax.tree_util.tree_map(jnp.asarray, y),
                                  jnp.asarray(x["segment_ids"]), max_seg)
    np.testing.assert_allclose(pls.numpy(), np.asarray(jpls), rtol=LOSS_RTOL, atol=1e-6)
    pls = pls.numpy().reshape(pk.n_blocks, max_seg)
    for i, d in enumerate(docs):
        with torch.no_grad():
            lg = model(torch.from_numpy(d).long()[None])
        ref = tt.cross_entropy(lg[:, :-1], torch.from_numpy(d[1:]).long()[None]).item()
        r, _, _ = pk.doc_locs[i]
        assert abs(pls[r, _seg_number(pk, i) - 1] - ref) <= TOL, (i, ref)
    for fn in ("packed_cross_entropy", "packed_cross_entropy_sum"):
        got = getattr(tt, fn)(logits, _t(y)).item()
        want = float(getattr(jt, fn)(jlogits, jax.tree_util.tree_map(jnp.asarray, y)))
        assert got == pytest.approx(want, rel=LOSS_RTOL), fn


@pytest.mark.parametrize("checkpoint", ["never", "except_last"])
def test_packed_gpipe_matches_jax(corpus, weights, checkpoint):
    """A packed batch through ``GPipe([2, 2], chunks=2)`` (the dict
    scattered along the batch, the ``(hidden, seg, pos)`` tuple crossing
    the stage boundary) against the reference GPipe: loss and every
    gradient; the padded layout of the same documents gives the same
    real-token loss sum to the pinned tolerance."""
    _, _, (x, y), (xt, yt) = corpus
    jpipe = JGPipe(jt.llama(JCFG), [2, 2], chunks=2, checkpoint=checkpoint)
    jp = jpipe.place((weights[:2], weights[2:]))
    jst = jpipe.place(([(), ()], [(), ()]))
    jl, jgrads, _, _ = jpipe.value_and_grad(
        jp, jst, jax.tree_util.tree_map(jnp.asarray, x),
        jax.tree_util.tree_map(jnp.asarray, y), jt.packed_cross_entropy_sum)
    jflat = [g for stage in jgrads for g in stage]
    pipe = GPipe(list(params_from_jax(TCFG, weights, device="cpu")), [2, 2],
                 devices=["cpu"], chunks=2, checkpoint=checkpoint)
    loss, grads, _ = pipe.value_and_grad(_t(x), _t(y), tt.packed_cross_entropy_sum)
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    for i, layer in enumerate(pipe):
        for name, p in layer.named_parameters():
            ref = np.asarray(jflat[i][name])
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=GRAD_REL_TOL * np.abs(ref).max(),
                                       err_msg=f"layer {i} {name}")
    padded, _, _ = pipe.value_and_grad(_t(xt), _t(yt), tt.packed_cross_entropy_sum)
    assert abs(loss.item() - padded.item()) <= TOL * max(1.0, abs(padded.item()))


def test_chunked_lm_loss_packed_targets(corpus):
    """The chunked loss layer's per-row losses equal the reference's
    ``row_loss`` on the same head weights and hidden states; zero-weight
    positions cannot move them, uniform weights give the plain row
    means, and the packed activation tuple is accepted."""
    _, pk, (x, y), _ = corpus
    jlayer = jt.chunked_lm_loss(JCFG, chunk=16)
    jparams, _ = jlayer.init(jax.random.PRNGKey(3),
                             jax.ShapeDtypeStruct((pk.n_blocks, S, KW["dim"]), jnp.float32))
    h = np.array(jax.random.normal(jax.random.PRNGKey(4), (pk.n_blocks, S, KW["dim"])))
    _, layer = params_from_jax(TCFG, _empty_model_params(), device="cpu",
                               loss_params=jax.tree_util.tree_map(np.asarray, jparams),
                               chunk=16)
    th, ty = torch.from_numpy(h), _t(y)
    with torch.no_grad():
        base = layer.row_loss(th, ty)
        jbase = jlayer.meta["row_loss"](jparams, (), (jnp.asarray(h),
                                                      jax.tree_util.tree_map(jnp.asarray, y)))
        np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=LOSS_RTOL)
        scrambled = dict(ty, labels=torch.where(ty["weights"] > 0, ty["labels"],
                                                (ty["labels"] + 7) % KW["vocab"]))
        assert torch.equal(base, layer.row_loss(th, scrambled))
        uniform = dict(ty, weights=torch.ones_like(ty["weights"]))
        torch.testing.assert_close(layer.row_loss(th, uniform),
                                   layer.row_loss(th, ty["labels"]), rtol=1e-6, atol=0)
        seg, pos = _t(x)["segment_ids"], _t(x)["positions"]
        assert torch.equal(base, layer.row_loss((th, seg, pos), ty))
        assert torch.equal(layer(th, ty), base.mean())


def _empty_model_params():
    """A converted model is not needed by the loss test: the embedding
    and blocks of a zero-weight reference model stand in."""
    spec = jax.ShapeDtypeStruct((1, S), jnp.int32)
    params, _, _ = sequential_init(jt.llama(JCFG, head=False), jax.random.PRNGKey(9), spec)
    return [jax.tree_util.tree_map(np.asarray, p) for p in params]


@pytest.mark.parametrize("causal, window", [(True, None), (True, 3), (False, None)])
def test_packed_attention_equals_separate_documents(causal, window):
    """A packed 2-document row (and a pad tail) through the dense
    segment attention equals each document attended alone, and equals
    the reference's ``full_attention(..., seg=)``."""
    rng = np.random.default_rng(1)
    n1, n2, pad, nh, g, hd = 5, 7, 2, 4, 2, 8
    s = n1 + n2 + pad
    q, k, v = (rng.standard_normal((1, s, n, hd)).astype(np.float32)
               for n in (nh, g, g))
    seg = np.array([[1] * n1 + [2] * n2 + [0] * pad], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tt.segment_attention(tq, tk, tv, torch.from_numpy(seg).long(),
                               causal=causal, window=window)
    ref = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                         window=window, seg=jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    for lo, hi in ((0, n1), (n1, n1 + n2)):
        one = tt.segment_attention(tq[:, lo:hi], tk[:, lo:hi], tv[:, lo:hi],
                                   torch.ones(1, hi - lo, dtype=torch.long),
                                   causal=causal, window=window)
        np.testing.assert_allclose(got[:, lo:hi].numpy(), one.numpy(), rtol=0, atol=1e-6)


def test_packed_attention_rejects_sp_axis(corpus, weights, cpu_devices):
    """A packed batch under a sequence-parallel axis: the reference's
    embedding and block refuse it (inside a bound ``sp`` axis), and so do
    the port's inside a bound one (``parallel.bind_axes``), with the same
    texts."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    _, _, (x, _), _ = corpus
    jcfg = dataclasses.replace(JCFG, sp_axis="sp")
    mesh = Mesh(np.array(cpu_devices[:2]), ("sp",))
    xj = {k: jnp.asarray(v[:1]) for k, v in x.items()}
    emb, blk = jt.token_embedding(jcfg), jt.transformer_block(jcfg)

    def run(fn, *args):
        spec = jax.tree_util.tree_map(lambda _: P(None, "sp"), args)
        return shard_map(lambda *a: fn(*a), mesh=mesh, in_specs=spec,
                         out_specs=P(None, "sp"), check_rep=False)(*args)

    hidden = jnp.zeros((1, S, KW["dim"]))
    with pytest.raises(ValueError) as je_emb:
        run(lambda a: emb.apply(weights[0], (), a)[0], xj)
    with pytest.raises(ValueError) as je_blk:
        run(lambda h, s_, p_: blk.apply(weights[1], (), (h, s_, p_))[0][0],
            hidden, xj["segment_ids"], xj["positions"])
    model = params_from_jax(TCFG, weights, device="cpu")
    for layer in model:
        layer.cfg = dataclasses.replace(TCFG, sp_axis="sp")
    from types import SimpleNamespace

    from torchgpipe_tpu_torch.parallel import bind_axes

    sp_mesh = SimpleNamespace(shape={"sp": 2}, coords={"sp": 0})
    with bind_axes(sp_mesh, ["sp"]):
        with pytest.raises(ValueError) as te_emb:
            model[0](_t(x))
        with pytest.raises(ValueError) as te_blk:
            model[1]((torch.zeros(1, S, KW["dim"]), _t(x)["segment_ids"][:1],
                      _t(x)["positions"][:1]))
    assert str(te_emb.value) == str(je_emb.value)
    assert str(te_blk.value) == str(je_blk.value)
    with pytest.raises(ValueError) as je:
        jt.token_embedding(JCFG).apply(weights[0], (), {"tokens": xj["tokens"],
                                                        "segment_ids": xj["segment_ids"]})
    with pytest.raises(ValueError) as te:
        model[0]({"tokens": _t(x)["tokens"], "segment_ids": _t(x)["segment_ids"]})
    assert str(te.value) == str(je.value)
