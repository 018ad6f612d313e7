"""Per-micro-batch RNG replay in torchgpipe_tpu_torch against the JAX
reference.

The reference folds its key with the micro-batch index and with each
layer's index in the model (``pipeline.py``: ``fold_in(rng, i)``, then
``fold_in(rng_i, offset + li)``) and a dropout draws threefry bits from
the layer's key.  The port derives its keys the same way through an
integer hash (``torchgpipe_tpu_torch.rng``), so its masks are not the
reference's bits: at rate 0 the two are compared bitwise, at a rate
above 0 by properties.

Bounds.  With n independent keeps of probability q = 1 - rate, the kept
count lies within 6 standard deviations, sqrt(n q (1 - q)), of n q
except with probability ~2e-9 (``test_torch_nn_layers.py``).  Masks of
one key are held bitwise equal wherever the reference's are equal by
construction: across checkpoint modes, between fill-drain and 1F1B,
between a cell's forward and its recompute, and between a megastep's
inner step k and a single step given ``fold_in(rng, k)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import rng as trng
from torchgpipe_tpu_torch.ops import nn as tnn

RATE = 0.5


def _binomial_ok(kept, n, q):
    return abs(kept - n * q) <= 6 * (n * q * (1 - q)) ** 0.5


def _layers(rate=RATE, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [tnn.dropout(rate, name="d0"), tnn.dense(16, 16, device="cpu", generator=gen),
            tnn.dropout(rate, name="d2"), tnn.dense(16, 4, device="cpu", generator=gen),
            tnn.dropout(rate, name="d4")]


def _x(n=8):
    return torch.from_numpy(np.random.default_rng(0).random((n, 16)).astype(np.float32)) + 1.0


def _loss(out, _):
    return out.square().mean()


class _Masks:
    """Forward hooks on the dropouts that record each call's keep mask
    under its key path (micro-batch, layer); a path seen twice (a
    recompute) must draw the same mask."""

    def __init__(self, pipe):
        self.masks = {}
        self.repeats = 0
        for layer in pipe:
            if isinstance(layer, tnn.Dropout):
                layer.register_forward_hook(self._hook)

    def _hook(self, module, inputs, out):
        path = trng._scope.key.path
        mask = out != 0
        if path in self.masks:
            assert torch.equal(self.masks[path], mask), path
            self.repeats += 1
        self.masks[path] = mask


def test_rate_zero_bitwise_equal_to_jax():
    """At rate 0 (and in eval mode at any rate) a dropout is the
    identity on both sides, key or no key; a pipe with ``rng=`` then
    computes bitwise what it computes without one."""
    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    for rate, train in ((0.0, True), (RATE, False)):
        jy, _ = jnn.dropout(rate).apply((), (), jnp.asarray(x), rng=jax.random.PRNGKey(0),
                                        train=train)
        d = tnn.dropout(rate).train(train)
        with trng.scope(trng.Key(trng.key_tensor(0))):
            ty = d(torch.from_numpy(x))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ty.numpy(), x)
    runs = []
    for rng in (None, 5):
        pipe = GPipe(_layers(rate=0.0), [2, 3], devices=["cpu"], chunks=4)
        loss, grads, _ = pipe.value_and_grad(_x(), None, _loss, rng=rng)
        runs.append([loss] + [p.grad for p in pipe.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_fraction_is_binomial(rate):
    x = torch.rand(64, 40, 40) + 1.0
    for seed in range(3):
        with trng.scope(trng.Key(trng.key_tensor(seed)).fold(2).fold(7)):
            y = tnn.dropout(rate)(x)
        kept = y != 0
        assert _binomial_ok(int(kept.sum()), x.numel(), 1 - rate)
        torch.testing.assert_close(y[kept], (x / (1 - rate))[kept], rtol=0, atol=0)
    x4 = torch.rand(50, 40, 5, 4) + 1.0
    with trng.scope(trng.Key(trng.key_tensor(3))):
        y = tnn.dropout2d(rate)(x4)
    zero = (y == 0).flatten(2)
    assert bool((zero.all(-1) | (~zero).all(-1)).all())
    kept = ~zero.all(-1)
    assert _binomial_ok(int(kept.sum()), kept.numel(), 1 - rate)
    # Mask bits are uniform: each of the 32 bits set half the time.
    b = trng.bits(trng.key_tensor(11), (1 << 16,))
    for k in range(32):
        assert _binomial_ok(int(((b >> k) & 1).sum()), 1 << 16, 0.5), k


def _run(rng, **kw):
    pipe = GPipe(_layers(), [2, 3], devices=["cpu"], chunks=4, **kw)
    masks = _Masks(pipe)
    loss, _, _ = pipe.value_and_grad(_x(), _x() if kw.get("schedule") else None,
                                     _loss, rng=rng)
    return masks, loss, [p.grad.clone() for p in pipe.parameters()]


def test_masks_equal_across_modes_and_schedules():
    """One key, every way of running the step: the same mask for every
    (micro-batch, layer), recomputes included; fill-drain's gradients
    are bitwise equal across the checkpoint modes."""
    ref, ref_loss, ref_grads = _run(7, checkpoint="never")
    assert ref.repeats == 0 and len(ref.masks) == 4 * 3
    for kw in ({"checkpoint": "always"}, {"checkpoint": "except_last"},
               {"checkpoint": "offload"},
               {"schedule": "1f1b", "loss_reduction": "mean", "checkpoint": "never"},
               {"schedule": "1f1b", "loss_reduction": "mean", "checkpoint": "except_last"}):
        got, loss, grads = _run(7, **kw)
        assert got.masks.keys() == ref.masks.keys(), kw
        for path, mask in ref.masks.items():
            assert torch.equal(got.masks[path], mask), (kw, path)
        if kw.get("checkpoint") in ("always", "except_last"):
            assert got.repeats == 12 if kw["checkpoint"] == "always" else got.repeats == 9
        if "schedule" not in kw:
            assert torch.equal(loss, ref_loss), kw
            assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads)), kw


def test_masks_differ_across_micro_batches_layers_and_keys():
    masks = _run(7, checkpoint="never")[0].masks
    other = _run(8, checkpoint="never")[0].masks
    for (i, layer), mask in masks.items():
        for (i2, layer2), mask2 in masks.items():
            if mask.shape == mask2.shape and (i, layer) != (i2, layer2):
                assert not torch.equal(mask, mask2), ((i, layer), (i2, layer2))
        assert not torch.equal(mask, other[(i, layer)])
    assert {path[1] for path in masks} == {0, 2, 4}   # each layer's index in the model


def test_layer_keys_fold_the_models_layer_index():
    """Stage boundaries do not move a layer's key: balance [2, 3] and [5]
    draw the same masks."""
    a = _run(3, checkpoint="never")[0].masks
    pipe = GPipe(_layers(), [5], devices=["cpu"], chunks=4, checkpoint="never")
    b = _Masks(pipe)
    pipe.value_and_grad(_x(), None, _loss, rng=3)
    assert a.keys() == b.masks.keys()
    assert all(torch.equal(a[k], b.masks[k]) for k in a)


def test_megastep_step_k_equals_single_step_with_fold_in():
    """Inner step k of ``megastep=K`` runs with ``fold_in(rng, k)``: two
    single steps given those keys end bitwise where the megastep ends."""
    def build(megastep):
        pipe = GPipe(_layers(), [2, 3], devices=["cpu"], chunks=2, fused=True,
                     megastep=megastep)
        step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=0.1), _loss)
        return pipe, step

    xs = torch.stack([_x(), _x() * 0.5])
    mpipe, mstep = build(2)
    losses, _, finite = mstep(xs, xs, rng=21)
    spipe, sstep = build(1)
    key = trng.key_tensor(21)
    single = [sstep(xs[k], xs[k], rng=trng.fold_in(key, k))[0] for k in range(2)]
    assert bool(finite.all())
    assert torch.equal(losses, torch.stack(single))
    assert all(torch.equal(a, b) for a, b in zip(mpipe.parameters(), spipe.parameters()))


def test_fused_step_takes_a_new_key_per_call():
    """A fused step (eager on the CPU, a replayed graph on the card)
    draws anew for a new key and bitwise the same for the same key;
    ``apply(train=True)`` draws from its key too."""
    pipe = GPipe(_layers(), [2, 3], devices=["cpu"], chunks=2, fused=True)
    a = pipe.value_and_grad(_x(), None, _loss, rng=1)[0].clone()
    b = pipe.value_and_grad(_x(), None, _loss, rng=1)[0].clone()
    c = pipe.value_and_grad(_x(), None, _loss, rng=2)[0].clone()
    assert torch.equal(a, b) and not torch.equal(a, c)
    y1 = pipe.apply(_x(), rng=4, train=True)
    y2 = pipe.apply(_x(), rng=4, train=True)
    assert torch.equal(y1, y2) and (y1 == 0).any()
    assert torch.equal(pipe.apply(_x()), pipe.apply(_x(), rng=4))   # eval: no dropout


def _paths():
    """Derivation paths, some repeated, some sharing prefixes."""
    return [(0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (1, 1), (0, 0), (2, 5), (5, 2),
            (3, 4, 1), (3, 4, 1), (3, 1, 4)]


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_derived_keys_differ_as_jax_keys_do(seed):
    """Fold the same paths into one key on both sides: two derived keys
    are equal exactly when the reference's are."""
    def jax_key(path):
        k = jax.random.PRNGKey(seed)
        for d in path:
            k = jax.random.fold_in(k, d)
        return tuple(np.asarray(jax.random.key_data(k) if hasattr(jax.random, "key_data")
                                else k).ravel())

    def port_key(path):
        return int(trng.Key(trng.key_tensor(seed), tuple(path)).value(torch.device("cpu")))

    paths = _paths()
    jk = [jax_key(p) for p in paths]
    tk = [port_key(p) for p in paths]
    for a in range(len(paths)):
        for b in range(len(paths)):
            assert (jk[a] == jk[b]) == (tk[a] == tk[b]), (paths[a], paths[b])


@pytest.mark.parametrize("factory, shape", [(tnn.dropout, (4, 6)),
                                            (tnn.dropout2d, (2, 3, 4, 4))])
def test_dropout_needs_a_key_texts(factory, shape):
    """A dropout in training with no key (and no generator) raises the
    reference's text; so does one in a pipeline step given no ``rng``."""
    jfactory = {tnn.dropout: jnn.dropout, tnn.dropout2d: jnn.dropout2d}[factory]
    x = np.ones(shape, np.float32)
    with pytest.raises(ValueError) as je:
        jfactory(RATE).apply((), (), jnp.asarray(x), rng=None, train=True)
    with pytest.raises(ValueError) as te:
        factory(RATE)(torch.from_numpy(x))
    assert str(te.value) == str(je.value)
    pipe = GPipe([factory(RATE)], [1], devices=["cpu"], checkpoint="never")
    with pytest.raises(ValueError) as te:
        pipe.value_and_grad(torch.from_numpy(x), None, _loss)
    assert str(te.value) == str(je.value)
