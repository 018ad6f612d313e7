"""torchgpipe_tpu_torch.models.amoebanet against the JAX reference.

AmoebaNet-D cut to 3 normal cells (one per group) and 16 filters (9
layers; 4 to 64 channels a state), 64x64 images, batch 8 in 2
micro-batches, float32, drawn by the reference's init and loaded into
the port through ``convert.layers_from_jax`` (cells' children by name,
BatchNorm states into buffers): the eval forward, the loss, every
gradient and every BatchNorm buffer after one training step, at two
balances (the ``(x, skip)`` tuple crossing each cut) and with deferred
BatchNorm; the full (18, 256) list's length and parameter count; the
factorized reduce's one-pixel shift and the pools at odd sizes.

Tolerances.  Both sides compute one float32 network in another
summation order (convolutions over up to 9 x 64 terms, BatchNorm
statistics over 32-8192 values): ~1e-7 relative per op, as in
``test_torch_resnet.py``.  Loss to 1e-5 relative; logits to 1e-4 of their
max; running statistics to 1e-5 of max(|value|, 1); deferred counters
exactly; the single layers (no normalisation) to 1e-5 of their max.  The
gradients pass back through up to ~40 BatchNorms on a path, several of
them over 2 channels (the cut-down cells' ``c // 4``), each scaling an
error by its 1/std: held against this network run in float64 (the port's
layers, ``double()``), each float32 side lies up to 1.3e-4 of a leaf's
max |value| from it (median 1.5e-5, measured at balance [4, 5]), so the
two sides may differ by up to twice that: each gradient leaf to 5e-4 of
its max |value|.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.models import amoebanet as tamoeba
from tests.torch_parity import (
    assert_trees_close,
    flat,
    grad_of,
    jax_mean_loss,
    nchw,
    per_stage,
    ref_tree,
    torch_mean_loss,
)

# The package exports a function of the module's name: take the module.
jamoeba = importlib.import_module("torchgpipe_tpu.models.amoebanet")

LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL, OUT_REL_TOL, OP_REL_TOL = 1e-5, 5e-4, 1e-5, 1e-4, 1e-5
BATCH, CHUNKS, SIZE, CLASSES = 8, 2, 64, 10
SMALL = dict(num_classes=CLASSES, num_layers=3, num_filters=16)


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (BATCH,)).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _reference_init():
    """The reference's layers and init (numpy), drawn once for the file."""
    jl = jamoeba.amoebanetd(**SMALL)
    jp, js, _ = sequential_init(jl, jax.random.PRNGKey(5),
                                jax.ShapeDtypeStruct((2, SIZE, SIZE, 3), jnp.float32))
    jp, js = ([jax.tree_util.tree_map(np.asarray, t) for t in tree] for tree in (jp, js))
    return jl, jp, js


def _models(deferred):
    """The reference's layers and init, and the port's layers holding it."""
    jl, jp, js = _reference_init()
    layers = tamoeba.amoebanetd(**SMALL, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    if deferred:
        from torchgpipe_tpu.batchnorm import convert_deferred_batch_norm as jconvert

        layers = convert_deferred_batch_norm(layers, CHUNKS)
        # The reference's deferred states: its own conversion's init.
        _, js, _ = sequential_init(jconvert(jl, CHUNKS), jax.random.PRNGKey(5),
                                   jax.ShapeDtypeStruct((2, SIZE, SIZE, 3), jnp.float32))
        js = [jax.tree_util.tree_map(np.asarray, t) for t in js]
    layers_from_jax(layers, jp, js)
    return jl, jp, js, layers


@pytest.mark.parametrize("balance,deferred", [([4, 5], False), ([2, 3, 4], False),
                                              ([4, 5], True)])
def test_forward_gradients_and_states_match_jax(balance, deferred):
    jl, jp, js, layers = _models(deferred)
    x, y = _data()
    jpipe = JGPipe(jl, balance, chunks=CHUNKS, deferred_batch_norm=deferred)
    jparams, jstates = per_stage(jpipe, jp), per_stage(jpipe, js)
    pipe = GPipe(layers, balance, devices=["cpu"], chunks=CHUNKS)
    if not deferred:
        jout = np.asarray(jpipe.apply(jparams, jstates, jnp.asarray(x))[0])
        out = pipe.apply(nchw(x))
        np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                                   atol=OUT_REL_TOL * np.abs(jout).max())
    jloss, jgrads, jst, _ = jpipe.value_and_grad(jparams, jstates, jnp.asarray(x),
                                                 jnp.asarray(y), jax_mean_loss)
    loss, _, _ = pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(), torch_mean_loss)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    got = [ref_tree(layer, grad_of)[0] for layer in layers]
    assert_trees_close(got, flat(jgrads), GRAD_REL_TOL, "grads")
    states = [ref_tree(layer)[1] for layer in layers]
    want = flat(jst)
    ints = [(a, b) for a, b in zip(jax.tree_util.tree_leaves(states),
                                   jax.tree_util.tree_leaves(want))
            if not np.issubdtype(np.asarray(a).dtype, np.floating)]
    assert all(int(a) == int(b) for a, b in ints)
    floats = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if np.issubdtype(np.asarray(a).dtype,
                                                              np.floating) else 0.0,
        states)
    wfloats = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if np.issubdtype(np.asarray(a).dtype,
                                                              np.floating) else 0.0,
        want)
    assert_trees_close(floats, wfloats, BUF_REL_TOL, "states")


# Three SGD steps (lr 0.01; on the card the (18, 256) net's loss rose at
# 0.1 and 0.01) of both packages from the same weights on the same batch.
# Step 1's loss is the parity test's (LOSS_RTOL).  Each later loss is the
# network at weights each side moved by lr times its own gradients, and
# this BatchNorm net amplifies float32 rounding from step to step: the
# port's float32 trajectory lies 3e-6 (step 2) and 1.1e-2 (step 3) from
# its own float64 one (the port's layers ``double()``, measured), and the
# reference's float32 1.1e-6 and 1.1e-2, so two float32 sides may differ
# by up to twice that: step 2 to STEP2_RTOL = 1e-4, step 3 to STEP3_RTOL =
# 2^-5 (3.1e-2 >= 2.2e-2; measured between the packages: 6.9e-6 and
# 5.7e-3).
SGD_LR, STEP2_RTOL, STEP3_RTOL = 0.01, 1e-4, 2 ** -5


def test_three_sgd_steps_follow_the_reference():
    """Both packages' losses over three SGD steps at the cut-down shape:
    the port follows the reference step for step, so whether the loss
    rises over them is the model's doing, not the port's.  At this shape
    neither package's loss rises: both fall at every step."""
    jl, jp, js, layers = _models(False)
    x, y = _data()
    jpipe = JGPipe(jl, [4, 5], chunks=CHUNKS)
    jparams, jstates = per_stage(jpipe, jp), per_stage(jpipe, js)
    pipe = GPipe(layers, [4, 5], devices=["cpu"], chunks=CHUNKS)
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=SGD_LR),
                                torch_mean_loss)
    want, got = [], []
    for _ in range(3):
        jloss, jgrads, jstates, _ = jpipe.value_and_grad(jparams, jstates, jnp.asarray(x),
                                                         jnp.asarray(y), jax_mean_loss)
        jparams = jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g, jparams, jgrads)
        want.append(float(jloss))
        got.append(step(nchw(x), torch.from_numpy(y).long())[0].item())
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    assert got[1] == pytest.approx(want[1], rel=STEP2_RTOL)
    assert got[2] == pytest.approx(want[2], rel=STEP3_RTOL)
    assert want[0] > want[1] > want[2] and got[0] > got[1] > got[2]


def test_amoebanetd_18_256_has_the_reference_structure():
    """AmoebaNet-D (18, 256): 24 layers with the reference's names and
    every layer's parameter and state tree, leaf for leaf in shape."""
    ours = tamoeba.amoebanetd(1000, 18, 256, device="meta")
    ref = jamoeba.amoebanetd(1000, 18, 256)
    assert len(ours) == len(ref) == 24
    assert [l.name for l in ours] == [l.name for l in ref]
    jp, js, _ = jax.eval_shape(lambda: sequential_init(
        ref, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)))
    shape = lambda t: tuple(t.shape)  # noqa: E731
    mine = [ref_tree(l, shape) for l in ours]
    assert [p for p, _ in mine] == [jax.tree_util.tree_map(shape, p) for p in jp]
    assert jax.tree_util.tree_structure([s for _, s in mine]) == \
        jax.tree_util.tree_structure(js)
    n_ref = sum(np.prod(t.shape) for t in jax.tree_util.tree_leaves(jp))
    n_ours = sum(p.numel() for l in ours for p in l.parameters())
    assert n_ours == n_ref


def test_factorized_reduce_and_pools_match_jax():
    """The reduce's second path reads the input shifted one pixel down
    and right (zero fill), on an odd size; the 3x3 average pool divides
    by the real elements at the border; the max pool pads with -inf."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 7, 6)).astype(np.float32)
    jl = jamoeba._factorized_reduce(8)
    jp, js = jl.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, jnp.float32))
    ref, _ = jl.apply(jp, js, jnp.asarray(x), train=True)
    kw = dict(device="cpu", generator=None)
    ours = tamoeba.FactorizedReduce(6, 8, kw=kw)
    layers_from_jax([ours], [jax.tree_util.tree_map(np.asarray, jp)],
                    [jax.tree_util.tree_map(np.asarray, js)])
    out = ours(nchw(x)).permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=OP_REL_TOL * np.abs(ref).max())
    for kind in ("avg_pool_3x3", "max_pool_3x3", "max_pool_2x2"):
        for stride in (1, 2):
            jop = jamoeba._make_op(kind, 6, stride, kind)
            jout, _ = jop.apply((), (), jnp.asarray(x), train=True)
            top = tamoeba._make_op(kind, 6, stride, kind, kw=kw)
            got = top(nchw(x)).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, np.asarray(jout), rtol=0, atol=1e-6,
                                       err_msg=f"{kind} stride {stride}")


def test_cell_passes_the_skip_tuple():
    """A cell takes ``x`` or ``(x, skip)`` and returns ``(out, its x)``."""
    layers = tamoeba.amoebanetd(**SMALL, device="cpu")
    h = layers[0](torch.zeros(2, 3, 16, 16))
    out, skip = layers[1](h)
    assert skip is h and out.shape[1] == 3 * 8
    out2, skip2 = layers[2]((out, skip))
    assert skip2 is out and out2.shape[2] == out.shape[2] // 2
    with pytest.raises(ValueError, match="multiple of 3"):
        tamoeba.amoebanetd(10, 4, device="cpu")
