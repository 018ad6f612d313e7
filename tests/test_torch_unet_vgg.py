"""U-Net and VGG in torchgpipe_tpu_torch against the JAX reference.

U-Net at depth 2, 2 convolutions a level, 8 base channels, 32x32 (49
layers), through a 2-stage pipeline cut at layer 24: both encoder
stashes cross the boundary to their decoder pops.  VGG-16 at base width
2, head width 16, 32x32.  Both packages start from the port's seeded
weights (``jax_trees`` hands them to the reference; the layer lists
match the reference's structure, checked through
``convert.layers_from_jax``), at dropout rate 0 on both sides (the
reference's dropout layers are rebuilt at rate 0 in this test), so the
two compute one function; the same U-Net with its dropout live is held
to itself across checkpoint modes.

Tolerances.  Both sides compute the same float32 network in another
summation order (3x3 convolutions over up to 288 terms, instance-norm
statistics over up to 1024 values, BatchNorm over up to 2048), ~1e-7
relative per op; gradients pass back through up to 13 normalisations,
each of which can scale an error by its 1/std.  Loss to 1e-5 relative,
each gradient leaf to 1e-4 of its max |value|, BatchNorm buffers to 1e-5
of max(|value|, 1), outputs to 1e-4 of their max (``test_torch_resnet.py``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models.unet import unet as junet
from torchgpipe_tpu.models import vgg as jvgg
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.models import unet as tunet
from torchgpipe_tpu_torch.models import vgg as tvgg
from torchgpipe_tpu_torch.ops import nn as tnn
from tests.torch_parity import (
    assert_buffers_match,
    assert_grads_match,
    flat,
    jax_mean_loss,
    jax_trees,
    nchw,
    per_stage,
    torch_mean_loss,
)

LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL, OUT_REL_TOL = 1e-5, 1e-4, 1e-5, 1e-4
UNET = dict(depth=2, num_convs=2, base_channels=8)
VGG = dict(base_width=2, head_width=16)
BATCH, CHUNKS, SIZE = 4, 2, 32


def _torch_unet(seed=0):
    return list(tunet.unet(**UNET, device="cpu",
                           generator=torch.Generator().manual_seed(seed)))


def _jax_unet_rate0():
    return [jnn.dropout2d(0.0, name=l.name) if l.name.endswith("_dropout") else l
            for l in junet(**UNET)]


def _torch_vgg(seed=0, dropout=0.0):
    return tvgg.vgg16(10, **VGG, dropout=dropout, image_size=SIZE, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _images(c=3):
    return np.random.default_rng(0).standard_normal((BATCH, SIZE, SIZE, c)).astype(np.float32)


def _unet_jax_loss(out, tgt):
    return jnp.mean(jnp.square(out - tgt))


def _unet_torch_loss(out, tgt):
    return (out - tgt).square().mean()


def _check_structure(torch_layers, jax_layers, x):
    """The port's list has the reference's length and parameter trees:
    ``layers_from_jax`` loads the reference's init into it."""
    assert len(torch_layers) == len(jax_layers)
    jp, js, _ = sequential_init(jax_layers, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct(x.shape, jnp.float32))
    jp, js = [jax.tree_util.tree_map(np.asarray, p) for p in jp], \
        [jax.tree_util.tree_map(np.asarray, s) for s in js]
    layers_from_jax(torch_layers, jp, js)


@pytest.mark.parametrize("model", ["unet", "vgg16"])
def test_forward_and_gradients_match_jax(model):
    x = _images()
    if model == "unet":
        layers, jl = _torch_unet(), _jax_unet_rate0()
        for l in layers:
            if isinstance(l, tnn.Dropout):
                l.rate = 0.0
        balance = [24, len(layers) - 24]
        tgt = np.random.default_rng(1).standard_normal((BATCH, SIZE, SIZE, 1)).astype(np.float32)
        jloss, tloss, ttgt = _unet_jax_loss, _unet_torch_loss, nchw(tgt)
    else:
        layers, jl = _torch_vgg(), jvgg.vgg16(10, **VGG, dropout=0.0)
        balance = [20, len(layers) - 20]
        tgt = np.random.default_rng(1).integers(0, 10, (BATCH,)).astype(np.int32)
        jloss, tloss, ttgt = jax_mean_loss, torch_mean_loss, torch.from_numpy(tgt).long()
    _check_structure(_torch_unet(1) if model == "unet" else _torch_vgg(1), jl, x)
    params, states = jax_trees(layers)
    jpipe = JGPipe(jl, balance, chunks=CHUNKS)
    jparams, jstates = per_stage(jpipe, params), per_stage(jpipe, states)
    jout = np.asarray(jpipe.apply(jparams, jstates, jnp.asarray(x))[0])
    jl_, jgrads, jst, _ = jpipe.value_and_grad(jparams, jstates, jnp.asarray(x),
                                               jnp.asarray(tgt), jloss)
    pipe = GPipe(layers, balance, devices=["cpu"], chunks=CHUNKS)
    if model == "unet":
        assert {k for k, _ in pipe.skip_layout.by_key.items()} and \
            all(src != dst for src, dst in pipe.skip_layout.by_key.values())
    out = pipe.apply(nchw(x))
    ref = jout.transpose(0, 3, 1, 2) if jout.ndim == 4 else jout
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=OUT_REL_TOL * np.abs(ref).max())
    loss, _, _ = pipe.value_and_grad(nchw(x), ttgt, tloss, rng=0)
    assert loss.item() == pytest.approx(float(jl_), rel=LOSS_RTOL)
    assert_grads_match(layers, flat(jgrads), GRAD_REL_TOL)
    assert_buffers_match(layers, flat(jst), BUF_REL_TOL)


def test_unet_dropout_replays_across_checkpoint_modes():
    """The U-Net with its 0.1 spatial dropouts live: one key gives the
    same loss and bitwise the same gradients under 'never', 'always' and
    'except_last' (the recomputed cells redraw the forward's masks);
    another key gives another loss."""
    x = nchw(_images())
    tgt = torch.zeros(BATCH, 1, SIZE, SIZE)
    runs = {}
    for mode, rng in (("never", 3), ("always", 3), ("except_last", 3), ("never", 4)):
        pipe = GPipe(_torch_unet(), [24, 25], devices=["cpu"], chunks=CHUNKS,
                     checkpoint=mode)
        loss, _, _ = pipe.value_and_grad(x, tgt, _unet_torch_loss, rng=rng)
        runs[(mode, rng)] = [loss] + [p.grad for p in pipe.parameters()]
    base = runs[("never", 3)]
    for key in (("always", 3), ("except_last", 3)):
        assert all(torch.equal(a, b) for a, b in zip(runs[key], base)), key
    assert not torch.equal(runs[("never", 4)][0], base[0])


def test_vgg_layout_and_guards():
    assert len(tvgg.vgg19(device="meta", image_size=SIZE)) == len(jvgg.vgg19())
    assert len(tvgg.vgg16(device="meta")) == len(jvgg.vgg16())
    with pytest.raises(ValueError) as je:
        jvgg.build_vgg(11)
    with pytest.raises(ValueError) as te:
        tvgg.build_vgg(11, device="cpu")
    assert str(te.value) == str(je.value)
    assert [l.name for l in tunet.unet(device="meta")] == [l.name for l in junet()]
