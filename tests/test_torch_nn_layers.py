"""The rest of ``ops/nn.py`` and ``ops/losses.py`` against the JAX
reference: ``layer_norm``, ``gelu``, ``avg_pool2d``, ``instance_norm``,
``leaky_relu`` and ``upsample2d`` on the same numpy inputs (forward, and
the gradient of ``sum(y * r)`` for a random cotangent ``r``),
``chunked_softmax_xent`` (losses and both gradients), and the two
dropouts held to properties, since their masks come from another RNG.

Layouts: the reference is NHWC, the port NCHW; the numpy batch is made
NHWC and transposed for the port.

Tolerances.  Every layer here is a few float32 elementwise operations
or a reduction over at most 96 terms, computed in another order:
~1e-7 relative per operation.  Forward outputs must agree to 1e-5 of
max(|ref|, 1) and gradients to 1e-5 of max(|ref|, 1) (the norms divide
by a standard deviation of ~1, which can scale an error a few fold).
``upsample2d`` copies values: bitwise.  ``chunked_softmax_xent`` runs
float32 matmuls over 16 terms and an online log-sum-exp over 50
logits: losses to 1e-5 and gradients to 1e-5 of their max.

Dropout bounds: with n independent keeps of probability q = 1 - rate,
the kept count lies within 6 standard deviations, sqrt(n q (1 - q)), of
n q except with probability ~2e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchgpipe_tpu.ops import losses as jlosses
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.ops import losses as tlosses
from torchgpipe_tpu_torch.ops import nn as tnn

TOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close(got, want, what, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


def jax_fwd_grad(layer, params, x, r):
    """The reference layer's output and the gradients of ``sum(y * r)``
    w.r.t. its input and params."""
    def f(p, x):
        y, _ = layer.apply(p, (), x)
        return jnp.sum(y * r), y
    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    return np.asarray(y), np.asarray(gx), jax.tree_util.tree_map(np.asarray, gp)


def torch_fwd_grad(module, x, r):
    x = x.clone().requires_grad_()
    y = module(x)
    (y * r).sum().backward()
    return y.detach(), x.grad


def rng_data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_layer_norm_matches_jax_and_loads():
    x = rng_data(0, (4, 6, 32)) * 3 + 1
    r = rng_data(1, (4, 6, 32))
    jl = jnn.layer_norm()
    params, _ = jl.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, x.dtype))
    params = {"scale": rng_data(2, (32,)), "bias": rng_data(3, (32,))}
    ln = tnn.layer_norm(32, device="cpu")
    layers_from_jax([ln], [params], [()])
    np.testing.assert_array_equal(ln.scale.detach().numpy(), params["scale"])
    y, gx, gp = jax_fwd_grad(jl, params, x, r)
    ty, tgx = torch_fwd_grad(ln, torch.from_numpy(x), torch.from_numpy(r))
    close(ty.numpy(), y, "layer_norm forward")
    close(tgx.numpy(), gx, "layer_norm dx")
    close(ln.scale.grad.numpy(), gp["scale"], "layer_norm dscale")
    close(ln.bias.grad.numpy(), gp["bias"], "layer_norm dbias")
    assert ln.eps == 1e-6 and ln.name == "ln"
    with pytest.raises(ValueError, match="reference params"):
        layers_from_jax([ln], [{"scale": params["scale"]}], [()])


@pytest.mark.parametrize("which", ["gelu", "leaky_relu", "instance_norm", "upsample2d"])
def test_stateless_layers_match_jax(which):
    x = rng_data(4, (2, 6, 6, 5)) * 2
    jl, tl = {
        "gelu": (jnn.gelu(), tnn.gelu()),
        "leaky_relu": (jnn.leaky_relu(0.2), tnn.leaky_relu(0.2)),
        "instance_norm": (jnn.instance_norm(), tnn.instance_norm()),
        "upsample2d": (jnn.upsample2d(3), tnn.upsample2d(3)),
    }[which]
    jy, _ = jl.apply((), (), x)
    r = rng_data(5, jy.shape)
    y, gx, _ = jax_fwd_grad(jl, (), x, r)
    ty, tgx = torch_fwd_grad(tl, nchw(x), nchw(r))
    if which == "upsample2d":
        np.testing.assert_array_equal(to_nhwc(ty), y)
        np.testing.assert_array_equal(to_nhwc(tgx), gx)
        return
    close(to_nhwc(ty), y, f"{which} forward")
    close(to_nhwc(tgx), gx, f"{which} dx")
    if which == "gelu":
        # jax.nn.gelu's default is the tanh approximation, which parts
        # from F.gelu's exact erf form by up to ~5e-4 here.
        exact = F.gelu(nchw(x))
        assert (exact - ty).abs().max() > 1e-4


@pytest.mark.parametrize("case", [
    dict(window=(2, 2)),
    dict(window=(3, 3), strides=(2, 2), padding="SAME"),
    dict(window=(3, 3), strides=(2, 2), padding="SAME", count_include_pad=False),
    dict(window=(3, 3), strides=(1, 1), padding="SAME", count_include_pad=False),
    dict(window=(2, 3), strides=(1, 2), padding=((1, 0), (0, 2)),
         count_include_pad=False),
    dict(window=(2, 2), strides=(1, 1), padding=((0, 1), (1, 1))),
])
def test_avg_pool2d_matches_jax(case):
    x = rng_data(6, (2, 7, 9, 3))
    jl = jnn.avg_pool2d(**case)
    jy, _ = jl.apply((), (), x)
    r = rng_data(7, jy.shape)
    y, gx, _ = jax_fwd_grad(jl, (), x, r)
    ty, tgx = torch_fwd_grad(tnn.avg_pool2d(**case), nchw(x), nchw(r))
    assert to_nhwc(ty).shape == y.shape
    close(to_nhwc(ty), y, f"avg_pool2d {case} forward")
    close(to_nhwc(tgx), gx, f"avg_pool2d {case} dx")


def _binomial_ok(kept, n, q):
    return abs(kept - n * q) <= 6 * (n * q * (1 - q)) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_properties(rate):
    x = torch.from_numpy(rng_data(8, (64, 40, 40))) + 3.0   # no zeros in x
    d = tnn.dropout(rate, generator=torch.Generator().manual_seed(0))
    y = d(x)
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 1 - rate)
    torch.testing.assert_close(y[kept], (x / (1 - rate))[kept], rtol=0, atol=0)
    d.eval()
    assert d(x) is x
    assert tnn.dropout(0.0)(x) is x
    with pytest.raises(ValueError, match="^dropout needs an rng key in train mode$"):
        tnn.dropout(rate)(x)


def test_dropout2d_drops_whole_channels():
    rate = 0.3
    x = torch.from_numpy(rng_data(9, (50, 40, 5, 4))) + 3.0
    d = tnn.dropout2d(rate, generator=torch.Generator().manual_seed(1))
    y = d(x)
    zero = (y == 0).flatten(2)
    assert bool((zero.all(-1) | (~zero).all(-1)).all())   # whole maps only
    kept = ~zero.all(-1)
    assert _binomial_ok(int(kept.sum()), kept.numel(), 1 - rate)
    torch.testing.assert_close(y[kept], (x / (1 - rate))[kept], rtol=0, atol=0)
    d.eval()
    assert d(x) is x
    assert tnn.dropout2d(0.0)(x) is x


def test_dropout_in_a_pipeline_only_without_recompute():
    """A generator draws anew on every call, so a cell that recomputes
    its forward cannot use it: without ``rng=`` such a step refuses the
    generator's dropout; with ``rng=`` the pipeline hands each layer its
    key and every mode runs.  Under 'never' the generator runs as
    before."""
    layers = lambda: [tnn.dense(4, 4, device="cpu"),  # noqa: E731
                      tnn.dropout(0.5, generator=torch.Generator().manual_seed(0))]
    loss_fn = lambda out, _: out.sum()  # noqa: E731
    for kw in ({}, {"checkpoint": "always"}):
        pipe = GPipe(layers(), [1, 1], devices=["cpu"], chunks=2, **kw)
        with pytest.raises(ValueError, match="recomputes its forward"):
            pipe.value_and_grad(torch.ones(4, 4), None, loss_fn)
        loss, _, _ = pipe.value_and_grad(torch.ones(4, 4), None, loss_fn, rng=1)
        assert torch.isfinite(loss)
    pipe = GPipe(layers(), [1, 1], devices=["cpu"], chunks=2, checkpoint="never")
    loss, grads, _ = pipe.value_and_grad(torch.ones(4, 4), None, loss_fn)
    assert torch.isfinite(loss)
    torch.testing.assert_close(pipe.apply(torch.ones(4, 4)),
                               torch.ones(4, 4) @ pipe[0].w + pipe[0].b)


@pytest.mark.parametrize("chunk", [16, 50, 64])
def test_chunked_softmax_xent_matches_jax(chunk):
    T, d, V = 12, 16, 50
    h = rng_data(10, (T, d))
    w = rng_data(11, (d, V)) * 0.5
    labels = np.random.default_rng(12).integers(0, V, (T,)).astype(np.int32)
    g = rng_data(13, (T,))

    def jf(h, w):
        loss = jlosses.chunked_softmax_xent(h, w, jnp.asarray(labels), chunk)
        return jnp.sum(loss * g), loss
    (_, jloss), (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(h, w)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = tlosses.chunked_softmax_xent(th, tw, torch.from_numpy(labels), chunk)
    (loss * torch.from_numpy(g)).sum().backward()
    assert loss.dtype == torch.float32 and loss.shape == (T,)
    close(loss.detach().numpy(), jloss, "losses")
    close(th.grad.numpy(), jdh, "dh")
    close(tw.grad.numpy(), jdw, "dw")
    dense = F.cross_entropy(torch.from_numpy(h @ w), torch.from_numpy(labels).long(),
                            reduction="none")
    close(loss.detach().numpy(), dense.numpy(), "losses vs dense")


def test_assert_labels_in_range():
    tlosses.assert_labels_in_range(torch.tensor([0, 3, 49]), 50)
    for bad in ([0, 50], [-1, 2]):
        with pytest.raises(ValueError, match=r"labels must lie in \[0, vocab\)"):
            tlosses.assert_labels_in_range(torch.tensor(bad), 50)
    with pytest.raises(ValueError, match="chunk must be"):
        tlosses.chunked_softmax_xent(torch.zeros(2, 3), torch.zeros(3, 4),
                                     torch.zeros(2, dtype=torch.long), 0)
