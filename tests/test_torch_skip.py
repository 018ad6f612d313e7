"""torchgpipe_tpu_torch's skip connections against the JAX reference.

The API cases of tests/skip/test_api.py, ``verify_skippables``' error
texts against the reference's, and ``value_and_grad`` of a small
convolutional model whose stash and pop sit on stages 0 and 2 (the skip
passes stage 1), under all three checkpoint modes and both schedules,
against the reference ``GPipe`` on the same numpy inputs and weights.

Tolerances.  Both sides compute the same float32 network in another
summation order (3x3 convolutions over 27-72 terms, BatchNorm statistics
over 128-256 values, micro-batch gradient sums in another grouping):
~1e-7 relative per op, a few ulps after the backward.  The loss must
agree to 1e-5 relative, each gradient leaf to 1e-4 of its own max
|value| and each BatchNorm buffer to 1e-5 of its max (an order of
magnitude over what the summation order can explain; a skip cotangent
dropped or sent to the wrong cell moves a leaf by its whole size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import skip as jskip
from torchgpipe_tpu.layers import apply_layer as japply_layer
from torchgpipe_tpu.layers import named, stateless
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu.partition import split_layers as jsplit
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import skip as tskip
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.partition import split_layers
from tests.torch_parity import (
    assert_buffers_match,
    assert_grads_match,
    flat,
    jax_mean_loss,
    nchw,
    torch_mean_loss,
)

LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL = 1e-5, 1e-4, 1e-5
BATCH, CHUNKS, BALANCE = 8, 4, [2, 2, 4]


# ---------------------------------------------------------------------- #
# the API (tests/skip/test_api.py)                                       #
# ---------------------------------------------------------------------- #


def test_namespace_identity_and_ordering():
    a, b = tskip.Namespace(), tskip.Namespace()
    assert a != b and a == a
    assert len({a, b, a}) == 2
    assert (a < b) != (b < a)
    assert tskip.skip_key(None, "x") < tskip.skip_key(a, "x")


def _both(build):
    """The same layer list built with each package's skip module."""
    return build(jskip, lambda name: jnn.dense(4, name=name)), build(
        tskip, lambda name: tnn.Dense(4, 4, name=name, device="cpu"))


def _verify_messages(build):
    jl, tl = _both(build)
    with pytest.raises(TypeError) as je:
        jskip.verify_skippables(jl)
    with pytest.raises(TypeError) as te:
        tskip.verify_skippables(tl)
    return str(te.value), str(je.value)


@pytest.mark.parametrize("case", ["pop_before_stash", "unpopped", "duplicate",
                                  "double_pop"])
def test_verify_skippables_messages_match_jax(case):
    def build(m, dense):
        if case == "pop_before_stash":
            return [m.pop_add("x", name="popper"), m.stash("x", name="stasher")]
        if case == "unpopped":
            return [m.stash("x", name="stasher"), dense("d")]
        if case == "duplicate":
            return [m.stash("x", name="s1"), m.pop_add("x", name="p1"),
                    m.stash("x", name="s2"), m.pop_add("x", name="p2")]
        return [m.stash("x", name="s1"), m.pop_add("x", name="p1"),
                m.pop_add("x", name="p2")]

    got, want = _verify_messages(build)
    assert got == want


def test_verify_isolated_namespaces_pass():
    ns1, ns2 = tskip.Namespace(), tskip.Namespace()
    tskip.verify_skippables([
        tskip.stash("x", ns=ns1, name="s1"), tskip.pop_add("x", ns=ns1, name="p1"),
        tskip.stash("x", ns=ns2, name="s2"), tskip.pop_add("x", ns=ns2, name="p2"),
    ])


def test_layout_routing_table():
    ns = tskip.Namespace()
    layers = [
        tskip.stash("a", ns=ns, name="s"),
        tnn.ReLU("mid"),
        tnn.Dense(4, 4, name="d", device="cpu"),
        tskip.pop_add("a", ns=ns, name="p"),
    ]
    tskip.verify_skippables(layers)
    layout = tskip.inspect_skip_layout(split_layers(layers, [1, 2, 1]))
    (key,) = layout.by_key
    assert layout.stash_stage(key) == 0 and layout.pop_stage(key) == 2
    assert layout.requires_copy(key)
    assert layout.external_stashes(0) == [key] and layout.external_pops(2) == [key]
    assert layout.external_stashes(1) == [] and layout.external_pops(1) == []
    # The reference's table over the same cut.
    jns = jskip.Namespace()
    jl = [jskip.stash("a", ns=jns), stateless("mid", lambda x: x), jnn.dense(4),
          jskip.pop_add("a", ns=jns)]
    jlayout = jskip.inspect_skip_layout(jsplit(jl, [1, 2, 1]))
    assert list(jlayout.by_key.values()) == list(layout.by_key.values())


def test_layout_same_stage_skip_is_internal():
    ns = tskip.Namespace()
    layers = [tskip.stash("a", ns=ns), tskip.pop_add("a", ns=ns)]
    layout = tskip.inspect_skip_layout(split_layers(layers, [2]))
    (key,) = layout.by_key
    assert not layout.requires_copy(key)
    assert layout.external_stashes(0) == []


def test_skippable_undeclared_stash_rejected():
    layer = tskip.skippable(lambda x, pops: (x, {"oops": x}), stash=[], name="bad")
    with pytest.raises(RuntimeError, match="undeclared"):
        layer(torch.ones(2, 2), {})


def test_skippable_missing_stash_rejected():
    layer = tskip.skippable(lambda x, pops: (x, {}), stash=["need"], name="lazy")
    with pytest.raises(RuntimeError, match="did not stash"):
        layer(torch.ones(2, 2), {})


def test_pop_cat_and_pop_add_semantics_match_jax():
    x = np.arange(8.0, dtype=np.float32).reshape(2, 4)
    ns, jns = tskip.Namespace(), jskip.Namespace()
    skips, jskips = {}, {}
    y = tskip.apply_layer(tskip.stash("v", ns=ns), torch.from_numpy(x), skips)
    japply_layer(jskip.stash("v", ns=jns), (), (), jnp.asarray(x), jskips)
    np.testing.assert_array_equal(y.numpy(), x)
    for t, j in ((tskip.pop_cat("v", ns=ns), jskip.pop_cat("v", ns=jns)),
                 (tskip.pop_add("v", ns=ns), jskip.pop_add("v", ns=jns))):
        got = tskip.apply_layer(t, torch.from_numpy(x), dict(skips))
        want, _ = japply_layer(j, (), (), jnp.asarray(x), dict(jskips))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_skip_sequential_threads_skips():
    ns = tskip.Namespace()
    model = tskip.SkipSequential(tskip.stash("v", ns=ns), tnn.ReLU(),
                                 tskip.pop_add("v", ns=ns))
    x = torch.tensor([[-1.0, 2.0]])
    assert torch.equal(model(x), torch.tensor([[-1.0, 4.0]]))


# ---------------------------------------------------------------------- #
# value_and_grad with a skip across stages                               #
# ---------------------------------------------------------------------- #


def _jax_layers():
    return named([
        jnn.conv2d(8, (3, 3), name="c1"),
        jskip.stash("res"),
        jnn.batch_norm(name="bn1"),
        jnn.relu(),
        jnn.conv2d(8, (3, 3), name="c2"),
        jskip.pop_add("res"),
        jnn.global_avg_pool(),
        jnn.dense(5, name="head"),
    ])


def _torch_layers():
    kw = dict(device="cpu")
    return [
        tnn.Conv2d(3, 8, (3, 3), name="c1", **kw),
        tskip.stash("res"),
        tnn.BatchNorm(8, name="bn1", **kw),
        tnn.ReLU(),
        tnn.Conv2d(8, 8, (3, 3), name="c2", **kw),
        tskip.pop_add("res"),
        tnn.GlobalAvgPool(),
        tnn.Dense(8, 5, name="head", **kw),
    ]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, (BATCH,)).astype(np.int32)
    return x, y


_JAX = {}


def _jax_run(data, schedule):
    if schedule not in _JAX:
        x, y = data
        kw = dict(schedule="1f1b", loss_reduction="mean") if schedule == "1f1b" else {}
        # The reference's checkpoint modes compute one function: 'never'
        # compiles the fewest programs.
        pipe = JGPipe(_jax_layers(), BALANCE, chunks=CHUNKS, checkpoint="never", **kw)
        params, state = pipe.init(jax.random.PRNGKey(2),
                                  jax.ShapeDtypeStruct(x.shape, jnp.float32))
        loss, grads, new_state, _ = pipe.value_and_grad(
            params, state, jnp.asarray(x), jnp.asarray(y), jax_mean_loss)
        _JAX[schedule] = ((flat(params), flat(state)), float(loss), flat(grads),
                          flat(new_state))
    return _JAX[schedule]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("checkpoint", ["always", "except_last", "never"])
def test_skip_across_stages_matches_jax(data, schedule, checkpoint):
    (params, states), jloss, jgrads, jstates = _jax_run(data, schedule)
    x, y = data
    layers = layers_from_jax(_torch_layers(), params, states)
    kw = dict(schedule="1f1b", loss_reduction="mean") if schedule == "1f1b" else {}
    model = GPipe(layers, BALANCE, devices=["cpu"], chunks=CHUNKS,
                  checkpoint=checkpoint, **kw)
    (key,) = model.skip_layout.by_key
    assert model.skip_layout.by_key[key] == (0, 2)
    loss, _, aux = model.value_and_grad(nchw(x), torch.from_numpy(y).long(),
                                        torch_mean_loss)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    assert_grads_match(layers, jgrads, GRAD_REL_TOL)
    assert_buffers_match(layers, jstates, BUF_REL_TOL)
    if schedule == "1f1b":
        assert aux == [None] * CHUNKS


def test_skip_stash_is_the_stage_input():
    """A stage that starts with the stash sends its own input leaf as
    the skip: both cotangents (the activation's and the skip's) reach
    the stage before it; the result equals the unpipelined model."""
    torch.manual_seed(0)
    ns = tskip.Namespace()
    layers = [tnn.Dense(4, 4, name="d0", device="cpu"), tskip.stash("s", ns=ns),
              tnn.ReLU(), tnn.Dense(4, 4, name="d1", device="cpu"),
              tskip.pop_add("s", ns=ns)]
    x = torch.randn(6, 4)
    plain = tskip.SkipSequential(*layers)
    plain(x).square().sum().backward()
    want = [p.grad.clone() for p in plain.parameters()]
    model = GPipe(layers, [1, 2, 2], devices=["cpu"], chunks=3)
    model.value_and_grad(x, None, lambda out, _: out.square().sum())
    for got, w in zip(model.parameters(), want):
        torch.testing.assert_close(got.grad, w, rtol=1e-6, atol=1e-6)
