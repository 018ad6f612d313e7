"""torchgpipe_tpu_torch's ResNet, BatchNorm and deferred BatchNorm against
the JAX reference.

``build_resnet([1, 1, 1, 1], 10, base_width=4)`` at 32x32 (50 layers)
from one seeded set of weights (the port's, handed to the reference as
its trees; ``convert.layers_from_jax`` is held to the reference's init
structure on its own), through a
3-stage pipeline whose two cuts fall inside bottlenecks (the identity of
``layer1_b1`` and of ``layer3_b1`` cross a stage boundary): the forward,
the loss, every gradient and every BatchNorm buffer, plain and deferred
(after one and after two steps, with the downsample's BatchNorm inside
the residual layer), against the reference ``GPipe`` on the same numpy
batch.  ``len(resnet101())`` equals the reference's.

Sizes.  Batch 12 in 3 micro-batches of 4: at 32x32 the last group runs
at 1x1, where a BatchNorm sees 4 values per channel.  With 2 values a
channel's pair can nearly coincide, and 1/sqrt(var + eps) then magnifies
float32 rounding up to 316-fold, so no two summation orders agree there.

Tolerances.  Both sides compute the same float32 network in another
summation order (convolutions over up to 576 terms, BatchNorm statistics
over 4-4096 values, micro-batch sums in another grouping), ~1e-7
relative per op; the gradients pass back through 16 BatchNorms, each of
which can scale an error by its 1/std.  Loss to 1e-5 relative; each
gradient leaf to 1e-4 of its max |value|; running statistics to 1e-5 of
max(|value|, 1); deferred counters exactly; logits to 1e-4 of their max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.models import resnet as jresnet
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.batchnorm import (
    DeferredBatchNorm,
    convert_deferred_batch_norm,
)
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.models import resnet as tresnet
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

LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL, LOGIT_REL_TOL = 1e-5, 1e-4, 1e-5, 1e-4
BATCH, CHUNKS, BALANCE = 12, 3, [7, 20, 23]
BLOCKS, CLASSES, WIDTH = [1, 1, 1, 1], 10, 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (BATCH,)).astype(np.int32)
    return x, y


_JAX = {}


def _torch_layers(deferred, seed=0):
    layers = list(tresnet.build_resnet(BLOCKS, CLASSES, base_width=WIDTH, device="cpu",
                                       generator=torch.Generator().manual_seed(seed)))
    return convert_deferred_batch_norm(layers, CHUNKS) if deferred else layers


def _jax_run(data, deferred):
    """The reference ``GPipe`` from the port's seeded weights: its eval
    forward and two value_and_grad steps (state threaded, params fixed).
    Its checkpoint modes compute one function (a recompute's state is
    discarded), so it runs under 'never', the fewest programs to
    compile."""
    if deferred not in _JAX:
        x, y = data
        params, states = jax_trees(_torch_layers(deferred))
        pipe = JGPipe(jresnet.build_resnet(BLOCKS, CLASSES, base_width=WIDTH),
                      BALANCE, chunks=CHUNKS, checkpoint="never",
                      deferred_batch_norm=deferred)
        jparams, st = per_stage(pipe, params), per_stage(pipe, states)
        # Only the plain model's eval forward is compared.
        logits = None if deferred else np.asarray(pipe.apply(jparams, st, jnp.asarray(x))[0])
        steps = []
        for _ in range(2):
            loss, grads, st, _ = pipe.value_and_grad(
                jparams, st, jnp.asarray(x), jnp.asarray(y), jax_mean_loss)
            steps.append((float(loss), flat(grads), flat(st)))
        _JAX[deferred] = (params, states, logits, steps)
    return _JAX[deferred]


def test_resnet101_has_the_reference_length_and_names():
    ours = tresnet.resnet101(device="meta")
    ref = jresnet.resnet101()
    assert len(ours) == len(ref) == 369
    assert [layer.name for layer in ours] == [layer.name for layer in ref]
    assert len(tresnet.resnet50(device="meta")) == len(jresnet.resnet50())


def test_pipelined_forward_matches_jax(data):
    _, states, logits, _ = _jax_run(data, deferred=False)
    model = GPipe(_torch_layers(False), BALANCE, devices=["cpu"], chunks=CHUNKS)
    out = model.apply(nchw(data[0]))
    assert out.shape == (BATCH, CLASSES) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), logits, rtol=0,
                               atol=LOGIT_REL_TOL * np.abs(logits).max())
    # Eval mode reads the running statistics and updates none of them.
    assert torch.equal(model[1].mean, torch.from_numpy(states[1]["mean"]))


@pytest.mark.parametrize("deferred", [False, True])
def test_layers_from_jax_round_trip(deferred):
    """``convert.layers_from_jax`` loads the reference's trees (HWIO
    kernels, BatchNorm params and state, the downsample chain's tuples)
    into another seed's model; both then hold the same tensors.  The
    trees have the structure of the reference's own init."""
    from torchgpipe_tpu.batchnorm import convert_deferred_batch_norm as jconvert
    from torchgpipe_tpu.layers import sequential_init

    src, dst = _torch_layers(deferred, seed=0), _torch_layers(deferred, seed=1)
    params, states = jax_trees(src)
    jl = jresnet.build_resnet(BLOCKS, CLASSES, base_width=WIDTH)
    jl = jconvert(jl, CHUNKS) if deferred else jl
    jp, js, _ = jax.eval_shape(lambda: sequential_init(
        jl, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32)))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jp)
    assert jax.tree_util.tree_structure(states) == jax.tree_util.tree_structure(js)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jp)):
        assert a.shape == b.shape
    layers_from_jax(dst, params, states)
    for a, b in zip(src, dst):
        for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert na == nb and torch.equal(ta, tb), na
    with pytest.raises(ValueError, match="deferred_batch_norm on one side only"):
        layers_from_jax(_torch_layers(not deferred), params, states)


@pytest.mark.parametrize("checkpoint", ["always", "except_last", "never"])
@pytest.mark.parametrize("deferred", [False, True])
def test_value_and_grad_and_bn_state_match_jax(data, deferred, checkpoint):
    """Two steps: the gradients of each, and every buffer after each.
    Under 'always' every cell recomputes: a BatchNorm that tracked in its
    recompute would count each micro-batch twice."""
    _, _, _, steps = _jax_run(data, deferred)
    layers = _torch_layers(deferred)
    model = GPipe(layers, BALANCE, devices=["cpu"], chunks=CHUNKS,
                  checkpoint=checkpoint, deferred_batch_norm=deferred)
    crossing = sorted(v for v in model.skip_layout.by_key.values() if v[0] != v[1])
    assert crossing == [(0, 1), (1, 2)]
    x, y = nchw(data[0]), torch.from_numpy(data[1]).long()
    for jloss, jgrads, jstates in steps:
        loss, _, _ = model.value_and_grad(x, y, torch_mean_loss)
        np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
        assert_grads_match(layers, jgrads, GRAD_REL_TOL)
        assert_buffers_match(layers, jstates, BUF_REL_TOL)
    if deferred:
        down_bn = layers[13].down[1]
        assert isinstance(down_bn, DeferredBatchNorm) and down_bn._tracked == 0


def test_deferred_short_batch_rejected_as_in_jax(data):
    model = GPipe(_torch_layers(True), BALANCE, devices=["cpu"], chunks=CHUNKS,
                  deferred_batch_norm=True)
    x = nchw(data[0][:2])                       # 2 rows: 2 < 3 micro-batches
    with pytest.raises(ValueError, match="deferred_batch_norm requires the batch "
                       "to split into exactly chunks=3 micro-batches, got 2"):
        model.value_and_grad(x, torch.zeros(2, dtype=torch.long), torch_mean_loss)


def test_deferred_running_stats_are_the_whole_batch_commit():
    """The reference's own oracle (tests/test_deferred_batch_norm.py):
    after one step the running statistics are one 0.9-momentum commit of
    the whole mini-batch's biased statistics, and the sums are reset."""
    torch.manual_seed(0)
    layers = [tnn.Dense(8, 8, name="d0", device="cpu"),
              tnn.BatchNorm(8, name="bn0", device="cpu"), tnn.ReLU(),
              tnn.Dense(8, 4, name="d1", device="cpu")]
    model = GPipe(layers, [2, 2], devices=["cpu"], chunks=4,
                  deferred_batch_norm=True)
    x, tgt = torch.randn(16, 8), torch.randn(16, 4)
    with torch.no_grad():
        h = layers[0](x)
    var, mean = torch.var_mean(h, 0, correction=0)
    model.value_and_grad(x, tgt, lambda o, t: (o - t).square().mean())
    bn = model[1]
    torch.testing.assert_close(bn.mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    assert int(bn.tracked) == bn._tracked == 0 and int(bn.count) == 0
    assert float(bn.sum.abs().max()) == 0.0


def test_conversion_reaches_compound_layers_and_is_idempotent():
    layers = list(tresnet.build_resnet(BLOCKS, CLASSES, base_width=WIDTH,
                                       device="cpu"))
    conv = convert_deferred_batch_norm(layers, 2)
    assert conv[0] is layers[0]
    assert type(conv[1]) is DeferredBatchNorm and conv[1].name == "bn1"
    assert conv[1].scale is layers[1].scale          # parameters shared
    assert type(conv[13].down[1]) is DeferredBatchNorm   # inside the residual
    again = convert_deferred_batch_norm(conv, 2)
    assert all(a is b for a, b in zip(again, conv))
    with pytest.raises(TypeError, match="not BatchNorm2d"):
        convert_deferred_batch_norm([torch.nn.BatchNorm2d(3)], 2)


def test_recomputed_cells_update_no_running_statistic():
    """Plain BatchNorm under 'always': the forward schedule updates the
    running statistics once per micro-batch; the recomputes do not."""
    torch.manual_seed(1)
    bn = tnn.BatchNorm(3, device="cpu")
    model = GPipe([bn], [1], devices=["cpu"], chunks=2, checkpoint="always")
    x = torch.randn(8, 3)
    model.value_and_grad(x, None, lambda o, _: o.square().sum())
    a, b = (torch.var_mean(part, 0, correction=0) for part in x.split(4))
    mean = 0.9 * (0.9 * 0 + 0.1 * a[1]) + 0.1 * b[1]
    torch.testing.assert_close(bn.mean, mean, rtol=1e-6, atol=1e-7)


def _nn_pairs():
    """(port layer, reference layer) pairs over the padding rules and
    layouts ResNet relies on, and a few it does not reach."""
    from torchgpipe_tpu.ops import nn as jnn

    kw = dict(device="cpu", generator=torch.Generator().manual_seed(3))
    pad = ((1, 2), (0, 1))
    return [
        (tnn.Conv2d(3, 5, (3, 3), strides=(2, 2), name="c", **kw),
         jnn.conv2d(5, (3, 3), strides=(2, 2))),                # SAME, asymmetric
        (tnn.Conv2d(3, 5, (1, 1), strides=(2, 2), name="c", **kw),
         jnn.conv2d(5, (1, 1), strides=(2, 2))),
        (tnn.Conv2d(3, 4, (3, 3), padding="VALID", use_bias=True, name="c", **kw),
         jnn.conv2d(4, (3, 3), padding="VALID", use_bias=True)),
        (tnn.Conv2d(3, 4, (3, 3), padding=pad, name="c", **kw),
         jnn.conv2d(4, (3, 3), padding=pad)),
        (tnn.MaxPool2d((3, 3), (2, 2), padding="SAME"),
         jnn.max_pool2d((3, 3), (2, 2), padding="SAME")),
        (tnn.MaxPool2d((3, 3), (2, 2), padding=((1, 1), (1, 1))),
         jnn.max_pool2d((3, 3), (2, 2), padding=((1, 1), (1, 1)))),
        (tnn.MaxPool2d(2), jnn.max_pool2d(2)),
        (tnn.GlobalAvgPool(), jnn.global_avg_pool()),
        (tnn.Flatten(), jnn.flatten()),
        (tnn.ReLU(), jnn.relu()),
        (tnn.BatchNorm(3, name="bn", device="cpu"), jnn.batch_norm()),
    ]


@pytest.mark.parametrize("index", range(11))
def test_ops_nn_layers_match_jax(index):
    """Each port layer against the reference's on one NHWC batch (8x8,
    where 'SAME' with stride 2 pads one side only): outputs to 1e-5 of
    their max (float32, 27-term sums), BatchNorm's updated running
    statistics too."""
    layer, ref = _nn_pairs()[index]
    x = np.random.default_rng(index).standard_normal((2, 8, 8, 3)).astype(np.float32)
    (params,), (state,) = jax_trees([layer])
    want, new_state = ref.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                jax.tree_util.tree_map(jnp.asarray, state),
                                jnp.asarray(x), rng=None, train=True)
    got = layer(nchw(x)).detach().numpy()
    want = np.asarray(want)
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    for name, buf in layer.named_buffers():
        np.testing.assert_allclose(buf.numpy(), np.asarray(new_state[name]),
                                   rtol=1e-5, atol=1e-6)
