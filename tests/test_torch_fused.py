"""``GPipe(fused=True)`` and ``make_train_step(megastep=K)`` against the
JAX reference and against the port's own per-cell path.

On the CPU no graph exists: a fused pipe runs the same step body
eagerly, so these tests hold its semantics (the card's replays are
held to the eager step by tests/test_torch_cuda_training.py and
chip_smoke.py phase 12).  The model is tests/test_fused.py's without
its dropout: a convolution, a skip across a BatchNorm and a second
convolution, pooling and a classifier, at balance [4, 3, 1] with a
ragged batch (7 = 3 + 2 + 2) crossing the skip.

Against the reference's fused ``GPipe`` (whose tests/test_fused.py
runs green on jax 0.9.0): the constructor's refusals word for word,
and loss, gradients and BatchNorm buffers.  Tolerances as
tests/test_torch_skip.py argues for this model: both sides compute the
same float32 network in another summation order, ~1e-7 relative per
operation; the loss to 1e-5 relative, each gradient leaf to 1e-4 of
its max |value|, each buffer to 1e-5 of max(|value|, 1).  Against the
port's per-cell path: bitwise.

The megastep's skip-step is held to the port's own single steps, in
which the test itself skips the non-finite step (snapshot, step,
restore): the reference's
``test_megastep::test_gpipe_fused_megastep_matches_guarded_single_steps``
fails on jax 0.9.0 and the port has no StepGuard yet (ROADMAP A.5.3).
Bitwise: a skipped step must leave everything exactly as it was, and a
kept one must be exactly the single step.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import named
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu.skip import pop_add as jpop_add
from torchgpipe_tpu.skip import stash as jstash
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import gpipe as tgpipe
from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm, convert_deferred_batch_norm
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.precision import unwrap
from torchgpipe_tpu_torch.skip import Namespace
from torchgpipe_tpu_torch.skip import pop_add as tpop_add
from torchgpipe_tpu_torch.skip import stash as tstash
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

BALANCE, CHUNKS = [4, 3, 1], 3
LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL = 1e-5, 1e-4, 1e-5


def _torch_layers(seed=0):
    gen = torch.Generator().manual_seed(seed)
    ns = Namespace()
    return [tnn.conv2d(3, 8, (3, 3), name="c1", device="cpu", generator=gen),
            tstash("res", ns=ns), tnn.batch_norm(8, name="bn1", device="cpu"),
            tnn.relu(), tnn.conv2d(8, 8, (3, 3), name="c2", device="cpu", generator=gen),
            tpop_add("res", ns=ns), tnn.global_avg_pool(),
            tnn.dense(8, 5, name="head", device="cpu", generator=gen)]


def _jax_layers():
    return named([jnn.conv2d(8, (3, 3), name="c1"), jstash("res"),
                  jnn.batch_norm(name="bn1"), jnn.relu(),
                  jnn.conv2d(8, (3, 3), name="c2"), jpop_add("res"),
                  jnn.global_avg_pool(), jnn.dense(5, name="head")])


def _data(seed, n=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 5, (n,)).astype(np.int32))


def _state(pipe, optimizers=()):
    """Every parameter, buffer and optimizer state tensor, cloned."""
    out = [t.detach().clone() for t in pipe.parameters()]
    out += [t.clone() for t in pipe.buffers()]
    out += [v.clone() for opt in optimizers for st in opt.state.values()
            for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _assert_bitwise(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
            and torch.equal(x.nan_to_num(), y.nan_to_num())), f"{what}: tensor {i}"


# ---------------------------------------------------------------------- #
# the constructor's refusals                                             #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("kwargs", [
    {"fused": True, "schedule": "1f1b", "loss_reduction": "mean"},
    {"fused": True, "devices": 2},
    {"fused": True, "tracer": object()},
    {"fused": True, "checkpoint": "offload"},
    {"checkpoint": "offload", "schedule": "1f1b", "loss_reduction": "mean"},
    {"megastep": 2},
    {"megastep": 0}, {"megastep": True}, {"megastep": 1.5},
])
def test_fused_validation_matches_jax(kwargs):
    kwargs = dict(kwargs)
    two = kwargs.pop("devices", None) == 2
    jdev = jax.devices()[:2] if two else [jax.devices()[0]]
    tdev = ["cpu", "meta"] if two else ["cpu"]
    with pytest.raises(ValueError) as je:
        JGPipe(_jax_layers(), BALANCE, chunks=CHUNKS, devices=jdev, **kwargs)
    with pytest.raises(ValueError) as te:
        GPipe(_torch_layers(), BALANCE, chunks=CHUNKS, devices=tdev, **kwargs)
    assert str(te.value) == str(je.value)


def test_fused_accepts_what_the_reference_accepts():
    pipe = GPipe(_torch_layers(), BALANCE, chunks=CHUNKS, devices=["cpu"], fused=True,
                 megastep=4, deferred_batch_norm=True, compute_dtype=torch.bfloat16)
    assert pipe.fused and pipe.megastep == 4
    jpipe = JGPipe(_jax_layers(), BALANCE, chunks=CHUNKS, devices=[jax.devices()[0]],
                   fused=True, megastep=4)
    for k in range(10):
        assert pipe.megastep_boundary(k) == jpipe.megastep_boundary(k)


# ---------------------------------------------------------------------- #
# the fused step                                                         #
# ---------------------------------------------------------------------- #

_JAX = {}


def _jax_fused(checkpoint):
    if checkpoint not in _JAX:
        x, y = _data(0)
        params, states = jax_trees(_torch_layers())
        pipe = JGPipe(_jax_layers(), BALANCE, chunks=CHUNKS, devices=[jax.devices()[0]],
                      fused=True, checkpoint=checkpoint)
        loss, grads, st, _ = pipe.value_and_grad(
            per_stage(pipe, params), per_stage(pipe, states), jnp.asarray(x),
            jnp.asarray(y), jax_mean_loss)
        out, _ = pipe.apply(per_stage(pipe, params), st, jnp.asarray(x))
        _JAX[checkpoint] = (float(loss), flat(grads), flat(st), np.asarray(out))
    return _JAX[checkpoint]


@pytest.mark.parametrize("checkpoint", ["always", "except_last", "never"])
def test_fused_value_and_grad_matches_jax_and_per_cell(checkpoint):
    x, y = _data(0)
    jloss, jgrads, jstates, jout = _jax_fused(checkpoint)
    runs = []
    for fused in (True, False):
        layers = _torch_layers()
        pipe = GPipe(layers, BALANCE, chunks=CHUNKS, devices=["cpu"], fused=fused,
                     checkpoint=checkpoint)
        loss, grads, _ = pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(),
                                             torch_mean_loss)
        runs.append((loss, [g for s in grads for d in s for g in d.values()],
                     [b.clone() for b in pipe.buffers()], pipe.apply(nchw(x))))
        if fused:
            assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
            assert_grads_match(layers, jgrads, GRAD_REL_TOL)
            assert_buffers_match(layers, jstates, BUF_REL_TOL)
            out = runs[-1][3].numpy()
            np.testing.assert_allclose(out, jout, rtol=0,
                                       atol=GRAD_REL_TOL * np.abs(jout).max())
    (lf, gf, bf, of), (lp, gp, bp, op) = runs
    assert torch.equal(lf, lp) and torch.equal(of, op)
    _assert_bitwise(gf, gp, "grads")
    _assert_bitwise(bf, bp, "buffers")


def test_fused_deferred_bn_commits_once_per_minibatch():
    """Deferred BN under fused and a bfloat16 policy (tests/test_fused.py
    of the reference): each step commits once, from float32 sums, and
    leaves its counters at 0, on the host and in the buffer; two steps
    equal the per-cell path's bitwise."""
    x, y = _data(1, n=6)
    runs = []
    for fused in (True, False):
        pipe = GPipe(_torch_layers(), BALANCE, chunks=CHUNKS, devices=["cpu"],
                     fused=fused, deferred_batch_norm=True,
                     compute_dtype=torch.bfloat16)
        bn = unwrap(pipe[2])
        assert isinstance(bn, DeferredBatchNorm)
        means = []
        for _ in range(2):
            pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(), torch_mean_loss)
            assert int(bn.tracked) == 0 and bn._tracked == 0 and int(bn.count) == 0
            assert bn.sum.dtype == bn.mean.dtype == torch.float32
            means.append(bn.mean.clone())
        assert not torch.equal(means[0], means[1])
        runs.append(_state(pipe))
    _assert_bitwise(runs[0], runs[1], "fused vs per-cell after two steps")
    jpipe = JGPipe(_jax_layers(), BALANCE, chunks=CHUNKS, devices=[jax.devices()[0]],
                   fused=True, deferred_batch_norm=True, compute_dtype=jnp.bfloat16)
    params, states = jax_trees(convert_deferred_batch_norm(_torch_layers(), CHUNKS))
    _, _, st, _ = jpipe.value_and_grad(per_stage(jpipe, params), per_stage(jpipe, states),
                                       jnp.asarray(x), jnp.asarray(y), jax_mean_loss)
    jbn = flat(st)[2]
    assert int(jbn["tracked"]) == 0 and int(jbn["count"]) == 0


# ---------------------------------------------------------------------- #
# make_train_step under fused, and the megastep                          #
# ---------------------------------------------------------------------- #

OPTS = {
    "momentum": functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
    "adam": functools.partial(torch.optim.Adam, lr=1e-2),
}


def _pipes(megastep):
    """A fused megastep pipe and a per-cell pipe on equal weights."""
    layers = convert_deferred_batch_norm(_torch_layers(), 2)
    fused = GPipe(layers, [4, 4], chunks=2, devices=["cpu"], fused=True,
                  megastep=megastep, deferred_batch_norm=True)
    single = GPipe(copy.deepcopy(layers), [4, 4], chunks=2, devices=["cpu"],
                   deferred_batch_norm=True)
    return fused, single


def _stacked(k, nan_at):
    xs, ys = zip(*(_data(10 + i, n=4) for i in range(k)))
    xs = torch.stack([nchw(x) for x in xs])
    for i in nan_at:
        xs[i, 0, 0, 0, 0] = float("nan")
    return xs, torch.stack([torch.from_numpy(y).long() for y in ys])


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("nan_at", [(1,), (0,)])
def test_megastep_skip_step_matches_single_steps(opt, nan_at):
    """``megastep=3`` over two calls (6 inner steps) with a NaN in the
    first call's inner step ``nan_at``: ``finite`` flags it, and losses,
    parameters, optimizer states and BatchNorm buffers are bitwise those
    of six single steps of the per-cell path in which the test skips
    that step.  A NaN at step 0 hits a fresh optimizer, whose state the
    skipped step must not leave behind."""
    k = 3
    fused, single = _pipes(k)
    step = fused.make_train_step(OPTS[opt], torch_mean_loss)
    assert step.megastep == k
    one = single.make_train_step(OPTS[opt], torch_mean_loss)
    calls = [_stacked(k, nan_at), _stacked(k, ())]
    got_losses, got_finite = [], []
    for xs, ys in calls:
        losses, aux, finite = step(xs, ys)
        assert aux is None and losses.shape == finite.shape == (k,)
        got_losses += list(losses)
        got_finite += finite.tolist()
    want_losses = []
    for c, (xs, ys) in enumerate(calls):
        for i in range(k):
            skip = c == 0 and i in nan_at
            before = _state(single, one.optimizers)
            had = [dict(o.state) for o in one.optimizers]
            loss, _ = one(xs[i], ys[i])
            want_losses.append(loss)
            if skip:
                with torch.no_grad():
                    for t, s in zip(_live(single, one.optimizers, before), before):
                        t.copy_(s)
                for o, h in zip(one.optimizers, had):
                    for p in [p for p in o.state if p not in h]:
                        del o.state[p]
    assert got_finite == [i not in nan_at for i in range(k)] + [True] * k
    _assert_bitwise(got_losses, want_losses, "losses")
    _assert_bitwise(_state(fused, step.optimizers), _state(single, one.optimizers),
                    "parameters, buffers and optimizer states")


def _live(pipe, optimizers, like):
    """The live tensors in :func:`_state`'s order (optimizer state that
    existed when ``like`` was taken)."""
    live = list(pipe.parameters()) + list(pipe.buffers())
    live += [v for opt in optimizers for st in opt.state.values()
             for v in st.values() if isinstance(v, torch.Tensor)]
    return live[:len(like)]


def test_fused_train_step_matches_per_cell():
    fused, single = _pipes(1)
    step = fused.make_train_step(OPTS["momentum"], torch_mean_loss)
    one = single.make_train_step(OPTS["momentum"], torch_mean_loss)
    for i in range(3):
        x, y = _data(20 + i, n=4)
        a = step(nchw(x), torch.from_numpy(y).long())[0]
        b = one(nchw(x), torch.from_numpy(y).long())[0]
        assert torch.equal(a, b)
    _assert_bitwise(_state(fused, step.optimizers), _state(single, one.optimizers),
                    "after three steps")
    assert fused.graph_stats == {"captures": 0, "capture_s": 0.0, "replays": 0}


def test_megastep_input_and_optimizer_checks():
    fused, _ = _pipes(3)
    step = fused.make_train_step(OPTS["momentum"], torch_mean_loss)
    xs, ys = _stacked(2, ())
    jpipe = JGPipe(_jax_layers(), [4, 4], chunks=2, devices=[jax.devices()[0]],
                   fused=True, megastep=3)
    jstep = jpipe.make_train_step(None, jax_mean_loss)
    params, states = jax_trees(_torch_layers())
    with pytest.raises(ValueError) as je:
        jstep(per_stage(jpipe, params), (), per_stage(jpipe, states),
              jnp.zeros((2, 4, 8, 8, 3)), jnp.zeros((2, 4), jnp.int32))
    with pytest.raises(ValueError) as te:
        step(xs, ys)
    assert str(te.value) == str(je.value).replace("jnp.stack", "torch.stack")
    # A graph holds the optimizer step, so a step count on the host
    # cannot be part of it: such an optimizer must be built capturable.
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="capturable=True"):
        tgpipe._check_capturable([torch.optim.AdamW(p)])
    tgpipe._check_capturable([torch.optim.AdamW(p, capturable=True),
                              torch.optim.SGD(p, lr=0.1, momentum=0.9)])
