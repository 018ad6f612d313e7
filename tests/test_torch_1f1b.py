"""torchgpipe_tpu_torch's 1F1B schedule against the JAX reference.

``one_f1b_orders`` equal to the reference's; ``value_and_grad`` under
``schedule='1f1b'`` with ``loss_reduction='mean'`` (ragged micro-batches
included) and ``'sum'`` against the reference's 1F1B on the same numpy
inputs and weights; the per-micro-batch aux list; the reference's error
texts; and the per-stage bound on cells in flight, read from the
engine's own dispatch order.

Tolerances, as tests/test_torch_skip.py argues them: the same float32
network summed in another order, so the loss agrees to 1e-5 relative,
each gradient leaf to 1e-4 of its max |value|, each BatchNorm buffer to
1e-5 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import pipeline as jpipe
from torchgpipe_tpu.layers import named
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import pipeline as tpipe
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.ops import nn as tnn
from tests.torch_parity import (
    assert_buffers_match,
    assert_grads_match,
    flat,
    jax_mean_loss,
    jax_sum_loss,
    nchw,
    torch_mean_loss,
    torch_sum_loss,
)

LOSS_RTOL, GRAD_REL_TOL, BUF_REL_TOL = 1e-5, 1e-4, 1e-5
BALANCE = [3, 2, 2]


def _jax_layers():
    return named([
        jnn.conv2d(8, (3, 3), name="c1"),
        jnn.batch_norm(name="bn1"),
        jnn.relu(),
        jnn.conv2d(8, (3, 3), name="c2"),
        jnn.relu(),
        jnn.global_avg_pool(),
        jnn.dense(5, name="head"),
    ])


def _torch_layers():
    kw = dict(device="cpu")
    return [
        tnn.Conv2d(3, 8, (3, 3), name="c1", **kw),
        tnn.BatchNorm(8, name="bn1", **kw),
        tnn.ReLU(),
        tnn.Conv2d(8, 8, (3, 3), name="c2", **kw),
        tnn.ReLU(),
        tnn.GlobalAvgPool(),
        tnn.Dense(8, 5, name="head", **kw),
    ]


@pytest.mark.parametrize("m,n", [(1, 1), (4, 1), (1, 3), (4, 3), (3, 4), (8, 4),
                                 (6, 3)])
def test_one_f1b_orders_match_jax(m, n):
    assert tpipe.one_f1b_orders(m, n) == jpipe.one_f1b_orders(m, n)


@pytest.mark.parametrize("reduction,batch,chunks", [
    ("mean", 8, 4), ("mean", 7, 4), ("sum", 6, 3)])
def test_1f1b_matches_jax(reduction, batch, chunks):
    """``batch`` 7 splits into micro-batches 2, 2, 2, 1: the 'mean'
    weights are 2/7 and 1/7, not 1/4."""
    rng = np.random.default_rng(batch)
    x = rng.standard_normal((batch, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, (batch,)).astype(np.int32)
    jloss_fn, tloss_fn = {"mean": (jax_mean_loss, torch_mean_loss),
                          "sum": (jax_sum_loss, torch_sum_loss)}[reduction]
    kw = dict(chunks=chunks, schedule="1f1b", loss_reduction=reduction)
    # The reference under 'never' (one function in every mode, the fewest
    # programs to compile); the port under 'except_last'.
    ref = JGPipe(_jax_layers(), BALANCE, checkpoint="never", **kw)
    params, state = ref.init(jax.random.PRNGKey(3),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    jloss, jgrads, jstate, jaux = ref.value_and_grad(
        params, state, jnp.asarray(x), jnp.asarray(y), jloss_fn)
    layers = layers_from_jax(_torch_layers(), flat(params), flat(state))
    model = GPipe(layers, BALANCE, devices=["cpu"], checkpoint="except_last", **kw)
    loss, grads, aux = model.value_and_grad(nchw(x), torch.from_numpy(y).long(),
                                            tloss_fn)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert aux == jaux == [None] * len(jaux)
    assert_grads_match(layers, flat(jgrads), GRAD_REL_TOL)
    assert_buffers_match(layers, flat(jstate), BUF_REL_TOL)


def test_1f1b_aux_is_a_list_per_microbatch():
    torch.manual_seed(0)
    model = GPipe([torch.nn.Linear(3, 3), torch.nn.Linear(3, 2)], [1, 1],
                  devices=["cpu"], chunks=3, schedule="1f1b", loss_reduction="sum")

    def loss_with_aux(out, tgt):
        return (out - tgt).square().sum(), {"rows": out.shape[0]}

    x, tgt = torch.randn(7, 3), torch.randn(7, 2)
    loss, _, aux = model.value_and_grad(x, tgt, loss_with_aux)
    assert aux == [{"rows": 3}, {"rows": 3}, {"rows": 1}]
    plain = GPipe(list(model), [1, 1], devices=["cpu"], chunks=3)
    want, _, whole = plain.value_and_grad(x, tgt, loss_with_aux)
    assert whole == {"rows": 7}
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


def _messages(fn_t, fn_j):
    """Equal error texts, up to the array type's name."""
    with pytest.raises(ValueError) as te:
        fn_t()
    with pytest.raises(ValueError) as je:
        fn_j()
    assert str(te.value) == str(je.value).replace("got ArrayImpl", "got Tensor")


@pytest.mark.parametrize("kwargs", [
    dict(schedule="1f1b"), dict(schedule="zigzag"),
    dict(loss_reduction="mean"), dict(schedule="1f1b", loss_reduction="max")])
def test_constructor_errors_match_jax(kwargs):
    _messages(lambda: GPipe(_torch_layers(), BALANCE, devices=["cpu"], chunks=2,
                            **kwargs),
              lambda: JGPipe(_jax_layers(), BALANCE, chunks=2, **kwargs))


def test_nonbatched_target_error_matches_jax():
    x = np.zeros((4, 8, 8, 3), np.float32)
    kw = dict(chunks=2, schedule="1f1b", loss_reduction="mean")
    ref = JGPipe(_jax_layers(), BALANCE, **kw)
    params, state = ref.init(jax.random.PRNGKey(1),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    model = GPipe(_torch_layers(), BALANCE, devices=["cpu"], **kw)
    for tgt in (None, np.zeros(3, np.int32)):
        _messages(
            lambda: model.value_and_grad(
                nchw(x), None if tgt is None else torch.from_numpy(tgt),
                torch_mean_loss),
            lambda: ref.value_and_grad(
                params, state, jnp.asarray(x),
                None if tgt is None else jnp.asarray(tgt), jax_mean_loss))


@pytest.mark.parametrize("m,n", [(6, 3), (8, 4), (2, 3)])
def test_1f1b_cells_in_flight_bound(monkeypatch, m, n):
    """Stage ``j`` never holds more than ``min(m, n - j)`` forwarded cells
    whose backward has not run (fill-drain holds all ``m``), the bound is
    reached on stage 0, and the last stage runs micro-batch 0's backward
    before micro-batch ``m - 1``'s forward."""
    events = []
    fwd, bwd = tpipe._Cells.forward, tpipe._Cells.backward

    def log_fwd(self, i, j, x):
        events.append(("fwd", i, j, len(self.graphs) + len(self.saved)))
        return fwd(self, i, j, x)

    def log_bwd(self, i, j, gy):
        out = bwd(self, i, j, gy)
        events.append(("bwd", i, j, len(self.graphs) + len(self.saved)))
        return out

    monkeypatch.setattr(tpipe._Cells, "forward", log_fwd)
    monkeypatch.setattr(tpipe._Cells, "backward", log_bwd)
    layers = [torch.nn.Linear(4, 4) for _ in range(n)]
    model = GPipe(layers, [1] * n, devices=["cpu"], chunks=m, checkpoint="never",
                  schedule="1f1b", loss_reduction="mean")
    model.value_and_grad(torch.randn(2 * m, 4), torch.randn(2 * m, 4),
                         lambda o, t: (o - t).square().mean())
    in_flight, peak = [0] * n, [0] * n
    for kind, _, j, _ in events:
        in_flight[j] += 1 if kind == "fwd" else -1
        peak[j] = max(peak[j], in_flight[j])
    assert all(peak[j] <= min(m, n - j) for j in range(n)), peak
    assert peak[0] == min(m, n)
    last = [(k, i) for k, i, j, _ in events if j == n - 1]
    assert last.index(("bwd", 0)) < last.index(("fwd", m - 1))
    # Each backward frees its cell: nothing is left after the step.
    assert events[-1][3] == 0
