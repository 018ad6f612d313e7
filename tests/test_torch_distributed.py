"""torchgpipe_tpu_torch.distributed against the JAX reference and the
port's own single-process GPipe.

Every rank of a pipeline lives in this process over a ``LocalTransport``
and the ranks are driven one after another (forward rank by rank, the
loss on the last, backward in reverse), as
tests/distributed/test_distributed_gpipe.py drives the reference's.  Two
models: an MLP whose skip is stashed on rank 0 and popped on rank 2
(it crosses rank 1), and a 2-block narrow Llama; both take the
reference's weights (``convert.layers_from_jax``,
``convert.params_from_jax``).

Tolerances against JAX are those of tests/test_torch_gpipe.py: the same
float32 network in another summation order, so the loss agrees to 1e-5
relative and each gradient leaf to 1e-4 of its own max |value|.  Against
the port's ``GPipe`` the ranks run the same cell bodies on the same
micro-batches in the same order: loss and gradients must be bitwise
equal, dropout masks included.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.distributed import DistributedGPipe as JDistributedGPipe
from torchgpipe_tpu.distributed import LocalTransport as JLocalTransport
from torchgpipe_tpu import skip as jskip
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import skip as tskip
from torchgpipe_tpu_torch.convert import layers_from_jax, params_from_jax
from torchgpipe_tpu_torch.distributed import (
    DistributedGPipe,
    DistributedGPipeDataLoader,
    LocalTransport,
    PeerDiedError,
    worker,
)
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.resilience import faults
from tests.torch_parity import assert_grads_match

LOSS_RTOL = 1e-5
GRAD_REL_TOL = 1e-4
WORKERS = ["w0", "w1", "w2"]
MODES = ["never", "except_last", "always"]
KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
MLP_BALANCE = [3, 2, 2]
LLAMA_BALANCE = [2, 2]


def _jax_mlp():
    return [jnn.dense(16, name="fc1"), jnn.relu("r1"), jskip.stash("x", name="s"),
            jnn.dense(16, name="fc2"), jnn.relu("r2"), jskip.pop_add("x", name="p"),
            jnn.dense(4, name="fc3")]


def _torch_mlp(dropout=0.0):
    gen = torch.Generator().manual_seed(0)

    def dense(i, o, name):
        return tnn.Dense(i, o, name=name, device="cpu", generator=gen)

    layers = [dense(8, 16, "fc1"), tnn.ReLU("r1"), tskip.stash("x", name="s"),
              dense(16, 16, "fc2"), tnn.ReLU("r2"), tskip.pop_add("x", name="p"),
              dense(16, 4, "fc3")]
    if dropout:
        layers.insert(4, tnn.Dropout(dropout, name="drop"))
    return layers


def _mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def _lm_loss(out, tokens):
    return tt.cross_entropy(out[:, :-1], tokens[:, 1:])


def _jlm_loss(out, tokens):
    return jt.cross_entropy(out[:, :-1], tokens[:, 1:])


def _torch_ranks(layers, balance, chunks, transport=None, **kw):
    transport = transport or LocalTransport()
    names = WORKERS[:len(balance)]
    return [DistributedGPipe(layers, r, names, balance, chunks=chunks,
                             transport=transport, mailbox=transport.register(names[r]),
                             device="cpu", **kw)
            for r in range(len(balance))]


def _torch_step(ranks, x, y, loss_fn, rng=None):
    outs = None
    for r, rank in enumerate(ranks):
        res = rank.forward(x if r == 0 else None, rng=rng)
        if rank.is_last:
            outs = res
    loss, gys, aux = ranks[-1].loss_grads(outs, y, loss_fn)
    grads = {}
    for rank in reversed(ranks):
        grads[rank.rank] = rank.backward(gys if rank.is_last else None)[0]
    return loss, grads, aux


def _jax_ranks(layers, balance, chunks, x, **kw):
    transport = JLocalTransport()
    names = WORKERS[:len(balance)]
    ranks = []
    for r in range(len(balance)):
        rank = JDistributedGPipe(layers, r, names, balance, chunks=chunks,
                                 transport=transport, mailbox=transport.register(names[r]),
                                 **kw)
        rank._params, rank._state = rank.init(
            jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, x.dtype))
        ranks.append(rank)
    return ranks


def _jax_step(ranks, x, y, loss_fn):
    outs = None
    for r, rank in enumerate(ranks):
        res = rank.forward(rank._params, rank._state, x if r == 0 else None)
        if rank.is_last:
            outs = res
    loss, gys, _ = ranks[-1].loss_grads(outs, y, loss_fn)
    grads = {}
    for rank in reversed(ranks):
        grads[rank.rank] = rank.backward(gys if rank.is_last else None)[0]
    flat_grads = [jax.tree_util.tree_map(np.asarray, g) for r in range(len(ranks))
                  for g in grads[r]]
    return float(loss), flat_grads


def _flat_params(ranks):
    return [jax.tree_util.tree_map(np.asarray, p) for rank in ranks for p in rank._params]


def _mlp_data():
    rng = np.random.default_rng(1)
    return rng.standard_normal((6, 8)).astype(np.float32), \
        rng.standard_normal((6, 4)).astype(np.float32)


@pytest.mark.parametrize("checkpoint", MODES)
def test_mlp_with_cross_rank_skip_matches_jax(checkpoint):
    x, y = _mlp_data()
    jranks = _jax_ranks(_jax_mlp(), MLP_BALANCE, 2, jnp.asarray(x), checkpoint=checkpoint)
    jloss, jgrads = _jax_step(jranks, jnp.asarray(x), jnp.asarray(y),
                              lambda o, t: jnp.mean((o - t) ** 2))
    layers = _torch_mlp()
    layers_from_jax(layers, _flat_params(jranks), [()] * len(layers))
    ranks = _torch_ranks(layers, MLP_BALANCE, 2, checkpoint=checkpoint)
    assert ranks[0].stage.ext_stash_keys and ranks[2].stage.ext_pop_keys
    loss, _, _ = _torch_step(ranks, torch.from_numpy(x), torch.from_numpy(y), _mse)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_match(layers, jgrads, GRAD_REL_TOL)


@pytest.mark.parametrize("checkpoint", MODES)
def test_llama_matches_jax(checkpoint):
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (5, 16)).astype(np.int32)
    jranks = _jax_ranks(jt.llama(JCFG), LLAMA_BALANCE, 3, jnp.asarray(tokens),
                        checkpoint=checkpoint)
    jloss, jgrads = _jax_step(jranks, jnp.asarray(tokens), jnp.asarray(tokens), _jlm_loss)
    model = params_from_jax(TCFG, _flat_params(jranks), device="cpu")
    ranks = _torch_ranks(list(model), LLAMA_BALANCE, 3, checkpoint=checkpoint)
    t = torch.from_numpy(tokens)
    loss, grads, _ = _torch_step(ranks, t, t, _lm_loss)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    for i, layer in enumerate(model):
        for name, p in layer.params().items():
            want = jgrads[i][name]
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=GRAD_REL_TOL * np.abs(want).max(),
                                       err_msg=f"layer {i} {name}")
    # backward's return value is the ranks' .grad, layer by layer.
    assert grads[0][0]["table"] is model[0].table.grad


def _gpipe_step(layers, balance, chunks, x, y, loss_fn, rng=None, **kw):
    pipe = GPipe(layers, balance, devices=["cpu"], chunks=chunks, **kw)
    loss, _, _ = pipe.value_and_grad(x, y, loss_fn, rng=rng)
    return loss, [p.grad.clone() for p in pipe.parameters()]


def _bitwise(loss, grads, layers, want_loss, want_grads):
    assert torch.equal(loss, want_loss), (float(loss), float(want_loss))
    got = [p.grad for layer in layers for p in layer.parameters()]
    assert len(got) == len(want_grads)
    for g, w in zip(got, want_grads):
        assert torch.equal(g, w)


@pytest.mark.parametrize("checkpoint", MODES)
@pytest.mark.parametrize("batch", [6, 3])   # 3 with chunks 4: a ragged batch
def test_mlp_with_dropout_equals_gpipe_bitwise(checkpoint, batch):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((batch, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((batch, 4)).astype(np.float32))
    want_loss, want = _gpipe_step(_torch_mlp(0.25), [3, 3, 2], 4, x, y, _mse, rng=7,
                                  checkpoint=checkpoint)
    layers = _torch_mlp(0.25)
    ranks = _torch_ranks(layers, [3, 3, 2], 4, checkpoint=checkpoint)
    loss, _, _ = _torch_step(ranks, x, y, _mse, rng=7)
    _bitwise(loss, None, layers, want_loss, want)


@pytest.mark.parametrize("checkpoint", MODES)
def test_llama_equals_gpipe_bitwise(checkpoint):
    def build():
        return list(tt.llama(TCFG, device="cpu", generator=torch.Generator().manual_seed(3)))

    t = torch.from_numpy(np.random.default_rng(3).integers(0, KW["vocab"], (5, 16)))
    want_loss, want = _gpipe_step(build(), [1, 2, 1], 4, t, t, _lm_loss,
                                  checkpoint=checkpoint)
    layers = build()
    ranks = _torch_ranks(layers, [1, 2, 1], 4, checkpoint=checkpoint)
    loss, _, _ = _torch_step(ranks, t, t, _lm_loss)
    _bitwise(loss, None, layers, want_loss, want)


def test_poisoned_cell_reaches_the_loss():
    layers = _torch_mlp()
    ranks = _torch_ranks(layers, MLP_BALANCE, 2)
    x, y = (torch.from_numpy(a) for a in _mlp_data())
    with faults.inject(nan_at=(1, 0)):
        loss, _, _ = _torch_step(ranks, x, y, _mse)
    assert torch.isnan(loss)
    loss, _, _ = _torch_step(ranks, x, y, _mse)
    assert torch.isfinite(loss)


def test_loss_fn_aux_and_eval_forward():
    layers = _torch_mlp()
    ranks = _torch_ranks(layers, MLP_BALANCE, 2)
    x, y = (torch.from_numpy(a) for a in _mlp_data())

    def loss_with_aux(out, tgt):
        return _mse(out, tgt), {"mae": (out - tgt).abs().mean()}

    _, _, aux = _torch_step(ranks, x, y, loss_with_aux)
    assert torch.isfinite(aux["mae"])
    outs = None
    for r, rank in enumerate(ranks):
        outs = rank.forward(x if r == 0 else None, train=False)
    assert [tuple(o.shape) for o in outs] == [(3, 4), (3, 4)]
    assert not outs[0].requires_grad
    with pytest.raises(RuntimeError, match="eval-mode forward"):
        ranks[-1].backward([torch.zeros_like(o) for o in outs])


def test_training_converges():
    layers = _torch_mlp()
    ranks = _torch_ranks(layers, MLP_BALANCE, 2)
    x, y = (torch.from_numpy(a) for a in _mlp_data())
    opts = [torch.optim.SGD(list(rank.parameters()), lr=0.1) for rank in ranks]
    losses = []
    for _ in range(8):
        loss, _, _ = _torch_step(ranks, x, y, _mse)
        for opt in opts:
            opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses


# ---------------------------------------------------------------------- #
# the reference's cases (tests/distributed/test_distributed_gpipe.py)    #
# ---------------------------------------------------------------------- #


def test_dataloader_roles():
    transport = LocalTransport()
    boxes = {name: transport.register(name) for name in WORKERS}
    data = [(torch.ones(4, 2) * i, torch.full((4,), i)) for i in range(3)]
    rank0 = DistributedGPipeDataLoader(data, 0, WORKERS, transport=transport,
                                       mailbox=boxes["w0"])
    out0 = list(rank0)
    assert all(t is None for _, t in out0)
    assert [float(d[0, 0]) for d, _ in out0] == [0.0, 1.0, 2.0]
    mid = DistributedGPipeDataLoader(None, 1, WORKERS, transport=transport,
                                     mailbox=boxes["w1"], num_batches=3)
    assert list(mid) == [(None, None)] * 3
    last = DistributedGPipeDataLoader(None, 2, WORKERS, transport=transport,
                                      mailbox=boxes["w2"], num_batches=3)
    outl = list(last)
    assert all(d is None for d, _ in outl)
    assert [float(t[0]) for _, t in outl] == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="num_batches"):
        DistributedGPipeDataLoader(None, 1, WORKERS, transport=transport,
                                   mailbox=boxes["w1"])


def test_worker_context_manager_unregisters():
    transport = LocalTransport()
    with worker(transport, "w0") as box:
        transport.send("w0", "forward", 0, 42)
        assert box.get("forward", 0) == 42
    assert not transport.is_alive("w0")
    with worker(transport, "w0"):
        pass


def test_forward_backward_api_misuse():
    ranks = _torch_ranks(_torch_mlp(), [3, 4], 2)
    x = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="before forward"):
        ranks[0].backward(None)
    with pytest.raises(ValueError, match="rank 0 must be given"):
        ranks[0].forward(None)
    with pytest.raises(ValueError, match="only rank 0"):
        ranks[1].forward(x)
    with pytest.raises(RuntimeError, match="only meaningful on the last rank"):
        ranks[0].loss_grads([x], x, _mse)


@pytest.mark.parametrize("kw,match", [
    (dict(balance=[3, 4], workers=WORKERS), "2 stages but workers names 3"),
    (dict(rank=3), "out of range"),
    (dict(chunks=0), "positive integer"),
    (dict(checkpoint="sometimes"), "checkpoint is not one of"),
    (dict(checkpoint="offload"), "not supported by the distributed"),
    (dict(first_step_grace=5.0), "recv_timeout"),
    (dict(recv_timeout=1.0, first_step_grace=0.0), "positive"),
])
def test_constructor_checks(kw, match):
    transport = LocalTransport()
    args = dict(rank=0, workers=WORKERS[:2], balance=[3, 4], chunks=2,
                transport=transport, mailbox=transport.register("w0"), device="cpu")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        DistributedGPipe(_torch_mlp(), **args)


def test_recv_timeout_names_the_channel_and_a_dead_peer():
    transport = LocalTransport()
    rank1 = DistributedGPipe(_torch_mlp(), 1, WORKERS, MLP_BALANCE, chunks=2,
                             transport=transport, mailbox=transport.register("w1"),
                             device="cpu", recv_timeout=0.2)
    # w0 never registered: the probe finds it gone.
    with pytest.raises(PeerDiedError, match="peer rank 0 .'w0'. is dead.*meta") as err:
        rank1.forward()
    assert err.value.rank == 0 and err.value.worker == "w0"


def test_first_step_timeout_names_the_grace():
    transport = LocalTransport()
    transport.register("w0")   # alive but silent: a bare timeout
    rank1 = DistributedGPipe(_torch_mlp(), 1, WORKERS, MLP_BALANCE, chunks=2,
                             transport=transport, mailbox=transport.register("w1"),
                             device="cpu", recv_timeout=0.2)
    with pytest.raises(TimeoutError, match="first_step_grace") as err:
        rank1.forward()
    assert not isinstance(err.value, PeerDiedError)


def test_first_step_grace_extends_the_cold_deadline_only():
    ranks = _torch_ranks(_torch_mlp(), MLP_BALANCE, 2, recv_timeout=0.2,
                         first_step_grace=30.0)
    for rank in ranks:
        assert rank._effective_timeout() == pytest.approx(30.2)
    x, y = (torch.from_numpy(a) for a in _mlp_data())
    _torch_step(ranks, x, y, _mse)
    for rank in ranks:
        assert rank._warmed
        assert rank._effective_timeout() == pytest.approx(0.2)


def test_send_to_a_dead_peer_names_it():
    transport = LocalTransport()
    rank0 = DistributedGPipe(_torch_mlp(), 0, WORKERS[:2], [3, 4], chunks=2,
                             transport=transport, mailbox=transport.register("w0"),
                             device="cpu")

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def send(self, dst, kind, index, payload):
            raise ConnectionRefusedError(f"{dst} refused")

        def is_alive(self, name):
            return name == "w0"

    rank0.transport = Refusing(transport)
    with pytest.raises(PeerDiedError, match="peer rank 1 .'w1'. is dead.*'meta'"):
        rank0.forward(torch.zeros(4, 8))


def test_prefetch_to_pipe_places_batches_where_the_pipe_takes_them():
    from torchgpipe_tpu_torch.utils import data

    pipe = GPipe(_torch_mlp(), MLP_BALANCE, devices=["cpu"], chunks=2)
    rank = _torch_ranks(_torch_mlp(), MLP_BALANCE, 2)[1]
    assert data.pipe_data_sharding(pipe) == torch.device("cpu")
    assert data.pipe_data_sharding(rank, stacked=True) == rank.device
    x, y = _mlp_data()
    got = list(data.prefetch_to_pipe([(x, y), (x, y)], pipe, size=1))
    assert len(got) == 2 and torch.equal(got[1][0], torch.from_numpy(x))
    with pytest.raises(TypeError, match="takes a GPipe"):
        data.pipe_data_sharding(object())
    # A one-process mesh stand-in: the global batch of a replicated spec is
    # the local one; an axis the mesh lacks is refused.
    mesh = types.SimpleNamespace(axis_names=("pp", "dp"), shape={"pp": 1, "dp": 1},
                                 device=torch.device("cpu"), all_gather=lambda t, a: [t])
    xt = torch.from_numpy(x)
    assert torch.equal(data.global_batch_from_local(mesh, None, xt), xt)
    with pytest.raises(ValueError, match="names axis 'tp'"):
        data.global_batch_from_local(mesh, ("tp",), xt)
