"""torchgpipe_tpu_torch's GPipe training path against the JAX reference.

A tiny float32 Llama (vocab 256, dim 128, 2 heads of 64, 1 kv head, 2
blocks: 4 layers) is initialised by the reference's ``GPipe.init``,
converted with ``params_from_jax`` and trained one step through both
engines on the CPU, on the same numpy tokens, under the shifted
causal-LM loss of ``benchmarks/llama_speed.py``.  The reference runs on
CPU devices as tests/test_gpipe.py runs it; its attention there is the
dense branch of ``ring_attention.attention``, the same function as the
port's plain flash path.

Tolerances.  Both sides compute the same float32 network in another
summation order (matmuls over 128-384 terms, softmax over 256 logits and
<= 16 keys, micro-batch gradient sums in another grouping): ~1e-7
relative per op, compounding over 4 layers and the backward to ~1e-6 of
each tensor's scale.  The loss must agree to 1e-5 relative and every
gradient leaf to 1e-4 of its own max |value| (an order of magnitude
over what the summation order can explain).  Inference logits: 5e-5
absolute on logits of magnitude ~3 (as tests/test_torch_generation.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import checkpoint as jckpt
from torchgpipe_tpu import microbatch as jmb
from torchgpipe_tpu import partition as jpart
from torchgpipe_tpu import pipeline as jpipe
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import checkpoint as tckpt
from torchgpipe_tpu_torch import microbatch as tmb
from torchgpipe_tpu_torch import partition as tpart
from torchgpipe_tpu_torch import pipeline as tpipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import flash_attention as tfa

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
BATCH, SEQ = 5, 16
LOSS_RTOL = 1e-5
GRAD_REL_TOL = 1e-4
LOGIT_TOL = 5e-5


def jax_causal_lm_loss(out, tokens):
    # benchmarks/llama_speed.py: predict token t+1 from prefix <= t.
    return jt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


def torch_causal_lm_loss(out, tokens):
    return tt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


@pytest.fixture(scope="module")
def reference():
    """Reference params (numpy, flat per layer) and tokens."""
    pipe = JGPipe(jt.llama(JCFG), balance=[4])
    params, state = pipe.init(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)
    )
    flat = [jax.tree_util.tree_map(np.asarray, p) for stage in params for p in stage]
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (BATCH, SEQ))
    return flat, list(state[0]), tokens.astype(np.int32)


def _jax_pipe(reference, balance, **kw):
    """A reference GPipe over ``balance`` holding the shared weights."""
    flat, flat_state, _ = reference
    pipe = JGPipe(jt.llama(JCFG), balance=balance, **kw)
    params, state = [], []
    i = 0
    for n in balance:
        params.append([jax.tree_util.tree_map(jnp.asarray, p) for p in flat[i:i + n]])
        state.append(flat_state[i:i + n])
        i += n
    return pipe, pipe.place(tuple(params)), pipe.place(tuple(state))


def _torch_pipe(flat, balance, **kw):
    return GPipe(
        params_from_jax(TCFG, flat, device="cpu"), balance, devices=["cpu"], **kw
    )


def _assert_leaf_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, atol=GRAD_REL_TOL * np.abs(want).max(),
        rtol=0, err_msg=what,
    )


# ---------------------------------------------------------------------- #
# engine helpers against the reference's                                 #
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("total", [1, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 8])
def test_microbatch_matches_jax(total, chunks):
    assert tmb.chunk_sizes(total, chunks) == jmb.chunk_sizes(total, chunks)
    x = np.arange(total * 3, dtype=np.float32).reshape(total, 3)
    y = np.arange(total, dtype=np.int32)
    jparts = jmb.scatter((jnp.asarray(x), jnp.asarray(y)), chunks)
    tparts = tmb.scatter((torch.from_numpy(x), torch.from_numpy(y)), chunks)
    assert len(tparts) == len(jparts)
    for tp, jp in zip(tparts, jparts):
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tmb.batch_size(tparts[0]) == jmb.batch_size(jparts[0])
    whole = tmb.gather(tmb.scatter(torch.from_numpy(x), chunks))
    np.testing.assert_array_equal(whole.numpy(), x)
    np.testing.assert_array_equal(
        tmb.gather(tparts)[0].numpy(), np.asarray(jmb.gather(jparts)[0])
    )


def test_microbatch_errors_match_jax():
    for bad, exc in [((torch.zeros(2, 3), torch.zeros(3)), ValueError),
                     (torch.tensor(1.0), TypeError), ((), TypeError)]:
        with pytest.raises(exc):
            tmb.check(bad)
    for args in [(0, 2), (4, 0)]:
        with pytest.raises(ValueError) as te:
            tmb.chunk_sizes(*args)
        with pytest.raises(ValueError) as je:
            jmb.chunk_sizes(*args)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("m,n", [(1, 1), (4, 1), (1, 3), (4, 3), (3, 4), (8, 2)])
def test_clock_cycles_match_jax(m, n):
    assert list(tpipe.clock_cycles(m, n)) == list(jpipe.clock_cycles(m, n))


@pytest.mark.parametrize("mode", ["always", "except_last", "never"])
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("train", [True, False])
def test_checkpoint_stop_matches_jax(mode, chunks, train):
    assert tckpt.checkpoint_stop(mode, chunks, train=train) == jckpt.checkpoint_stop(
        mode, chunks, train=train
    )


def test_checkpoint_modes_and_errors():
    assert tckpt.CHECKPOINT_MODES == jckpt.CHECKPOINT_MODES
    with pytest.raises(ValueError, match="checkpoint is not one of"):
        tckpt.checkpoint_stop("sometimes", 4, train=True)
    # 'offload' keeps every cell's residuals (in host memory): stop 0.
    assert tckpt.checkpoint_stop("offload", 4, train=True) == 0 == \
        jckpt.checkpoint_stop("offload", 4, train=True)


@pytest.mark.parametrize("balance", [[3, 2], [1, 1, 1], [0, 4], [2, -1, 3]])
def test_split_layers_errors_match_jax(balance):
    tlayers = [nn.Linear(2, 2) for _ in range(4)]
    jlayers = jt.llama(JCFG)
    with pytest.raises(tpart.BalanceError) as te:
        tpart.split_layers(tlayers, balance)
    with pytest.raises(jpart.BalanceError) as je:
        jpart.split_layers(jlayers, balance)
    assert str(te.value).splitlines()[0] == str(je.value).splitlines()[0]


def test_split_layers_and_verify_module():
    layers = [nn.Linear(2, 2) for _ in range(4)]
    parts = tpart.split_layers(layers, [1, 2, 1])
    assert [len(p) for p in parts] == [1, 2, 1]
    assert parts[1][0] is layers[1]
    with pytest.raises(TypeError, match="non-empty"):
        tpart.verify_module([])
    with pytest.raises(TypeError, match="nn.Module"):
        tpart.verify_module([layers[0], "relu"])
    with pytest.raises(ValueError, match="appears twice"):
        tpart.verify_module([layers[0], layers[1], layers[0]])


# ---------------------------------------------------------------------- #
# training and inference parity                                          #
# ---------------------------------------------------------------------- #


_JAX_STEPS = {}


def _jax_step(reference, balance, chunks):
    """The reference GPipe's ``(loss, grads)`` for one balance and chunk
    count.  Its checkpoint modes compute one function (its own
    tests/test_gpipe.py::test_transparency_loss_and_grads), so it runs
    once per (balance, chunks), under 'except_last', which drives both
    its checkpointed (recompute) and its residual-keeping cell programs."""
    key = (tuple(balance), chunks)
    if key not in _JAX_STEPS:
        _, _, tokens = reference
        pipe, params, state = _jax_pipe(
            reference, balance, chunks=chunks, checkpoint="except_last"
        )
        x = jnp.asarray(tokens)
        loss, grads, _, _ = pipe.value_and_grad(
            params, state, x, x, jax_causal_lm_loss
        )
        _JAX_STEPS[key] = (loss, grads)
    return _JAX_STEPS[key]


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("checkpoint", ["always", "except_last", "never"])
@pytest.mark.parametrize("balance", [[4], [1, 2, 1], [2, 2]])
def test_value_and_grad_matches_jax_gpipe(reference, balance, checkpoint, chunks):
    flat, _, tokens = reference
    jloss, jgrads = _jax_step(reference, balance, chunks)
    model = _torch_pipe(flat, balance, chunks=chunks, checkpoint=checkpoint)
    t = torch.from_numpy(tokens)
    launches = tfa.flash_attention.launches
    loss, grads, aux = model.value_and_grad(t, t, torch_causal_lm_loss)
    assert aux is None and loss.ndim == 0 and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert len(grads) == len(balance)
    for j, (tstage, jstage) in enumerate(zip(grads, jgrads)):
        assert len(tstage) == len(jstage) == balance[j]
        for li, (tg, jg) in enumerate(zip(tstage, jstage)):
            assert sorted(tg) == sorted(jg)
            for name in tg:
                _assert_leaf_close(tg[name], jg[name], f"stage {j} layer {li} {name}")
    # The grads are the parameters' own .grad.
    assert grads[0][0]["table"] is model.partitions[0][0].table.grad
    assert tfa.flash_attention.launches == launches  # CPU: plain version


def test_apply_matches_jax_gpipe(reference):
    flat, _, tokens = reference
    jpipe_, jparams, jstate = _jax_pipe(reference, [1, 2, 1], chunks=2)
    ref, _ = jpipe_.apply(jparams, jstate, jnp.asarray(tokens))
    model = _torch_pipe(flat, [1, 2, 1], chunks=2)
    out = model.apply(torch.from_numpy(tokens))
    assert not out.requires_grad and out.shape == (BATCH, SEQ, KW["vocab"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(), out.numpy())


@pytest.mark.parametrize("checkpoint", ["always", "never"])
def test_value_and_grad_equals_unpipelined_backward(reference, checkpoint):
    """The transparency contract: pipelined loss and grads are those of
    the plain model's ``loss.backward()``."""
    flat, _, tokens = reference
    t = torch.from_numpy(tokens)
    plain = params_from_jax(TCFG, flat, device="cpu")
    loss = torch_causal_lm_loss(plain(t), t)
    loss.backward()
    model = _torch_pipe(flat, [2, 1, 1], chunks=4, checkpoint=checkpoint)
    ploss, grads, _ = model.value_and_grad(t, t, torch_causal_lm_loss)
    np.testing.assert_allclose(ploss.item(), loss.item(), rtol=LOSS_RTOL)
    flat_grads = [g for stage in grads for g in stage]
    for li, (layer, g) in enumerate(zip(plain, flat_grads)):
        for name, p in layer.named_parameters():
            _assert_leaf_close(g[name], p.grad.numpy(), f"layer {li} {name}")


def test_loss_aux_is_returned(reference):
    flat, _, tokens = reference
    t = torch.from_numpy(tokens)
    model = _torch_pipe(flat, [4], chunks=2)

    def loss_with_aux(out, tgt):
        return torch_causal_lm_loss(out, tgt), {"rows": out.shape[0]}

    loss, _, aux = model.value_and_grad(t, t, loss_with_aux)
    assert aux == {"rows": BATCH} and torch.isfinite(loss)


class _Probe(nn.Module):
    """Records, per call, (micro-batch size, is_checkpointing,
    is_recomputing, grad enabled)."""

    def __init__(self, log):
        super().__init__()
        self.lin = nn.Linear(3, 3)
        self.log = log

    def forward(self, x):
        self.log.append((x.shape[0], tckpt.is_checkpointing(),
                         tckpt.is_recomputing(), torch.is_grad_enabled()))
        return self.lin(x)


def test_phase_flags_seen_in_the_right_cells():
    log = []
    model = GPipe([_Probe(log), _Probe(log)], [1, 1], devices=["cpu"], chunks=3,
                  checkpoint="except_last")
    x = torch.randn(7, 3)                       # micro-batches of 3, 3, 1
    model.value_and_grad(x, None, lambda out, _: out.square().sum())
    # Forward in clock order (0,0) (1,0) (0,1) (2,0) (1,1) (2,1):
    # micro-batches 0 and 1 checkpointed (no grad), 2 with grad.  Then the
    # backward, in reverse clock order, recomputes (1,1) (0,1) (1,0) (0,0)
    # with grad on; micro-batch 2 kept its graph.
    ckpt, live = (3, True, False, False), (1, False, False, True)
    assert log == [ckpt, ckpt, ckpt, live, ckpt, live] + [(3, False, True, True)] * 4
    assert not tckpt.is_checkpointing() and not tckpt.is_recomputing()
    log.clear()
    model.apply(x)
    plain3, plain1 = (3, False, False, False), (1, False, False, False)
    assert log == [plain3, plain3, plain3, plain1, plain3, plain1]


def test_llama_backward_reaches_every_weight():
    """Parameters are trainable: one backward through ``llama`` on the
    CPU gives every weight a non-zero gradient."""
    model = tt.llama(TCFG, device="cpu", generator=torch.Generator().manual_seed(1))
    t = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    torch_causal_lm_loss(model(t), t).backward()
    for name, p in model.named_parameters():
        assert p.requires_grad and p.grad is not None, name
        assert p.grad.abs().max() > 0, name


_JAX_DTYPES = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize(
    "kwargs",
    # The options of the eighth slice (fused, megastep, compute_dtype,
    # 'offload') are ported: their cases now pair them so that the
    # reference refuses the pairing, and the port must refuse it with
    # the reference's text.  The options still unported keep raising
    # with their ROADMAP item.
    [{"schedule": "1f1b", "loss_reduction": "mean", "megastep": 3},
     {"fused": True, "schedule": "1f1b", "loss_reduction": "mean"},
     {"megastep": 2},
     {"remat_policy": object()}, {"tracer": object()},
     {"deferred_batch_norm": True, "compute_dtype": torch.float16,
      "fused": True, "checkpoint": "offload"},
     {"compute_dtype": torch.bfloat16, "fused": True, "tracer": object()},
     {"checkpoint": "offload", "schedule": "1f1b", "loss_reduction": "sum"},
     {"hbm_budget_bytes": 1 << 30}],
)
def test_unported_options_raise_with_roadmap_item(kwargs):
    layers = [nn.Linear(2, 2), nn.Linear(2, 2)]
    # A tracer with fused=True meets the reference's fused check first.
    unported = {"remat_policy", "hbm_budget_bytes"} & set(kwargs) or (
        "tracer" in kwargs and not kwargs.get("fused"))
    if unported:
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A item 2"):
            GPipe(layers, [1, 1], devices=["cpu"], **kwargs)
        return
    jkw = {k: _JAX_DTYPES.get(v, v) if k == "compute_dtype" else v
           for k, v in kwargs.items()}
    with pytest.raises(ValueError) as je:
        JGPipe(jt.llama(JCFG)[:2], [1, 1], devices=[jax.devices()[0]], **jkw)
    with pytest.raises(ValueError) as te:
        GPipe(layers, [1, 1], devices=["cpu"], **kwargs)
    assert str(te.value) == str(je.value)


def test_unported_entry_points_and_layers_raise():
    model = GPipe([nn.Linear(2, 2)], [1], devices=["cpu"])
    for call in (lambda: model.value_and_grad_with_loss_params(),
                 lambda: model.value_and_grad(torch.zeros(2, 2), None, None,
                                              rng=0)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A item 2"):
            call()
    # megastep is ported; on a pipe without fused=True the reference's
    # refusal, word for word.
    jmodel = JGPipe(jt.llama(JCFG)[:1], [1], devices=[jax.devices()[0]])
    with pytest.raises(ValueError) as je:
        jmodel.make_train_step(None, None, megastep=2)
    with pytest.raises(ValueError) as te:
        model.make_train_step(torch.optim.SGD, None, megastep=2)
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="random layer"):
        GPipe([nn.Linear(2, 2), nn.Dropout(0.1)], [2], devices=["cpu"])
    # Skip layers are ported: a stash that no layer pops fails the
    # reference's static check instead.
    skip = nn.Linear(2, 2)
    skip.stash = (("ns", "x"),)
    with pytest.raises(TypeError, match="no layer pops 'x'"):
        GPipe([skip], [1], devices=["cpu"])


def test_unknown_option_is_a_type_error():
    with pytest.raises(TypeError, match="unexpected keyword argument 'loss_scale'"):
        GPipe([nn.Linear(2, 2)], [1], devices=["cpu"], loss_scale="mean")


def test_apply_with_a_function_is_module_apply():
    """``apply`` is the pipelined forward, but a parent module's
    ``apply(fn)`` reaches every submodule through it as ``nn.Module``'s."""
    model = GPipe([nn.Linear(2, 2), nn.Linear(2, 2)], [1, 1], devices=["cpu"])
    seen = []
    outer = nn.Sequential(model)
    assert outer.apply(lambda m: seen.append(type(m).__name__)) is outer
    assert seen.count("Linear") == 2 and "GPipe" in seen
    with torch.no_grad():
        model.apply(lambda m: m.weight.fill_(0.5) if isinstance(m, nn.Linear) else None)
    assert all((layer.weight == 0.5).all() for layer in model)


def test_constructor_validation_matches_reference():
    layers = [nn.Linear(2, 2), nn.Linear(2, 2)]
    with pytest.raises(ValueError, match="balance is required"):
        GPipe(layers, devices=["cpu"])
    with pytest.raises(ValueError, match="number of chunks must be positive"):
        GPipe(layers, [2], devices=["cpu"], chunks=0)
    with pytest.raises(ValueError, match="checkpoint is not one of"):
        GPipe(layers, [2], devices=["cpu"], checkpoint="sometimes")
    with pytest.raises(tpart.BalanceError):
        GPipe(layers, [1], devices=["cpu"])
    model = GPipe(layers, [1, 1], devices=["cpu"], chunks=2)
    assert len(model) == 2 and model[1] is layers[1] and list(model) == layers
    assert [str(d) for d in model.devices] == ["cpu", "cpu"]


def test_no_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPipe([nn.Linear(2, 2)], [1])
