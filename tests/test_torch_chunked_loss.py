"""The parametric loss layer (``chunked_lm_loss``) through
``GPipe.value_and_grad_with_loss_params``, and
``mpmd_params_for_generation``, in torchgpipe_tpu_torch against the JAX
reference.

A float32 Llama without its head (vocab 64, dim 32, 2 blocks, 4 heads,
2 kv heads; ``llama(cfg, head=False)``, cut [2, 1]) and a chunked loss
layer of 16-column vocabulary chunks, the reference's weights and loss
parameters converted with ``convert.params_from_jax(...,
loss_params=...)``; a LoRA config trains its adapters the same way.

Tolerances.  One float32 network in another summation order (matmuls
over at most 64 terms, an online log-sum-exp over 4 chunks): loss to
1e-5 relative, each gradient leaf (the pipe's and the loss layer's) to
1e-4 of its max |value|, logits to 5e-5 (``test_torch_gpipe.py``).  The
round trip shares or copies tensors: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
LOSS_RTOL, GRAD_REL_TOL = 1e-5, 1e-4
BALANCE, CHUNK = [2, 1], 16


def _setup(lora: bool, checkpoint: str):
    kw = dict(KW, lora_rank=4, lora_alpha=8.0) if lora else KW
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    tokens = np.random.default_rng(2).integers(0, 64, (4, 17)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    spec = jax.ShapeDtypeStruct(x.shape, jnp.int32)
    params, _, _ = sequential_init(jt.llama(jcfg, head=False), jax.random.PRNGKey(0), spec)
    params = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    if lora:   # non-zero B factors, so the adapters' gradients all flow
        rng = np.random.default_rng(5)
        params = [params[0]] + [dict(p, lora={k: (v + 0.05 * rng.standard_normal(v.shape))
                                              .astype(v.dtype) for k, v in p["lora"].items()})
                                for p in params[1:]]
    jlayer = jt.chunked_lm_loss(jcfg, chunk=CHUNK)
    lp, _ = jlayer.init(jax.random.PRNGKey(9), spec)
    lp = jax.tree_util.tree_map(np.asarray, lp)
    jpipe = JGPipe(jt.llama(jcfg, head=False), BALANCE, chunks=2, checkpoint=checkpoint)
    jp = jpipe.place((params[:2], params[2:]))
    jst = jpipe.place(([(), ()], [()]))
    jres = jpipe.value_and_grad_with_loss_params(
        jp, jax.tree_util.tree_map(jnp.asarray, lp), jst, jnp.asarray(x), jnp.asarray(y),
        jlayer)
    model, layer = params_from_jax(tcfg, params, device="cpu", loss_params=lp, chunk=CHUNK)
    pipe = GPipe(list(model), BALANCE, devices=["cpu"], chunks=2, checkpoint=checkpoint)
    return (jcfg, tcfg), (params, lp), jres, (pipe, layer), (x, y)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=GRAD_REL_TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("checkpoint", ["never", "except_last"])
def test_value_and_grad_with_loss_params_matches_jax(lora, checkpoint):
    _, _, (jl, jgrads, jlgrads, _, _), (pipe, layer), (x, y) = _setup(lora, checkpoint)
    jflat = [g for stage in jgrads for g in stage]
    if lora:
        from torchgpipe_tpu_torch.models.lora import lora_optimizer
        lora_optimizer(torch.optim.SGD, pipe)   # freezes the base weights
    loss, grads, loss_grads, aux = pipe.value_and_grad_with_loss_params(
        torch.from_numpy(x).long(), torch.from_numpy(y).long(), layer)
    assert aux is None
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert sorted(loss_grads) == sorted(jlgrads)
    for k, g in loss_grads.items():
        assert g is getattr(layer, k).grad
        _close(g, jlgrads[k], f"loss {k}")
    n = 0
    for i, layer_ in enumerate(pipe):
        for name, p in layer_.named_parameters():
            if lora and "lora" not in name:
                assert p.grad is None
                continue
            ref = jflat[i]["lora"][name.split(".")[1]] if "lora" in name else jflat[i][name]
            _close(p.grad, ref, f"layer {i} {name}")
            n += 1
    assert n == sum(len(g) for stage in grads for g in stage)


def test_loss_params_refusals():
    """The reference's refusals, word for word: the 1F1B schedule, and a
    fused pipe."""
    cfg = tt.TransformerConfig(**KW)
    layer = tt.chunked_lm_loss(cfg, chunk=CHUNK, device="cpu")
    jcfg = jt.TransformerConfig(**KW)
    for kw in ({"schedule": "1f1b", "loss_reduction": "mean"}, {"fused": True}):
        jmodel = JGPipe(jt.llama(jcfg, head=False), [3], devices=[jax.devices()[0]], **kw)
        with pytest.raises(ValueError) as je:
            jmodel.value_and_grad_with_loss_params(None, None, None, None, None, None)
        model = GPipe(list(tt.llama(cfg, head=False, device="cpu")), [3], devices=["cpu"],
                      **kw)
        with pytest.raises(ValueError) as te:
            model.value_and_grad_with_loss_params(torch.zeros(2, 4, dtype=torch.long),
                                                  None, layer)
        assert str(te.value) == str(je.value)
    model = GPipe(list(tt.llama(cfg, head=False, device="cpu")), [3], devices=["cpu"])
    with pytest.raises(ValueError, match="must be stateless"):
        model.value_and_grad_with_loss_params(torch.zeros(2, 4, dtype=torch.long),
                                              None, torch.nn.BatchNorm1d(4))


@pytest.mark.parametrize("copy", [False, True])
def test_mpmd_params_for_generation_round_trip(copy):
    """A headless pipe with the loss layer as its head back to the flat
    model ``generate`` takes: the same tensors (shared, or copied
    bitwise), logits equal to the reference's on the same weights, and
    greedy tokens equal to the reference ``generate`` over
    ``mpmd_params_for_generation``'s list plus the loss params."""
    (jcfg, tcfg), (params, lp), _, (pipe, layer), (x, _) = _setup(False, "never")
    gen_model = tg.mpmd_params_for_generation(pipe, head=layer, copy=copy)
    assert len(gen_model) == tcfg.n_layers + 2
    for ours, theirs in zip(gen_model, list(pipe) + [layer]):
        for (na, a), (nb, b) in zip(ours.named_parameters(), theirs.named_parameters()):
            assert na == nb and torch.equal(a, b)
            assert (a is b) != copy
    jflat = jg.mpmd_params_for_generation(
        None, ([jax.tree_util.tree_map(jnp.asarray, p) for p in params[:2]],
               [jax.tree_util.tree_map(jnp.asarray, p) for p in params[2:]]))
    jflat.append(jax.tree_util.tree_map(jnp.asarray, lp))
    prompt = x[:, :6]
    got = tg.generate(tcfg, gen_model, prompt, 5, device="cpu")
    want = np.asarray(jg.generate(jcfg, jflat, jnp.asarray(prompt), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    logits, _ = tg.prefill(tcfg, gen_model, prompt, 16, device="cpu")
    jlogits, _ = jg.prefill(jcfg, jflat, jnp.asarray(prompt), 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=5e-5)
