"""LoRA in torchgpipe_tpu_torch against the JAX reference
(``tests/test_lora.py``'s contract chain, on the port).

A float32 Llama (vocab 64, dim 32, 2 layers, 4 heads, 2 kv heads,
rank 4, alpha 8) is initialised by the reference with adapters, and
converted with ``convert.params_from_jax`` (the ``"lora"`` leaves
included).

Tolerances.  Both sides compute the same float32 network in another
summation order (matmuls over at most 64 terms, softmax over 8 keys):
~1e-7 relative per op, compounding over 2 blocks and the head to ~1e-6
of logits of magnitude ~1; logits are held to 5e-5 absolute and
gradients to 1e-4 of each leaf's max |value| (the gradient tests of
``test_torch_gpipe.py``).  A fresh adapter adds ``(h @ A) @ 0`` = +0.0
to every projection, so the fresh model equals the base model bitwise.
The merge folds ``A @ B`` (the same 4-term float32 products on both
sides) into the weights: merged weights to 1e-6 of their max and the
merged model's logits to 5e-5 of the adapted model's.  Greedy tokens
must be equal (no near-tie in this seeded case).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_apply, sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import lora as jlora
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import lora as tlora
from torchgpipe_tpu_torch.models import transformer as tt

LOGIT_TOL, GRAD_REL_TOL, MERGE_REL_TOL = 5e-5, 1e-4, 1e-6
BASE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
LORA = dict(BASE, lora_rank=4, lora_alpha=8.0)
JCFG, TCFG = jt.TransformerConfig(**LORA), tt.TransformerConfig(**LORA)
JBASE, TBASE = jt.TransformerConfig(**BASE), tt.TransformerConfig(**BASE)


def _jax_params(nonzero: bool):
    """The reference's flat params with adapters; ``nonzero`` gives the
    B factors real values so the deltas are exercised."""
    params, _, _ = sequential_init(jt.llama(JCFG), jax.random.PRNGKey(0),
                                   jax.ShapeDtypeStruct((2, 8), jnp.int32))
    params = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    if nonzero:
        rng = np.random.default_rng(7)
        params = [params[0]] + [
            dict(bp, lora={k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
                           for k, v in bp["lora"].items()})
            for bp in params[1:-1]] + [params[-1]]
    return params


def _tokens(b=2, s=8, seed=0):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], (b, s)).astype(np.int32)


def test_fresh_adapters_compute_the_base_model():
    params = _jax_params(nonzero=False)
    adapted = params_from_jax(TCFG, params, device="cpu")
    base = params_from_jax(
        TBASE, [{k: v for k, v in p.items() if k != "lora"} for p in params],
        device="cpu")
    tokens = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        out1, out0 = adapted(tokens), base(tokens)
    assert torch.equal(out1, out0)
    jout, _ = sequential_apply(jt.llama(JCFG), params, [()] * len(params),
                               jnp.asarray(_tokens()), rng=None, train=False)
    np.testing.assert_allclose(out1.numpy(), np.asarray(jout), rtol=0, atol=LOGIT_TOL)
    # A fresh torch-side init: B factors zero, A ~ N(0, dim^-1/2).
    fresh = tt.llama(TCFG, device="cpu")
    assert all(not fresh[1].lora.params()[k].detach().any() for k in
               ("qb", "kb", "vb", "ob"))
    assert abs(fresh[1].lora.qa.std().item() - 32 ** -0.5) < 0.06


def test_adapter_only_training_moves_only_adapters():
    """The adapter gradients of one step equal the reference GPipe's
    "lora" leaves; three AdamW steps through ``lora_optimizer`` lower the
    loss and leave every base weight bitwise as it was, with no
    ``.grad``."""
    params = _jax_params(nonzero=True)
    tokens = _tokens(4, 9, seed=1)

    def jloss(out, tok):
        return jt.cross_entropy(out[:, :-1], tok[:, 1:])

    jpipe = JGPipe(jt.llama(JCFG), [2, 2], chunks=2)
    jp = jpipe.place((params[:2], params[2:]))
    jst = jpipe.place(([(), ()], [(), ()]))
    jl, jgrads, _, _ = jpipe.value_and_grad(jp, jst, jnp.asarray(tokens),
                                            jnp.asarray(tokens), jloss)
    jflat = [g for stage in jgrads for g in stage]

    model = params_from_jax(TCFG, params, device="cpu")
    pipe = GPipe(list(model), [2, 2], devices=["cpu"], chunks=2)
    make = tlora.lora_optimizer(functools.partial(torch.optim.AdamW, lr=5e-2), pipe)
    step = pipe.make_train_step(make, lambda out, tok: tt.cross_entropy(out[:, :-1], tok[:, 1:]))
    base = {n: p.detach().clone() for n, p in pipe.named_parameters() if "lora" not in n}
    adapters = {n: p.detach().clone() for n, p in pipe.named_parameters() if "lora" in n}
    t = torch.from_numpy(tokens).long()
    loss, _, _ = pipe.value_and_grad(t, t, lambda out, tok: tt.cross_entropy(out[:, :-1], tok[:, 1:]))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for i, layer in enumerate(pipe):
        for name, p in layer.named_parameters():
            if "lora" not in name:
                assert p.grad is None and not p.requires_grad, (i, name)
                continue
            ref = np.asarray(jflat[i]["lora"][name.split(".")[-1]])
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=GRAD_REL_TOL * np.abs(ref).max(),
                                       err_msg=f"layer {i} {name}")
    losses = [step(t, t)[0].item() for _ in range(3)]
    assert losses[-1] < losses[0], losses
    for n, p in pipe.named_parameters():
        if "lora" in n:
            continue
        assert torch.equal(p, base[n]) and p.grad is None, n
    assert any(not torch.equal(p, adapters[n]) for n, p in pipe.named_parameters()
               if "lora" in n)
    assert all(not opt.state.get(p) for opt in step.optimizers
               for p in pipe.parameters() if not p.requires_grad)
    assert set(tlora.lora_mask(pipe)) == {n for n, _ in pipe.named_parameters()}


def test_merge_lora_exact():
    params = _jax_params(nonzero=True)
    jm_cfg, jmerged = jlora.merge_lora(JCFG, params)
    model = params_from_jax(TCFG, params, device="cpu")
    mcfg, merged = tlora.merge_lora(TCFG, model)
    assert mcfg.lora_rank is None and jm_cfg.lora_rank is None
    assert merged[0] is model[0] and merged[-1] is model[-1]
    for blk, jb in zip(list(merged)[1:-1], jmerged[1:-1]):
        assert "lora" not in blk.params() and "lora" not in jb
        for k, v in blk.params().items():
            ref = np.asarray(jb[k])
            np.testing.assert_allclose(v.detach().numpy(), ref, rtol=0,
                                       atol=MERGE_REL_TOL * np.abs(ref).max(), err_msg=k)
    tokens = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        np.testing.assert_allclose(merged(tokens).numpy(), model(tokens).numpy(),
                                   rtol=0, atol=LOGIT_TOL)
    prompt = _tokens()[:, :4]
    d1 = tg.generate(TCFG, model, prompt, 3, device="cpu")
    dm = tg.generate(mcfg, merged, prompt, 3, device="cpu")
    assert torch.equal(d1, dm)
    with pytest.raises(ValueError, match="nothing to merge"):
        tlora.merge_lora(mcfg, merged)


def test_lora_guards():
    """The reference's refusals, word for word."""
    _, p0, _ = sequential_init(jt.llama(JBASE), jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((2, 8), jnp.int32))
    with pytest.raises(ValueError) as je:
        jlora.lora_optimizer(None, p0)
    with pytest.raises(ValueError) as te:
        tlora.lora_optimizer(None, tt.llama(TBASE, device="cpu"))
    assert str(te.value) == str(je.value)
    base_flat = [jax.tree_util.tree_map(np.asarray, p) for p in p0]
    with pytest.raises(ValueError) as je:
        jlora.merge_lora(JCFG, base_flat)
    with pytest.raises(ValueError) as te:
        tlora.merge_lora(TCFG, tt.llama(TBASE, device="cpu"))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jlora.merge_lora(JBASE, base_flat)
    with pytest.raises(ValueError) as te:
        tlora.merge_lora(TBASE, tt.llama(TBASE, device="cpu"))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_lora_generate_matches_jax(kv_quant):
    """Greedy decoding with unmerged adapters (prefill and every decode
    step apply the deltas) equals the reference's tokens."""
    params = _jax_params(nonzero=True)
    prompt = _tokens(2, 8, seed=3)
    ref = np.asarray(jg.generate(JCFG, [jax.tree_util.tree_map(jnp.asarray, p) for p in params],
                                 jnp.asarray(prompt), 6, kv_quant=kv_quant))
    got = tg.generate(TCFG, params_from_jax(TCFG, params, device="cpu"), prompt, 6,
                      device="cpu", kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), ref)
