"""float16 and head dims up to 256 (Gemma's) through the port's attention
routes, against the JAX reference.

On the card float16 runs the tensor-core kernels' f16 instantiations
(``flash_fwd``, ``flash_bwd_dq``/``dkv``, ``flash_decode``; zero-padded
below 128 as bf16 is), and head dims 129 to 256 run ``flash_simt.cu``'s
CUDA-core kernels in bf16, f16 and f32 (route ``"wide"``; the forward and
dQ at exactly 256 in bf16 and f16 run the tensor-core kernels' d=256
instantiation, ``wide_kernel``); above 256, or
in another dtype, no kernel takes it (``"none"``, refused on the card).
On the CPU every route runs its plain version, so the models here hold
the algorithm against the reference; the kernels are held against those
plain versions by tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances.  float16 Llama (2 blocks, dim 64): both sides compute in f16
with float32 softmax and norm statistics but round at other places (the
reference's XLA fusions, the port's PyTorch ops), each rounding 2^-11
relative; a block has ~10 roundings on the residual path, so two blocks
and the head stay under ~40 x 2^-11 = 2^-5.7 of the logits' scale:
logits to 2^-5 of max |logit|, every gradient leaf to 2^-4 of its max
(the backward doubles the roundings and the gradients are smaller
numbers).  Head dim 256 at float32: the same float32 sums in other orders
(~1e-6 relative): logits to 5e-5 absolute (as
tests/test_torch_attention_route.py), gradients to 1e-4 of each leaf's
max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import flash_attention as tfa

F16, BF16, F32, I8 = torch.float16, torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize(
    "d,dtype,kw,want",
    [(128, F16, {}, ("kernel", 128)), (64, F16, {}, ("kernel", 64)),
     (80, F16, {}, ("pad", 128)), (32, F16, {"window": 8}, ("pad", 64)),
     (160, BF16, {}, ("wide", 160)), (160, F16, {}, ("wide", 160)),
     (160, F32, {}, ("wide", 160)), (256, BF16, {}, ("wide", 256)),
     (256, F16, {"window": 16}, ("wide", 256)), (256, F32, {}, ("wide", 256)),
     (320, BF16, {}, ("none", 320)), (320, F16, {}, ("none", 320)),
     (320, F32, {}, ("none", 320)), (128, torch.float64, {}, ("none", 128)),
     # decode: f16 against an f16 or int8 cache on the tensor-core decode,
     # 129-256 on the wide decode, never padded
     (128, F16, {"decode": True}, ("kernel", 128)),
     (128, F16, {"decode": True, "cache_dtype": I8}, ("kernel", 128)),
     (80, F16, {"decode": True}, ("kernel", 80)),
     (20, F16, {"decode": True}, ("simt", 20)),
     (256, BF16, {"decode": True}, ("wide", 256)),
     (256, F16, {"decode": True}, ("wide", 256)),
     (160, F32, {"decode": True}, ("wide", 160)),
     (256, BF16, {"decode": True, "cache_dtype": I8}, ("wide", 256)),
     (320, BF16, {"decode": True}, ("none", 320)),
     (128, F16, {"decode": True, "cache_dtype": BF16}, ("none", 128))],
)
def test_route_table(d, dtype, kw, want):
    q, k = (2, 16, 8, d), (2, 16, 2, d)
    if kw.get("decode"):
        q, k = (2, 1, 8, d), (2, 64, 2, d)
    assert tuple(tfa.attention_route(q, k, dtype, **kw)) == want


def test_gates():
    """The tensor-core gates take float16 where they take bf16; the wide
    gates take 129-256 in three dtypes and nothing else."""
    assert tfa.supports((1, 16, 4, 128), (1, 16, 4, 128), F16)
    assert not tfa.supports((1, 16, 4, 256), (1, 16, 4, 256), F16)
    assert tfa.supports_decode((1, 1, 4, 80), (1, 16, 4, 80), None, F16)
    assert not tfa.supports_decode((1, 1, 4, 20), (1, 16, 4, 20), None, F16)
    for dtype in (BF16, F16, F32):
        assert tfa.supports_wide((1, 16, 4, 256), (1, 16, 2, 256), dtype)
        assert not tfa.supports_wide((1, 16, 4, 128), (1, 16, 2, 128), dtype)
        assert not tfa.supports_wide((1, 16, 4, 264), (1, 16, 2, 264), dtype)
        assert not tfa.supports_wide((1, 16, 6, 256), (1, 16, 4, 256), dtype)
    assert tfa.supports_decode_wide((1, 1, 4, 256), (1, 16, 4, 256), None, I8)
    assert not tfa.supports_decode_wide((1, 1, 4, 128), (1, 16, 4, 128), None, BF16)


@pytest.mark.parametrize(
    "d,dtype,want",
    [(256, BF16, "tc"), (256, F16, "tc"), (256, F32, "simt"), (160, BF16, "simt"),
     (160, F16, "simt"), (192, BF16, "simt"), (192, F16, "simt"), (160, F32, "simt"),
     (136, BF16, "simt")],
)
def test_wide_kernel_table(d, dtype, want):
    """The wide route's forward and dQ: the tensor-core kernels' d=256
    instantiation for bf16 and f16 at head dim exactly 256, flash_simt.cu
    for float32 and every other wide head dim."""
    q, k = (2, 16, 8, d), (2, 16, 2, d)
    assert tfa.attention_route(q, k, dtype).kind == "wide"
    assert tfa.wide_kernel(q, dtype) == want


@pytest.mark.parametrize(
    "d,qdt,cache,want",
    [(256, BF16, BF16, "tc"), (256, F16, F16, "tc"), (256, BF16, I8, "tc"),
     (256, F32, I8, "tc"), (256, F32, F32, "simt"), (192, BF16, BF16, "simt"),
     (160, BF16, I8, "simt"), (136, F16, F16, "simt")],
)
def test_wide_decode_kernel_table(d, qdt, cache, want):
    """The wide route's decode: flash_decode.cu's 256 tiles for a bf16,
    f16 or int8 cache at head dim exactly 256 (Gemma's), flash_simt.cu for
    a float32 cache and every other wide head dim."""
    q, k = (2, 1, 8, d), (2, 64, 2, d)
    assert tfa.attention_route(q, k, qdt, decode=True, cache_dtype=cache).kind == "wide"
    assert tfa.wide_kernel(q, cache, decode=True) == want


def test_wide_wrappers_on_the_cpu_are_the_plain_versions():
    """On CPU tensors the wide wrappers run the plain versions and count
    no launch (the count is the card's)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, n, 256, generator=g).requires_grad_() for n in (4, 2, 2))
    tfa.reset_launches()
    out = tfa.attention(q, k, v, window=16)
    ref = tfa.flash_attention_reference(q, k, v, window=16)
    assert torch.equal(out, ref)
    out.sum().backward()
    ck = torch.randn(1, 64, 2, 256, generator=g)
    dec = tfa.decode_attention(q[:, :1].detach(), ck, ck, 30)
    assert torch.equal(dec, tfa.flash_decode_reference(q[:, :1].detach(), ck, ck, 30))
    assert (tfa.flash_attention_wide.launches, tfa.flash_bwd_dq_wide.launches,
            tfa.flash_bwd_dkv_wide.launches, tfa.flash_decode_wide.launches,
            tfa.flash_attention_wide.launches_d256, tfa.flash_bwd_dq_wide.launches_d256,
            tfa.flash_bwd_dkv_wide.launches_d256,
            tfa.flash_decode_wide.launches_d256) == (0, 0, 0, 0, 0, 0, 0, 0)


def _models(kw, jdtype, tdtype):
    jcfg = jt.TransformerConfig(**kw, dtype=jdtype)
    params, _, _ = sequential_init(jt.llama(jcfg), jax.random.PRNGKey(0),
                                   jax.ShapeDtypeStruct((2, 8), jnp.int32))
    host = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    model = params_from_jax(tt.TransformerConfig(**kw, dtype=tdtype), host, device="cpu")
    return jcfg, params, model


def _leaf(tree, key):
    return np.asarray(tree[key], np.float32)


@pytest.mark.parametrize("case", ["f16", "d256"])
def test_llama_forward_and_backward_match_jax(case):
    """A 2-block Llama in float16 (dim 64, 4 heads of 16 padded on the
    card to the f16 kernels' 64) and one at head dim 256 (float32, the
    wide route): logits of one forward, and every parameter's gradient of
    one backward of the mean cross-entropy, against the reference's."""
    kw = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    if case == "d256":
        kw["n_head_dim"] = 256
        jdtype, tdtype, logit_tol, grad_rel = jnp.float32, F32, 5e-5, 1e-4
    else:
        jdtype, tdtype, logit_tol, grad_rel = jnp.float16, F16, None, 2 ** -4
    jcfg, jparams, model = _models(kw, jdtype, tdtype)
    tokens = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    layers = jt.llama(jcfg)

    def jloss(ps):
        h = jnp.asarray(tokens)
        for layer, p in zip(layers, ps):
            h, _ = layer.apply(p, (), h, rng=None, train=True)
        return jt.cross_entropy(h, jnp.asarray(tokens)), h

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    logits = model(torch.from_numpy(tokens).long())
    loss = tt.cross_entropy(logits, torch.from_numpy(tokens).long())
    loss.backward()
    want = np.asarray(jlogits, np.float32)
    tol = logit_tol if logit_tol is not None else 2 ** -5 * np.abs(want).max()
    np.testing.assert_allclose(logits.detach().float().numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-5 if case == "d256" else 2 ** -8)
    for i, layer in enumerate(model):
        for name, p in layer.params().items():
            ref = _leaf(jgrads[i], name)
            np.testing.assert_allclose(p.grad.float().numpy(), ref, rtol=0,
                                       atol=grad_rel * np.abs(ref).max(),
                                       err_msg=f"layer {i} {name}")
