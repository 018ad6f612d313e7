"""``ops.flash_attention.attention_route``: which kernel attention runs on
when the tensor-core kernels do not take its shape, against the JAX
reference.

The card's tensor-core kernels take bfloat16 and float16 at head dims 64
and 128; head dims 129 to 256 run the CUDA-core kernels ("wide").
The reference computes every other case: its kernel zero-pads a head dim
below 128 (``torchgpipe_tpu/ops/flash_attention.py:977-995``) and takes
float32; its decode goes dense where ``supports_decode`` fails.  The port
routes at its three callers (the training block, the prefill, the
decode): a bf16 head dim below 128 is zero-padded; float32 runs the
3xTF32 forward of ``csrc/flash_fwd_tf32.cu`` (head dims that are a
multiple of 4) with the float32 backward of ``csrc/flash_simt.cu``; a
decode runs ``csrc/flash_decode.cu`` at any head dim up to 128 whose
cache row TMA maps (16-byte multiples); the rows TMA cannot map run
``flash_simt``'s CUDA-core forward and decode; what none takes raises on
the card.  The bf16 forward wrapper's refusals stay as they are.  On the CPU every route runs plain
PyTorch; the padded route still pads, so its arithmetic is held here.

Tolerances, as ``tests/test_torch_flash_attention.py`` derives them:
bfloat16 outputs one bf16 ulp of |o| < 4 apart (3e-2), bf16 gradients
2^-6 of max |grad|, float32 2e-5 on O(1) outputs and 1e-4 of max |grad|.
The padded route against the unpadded plain version on the port's own
side: the zero columns add exact zeros to every score and give exact
zero output columns, so only the summation order of the float32 sums
differs (a few float32 ulps) before both round to bf16 once: one bf16
ulp of the output and of each gradient's max.  Models (float32 Llama,
bf16 at d=32 and d=80): logits to 5e-5 absolute in float32 (as
``tests/test_torch_generation.py``), greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.ops import flash_attention as jfa
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import flash_attention as tfa

BF16_TOL, BF16_GRAD_REL = 3e-2, 2 ** -6
F32_TOL, F32_GRAD_REL, LOGIT_TOL = 2e-5, 1e-4, 5e-5
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize(
    "d,dtype,kw,want",
    [(128, BF16, {}, ("kernel", 128)), (64, BF16, {}, ("kernel", 64)),
     (32, BF16, {}, ("pad", 64)), (80, BF16, {}, ("pad", 128)),
     (96, BF16, {}, ("pad", 128)), (16, BF16, {"window": 8}, ("pad", 64)),
     # head dims 129-256: the CUDA-core kernels in every dtype ("wide")
     (256, BF16, {}, ("wide", 256)), (192, BF16, {}, ("wide", 192)),
     # float32: the 3xTF32 forward at d % 4 == 0, the CUDA-core one else
     (128, F32, {}, ("f32", 128)), (32, F32, {}, ("f32", 32)),
     (128, torch.float16, {}, ("kernel", 128)),
     (128, F32, {"window": 8}, ("f32", 128)), (36, F32, {}, ("f32", 36)),
     (30, F32, {}, ("simt", 30)), (18, F32, {"window": 8}, ("simt", 18)),
     # decode: the tensor-core kernel at any head dim up to 128 whose
     # cache row is a multiple of 16 bytes (bf16, f32, int8 caches), the
     # CUDA-core one at the other dims, never padded
     (128, BF16, {"decode": True}, ("kernel", 128)),
     (64, F32, {"decode": True}, ("kernel", 64)),
     (128, BF16, {"decode": True, "cache_dtype": I8}, ("kernel", 128)),
     (128, F32, {"decode": True, "cache_dtype": I8}, ("kernel", 128)),
     (32, BF16, {"decode": True}, ("kernel", 32)),
     (80, BF16, {"decode": True, "cache_dtype": I8}, ("kernel", 80)),
     (80, BF16, {"decode": True}, ("kernel", 80)),
     (96, F32, {"decode": True}, ("kernel", 96)),
     (24, BF16, {"decode": True, "cache_dtype": I8}, ("simt", 24)),
     (20, BF16, {"decode": True}, ("simt", 20)),
     (30, F32, {"decode": True}, ("simt", 30)),
     (24, F32, {"decode": True, "cache_dtype": I8}, ("simt", 24)),
     (128, torch.float16, {"decode": True}, ("kernel", 128)),
     (128, BF16, {"decode": True, "cache_dtype": F32}, ("none", 128)),
     (256, BF16, {"decode": True}, ("wide", 256)), (256, F32, {}, ("wide", 256))],
)
def test_route_table(d, dtype, kw, want):
    q, k = (2, 16, 8, d), (2, 16, 2, d)
    if kw.get("decode"):
        q, k = (2, 1, 8, d), (2, 64, 2, d)
    assert tuple(tfa.attention_route(q, k, dtype, **kw)) == want


def test_route_leaves_the_gates_and_refusals_alone():
    """The forward gate answers as before: padding is the callers'
    business.  The decode gate takes every head dim up to 128 whose cache
    row TMA maps (the kernel runs it at the real dim), no other."""
    assert not tfa.supports((1, 16, 4, 32), (1, 16, 4, 32))
    assert not tfa.supports((1, 16, 4, 128), (1, 16, 4, 128), F32)
    assert tfa.supports_decode((1, 1, 4, 80), (1, 16, 4, 80), None)
    assert not tfa.supports_decode((1, 1, 4, 20), (1, 16, 4, 20), None)
    assert not tfa.supports_decode((1, 1, 4, 24), (1, 16, 4, 24), None, I8)
    assert not tfa.supports_decode((1, 1, 4, 136), (1, 16, 4, 136), None)
    assert tuple(tfa.attention_route((1, 16, 6, 64), (1, 16, 4, 64), BF16)) == \
        ("none", 64)       # h not a multiple of g: no kernel, no pad


def _qkv(seed, b, s, h, g, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d))]
    return arrs, [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]


def _bf16_np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("d,window", [(32, None), (80, None), (80, 24)])
def test_padded_route_matches_jax_and_unpadded_plain(d, window):
    """bf16 at d=32 and d=80 goes through the kernel's path zero-padded
    (on the CPU its plain version on the padded tensors): output and
    q/k/v gradients against the reference's padded Pallas kernel
    (interpret mode, ``jax.vjp``) and against the port's unpadded plain
    attention.  ``sm_scale`` is the real d's."""
    arrs, (q, k, v) = _qkv(d, 2, 64, 4, 2, d, BF16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    do = np.random.default_rng(7).standard_normal((2, 64, 4, d)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=True, window=window, interpret=True), jq, jk, jv)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    out = tfa.attention(q, k, v, causal=True, window=window)
    assert out.shape == (2, 64, 4, d) and out.dtype == BF16
    np.testing.assert_allclose(_bf16_np(out), np.asarray(ref, np.float32),
                               atol=BF16_TOL, rtol=0)
    out.backward(torch.from_numpy(do).to(BF16))
    for t, jgr in zip((q, k, v), jgrads):
        want = np.asarray(jgr, np.float32)
        np.testing.assert_allclose(_bf16_np(t.grad), want, rtol=0,
                                   atol=BF16_GRAD_REL * np.abs(want).max())
    # The same against the unpadded plain version (autograd through it).
    _, (q2, k2, v2) = _qkv(d, 2, 64, 4, 2, d, BF16)
    plain = tfa.flash_attention_reference(q2, k2, v2, causal=True, window=window)
    plain.backward(torch.from_numpy(do).to(BF16))
    np.testing.assert_allclose(_bf16_np(out), _bf16_np(plain), atol=BF16_TOL, rtol=0)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        want = _bf16_np(b.grad)
        np.testing.assert_allclose(_bf16_np(a.grad), want, rtol=0,
                                   atol=BF16_GRAD_REL * np.abs(want).max())


def test_dense_route_float32_matches_jax():
    """float32 goes to ``flash_attention_tf32`` (``csrc/flash_fwd_tf32.cu``
    and ``csrc/flash_simt.cu``'s backward on the card, the plain version
    here): output and gradients against the reference's float32 Pallas
    kernel."""
    arrs, (q, k, v) = _qkv(3, 2, 64, 4, 2, 128, F32)
    ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=True,
                                                            interpret=True),
                       *(jnp.asarray(a) for a in arrs))
    out = tfa.attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)
    do = np.ones((2, 64, 4, 128), np.float32)
    out.backward(torch.from_numpy(do))
    for t, jgr in zip((q, k, v), vjp(jnp.asarray(do))):
        want = np.asarray(jgr)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=F32_GRAD_REL * np.abs(want).max())
    assert tfa.flash_attention_tf32.launches == 0    # counted on the card only


@pytest.mark.parametrize("d,cache", [(80, BF16), (32, F32), (80, I8), (20, BF16), (24, I8)])
def test_decode_route_dense_equals_plain(d, cache):
    """A decode at a head dim other than 64 or 128 goes to
    ``flash_decode_attention`` at the real head dim (or, for rows TMA
    cannot map, ``flash_decode_simt``) over the whole cache, unpadded; on
    the CPU that is ``flash_decode_reference`` exactly (the same
    function), with an int8 cache's scales too."""
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 3, 4, d, generator=g).to(BF16 if cache == BF16 else F32)
    if cache == I8:
        ck = torch.randint(-127, 128, (2, 40, 2, d), generator=g, dtype=I8)
        cv = torch.randint(-127, 128, (2, 40, 2, d), generator=g, dtype=I8)
        kw = dict(k_scale=torch.rand(2, 2, 40, generator=g),
                  v_scale=torch.rand(2, 2, 40, generator=g))
    else:
        ck, cv = (torch.randn(2, 40, 2, d, generator=g).to(q.dtype) for _ in range(2))
        kw = {}
    got = tfa.decode_attention(q, ck, cv, 20, window=None, **kw)
    want = tfa.flash_decode_reference(q, ck, cv, 20, **kw)
    assert torch.equal(got, want)


def _llama(kw, seed=0):
    jcfg = jt.TransformerConfig(**{k: v for k, v in kw.items() if k != "dtype"},
                                dtype=jnp.float32)
    params, _, _ = sequential_init(jt.llama(jcfg), jax.random.PRNGKey(seed),
                                   jax.ShapeDtypeStruct((2, 8), jnp.int32))
    return jcfg, [jax.tree_util.tree_map(np.asarray, p) for p in params]


@pytest.mark.parametrize("n_head_dim", [32, 80, 128])
def test_models_at_other_head_dims_generate_as_jax(n_head_dim):
    """float32 Llamas at d=32, 80 and 128: prefill logits and greedy
    tokens, and the block's training forward, equal to the reference's
    (on the CPU every route is plain; the card's routes are held by the
    CUDA tests and chip_smoke.py)."""
    kw = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              n_head_dim=n_head_dim)
    jcfg, params = _llama(kw)
    tcfg = tt.TransformerConfig(**kw)
    model = params_from_jax(tcfg, params, device="cpu")
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    prompt = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    want_l, _ = jg.prefill(jcfg, jp, jnp.asarray(prompt), 20)
    got_l, _ = tg.prefill(tcfg, model, prompt, 20, device="cpu")
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=LOGIT_TOL, rtol=0)
    want = np.asarray(jg.generate(jcfg, jp, jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(tg.generate(tcfg, model, prompt, 6, device="cpu").numpy(),
                                  want)
    x = np.random.default_rng(2).standard_normal((2, 12, 64)).astype(np.float32)
    jblock = jt.transformer_block(jcfg)
    ref = jblock.apply(jp[1], (), jnp.asarray(x))[0]
    np.testing.assert_allclose(model[1](torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=F32_TOL, rtol=0)
