"""float16, head dims up to 256 (Gemma's) and the multiples of 128 above
256 through the port's attention routes, against the JAX reference.

On the card float16 runs the tensor-core kernels' f16 instantiations
(``flash_fwd``, ``flash_bwd_dq``/``dkv``, ``flash_decode``; zero-padded
below 128 as bf16 is), and head dims 129 to 256 run ``flash_simt.cu``'s
CUDA-core kernels in bf16, f16 and f32 (route ``"wide"``; the forward and
dQ at exactly 256 in bf16 and f16 run the tensor-core kernels' d=256
instantiation, ``wide_kernel``), and so does every multiple of 128 above
256, as the reference's kernels take them (384 and 512 on flash_simt.cu's
sixteen-lane kernels, 640 and up on its chunked ones); any other head dim
above 256, or another dtype, no kernel takes (``"none"``, refused on the
card).
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
max.  Head dims 384, 512 and 640 against the reference's Pallas kernels in
interpret mode (tests/test_torch_flash_attention.py's tolerances): the
same float32 inputs and float32 arithmetic to F32_TOL (the output and
the decode) and 1e-4 of each gradient's max; bf16 inputs rounded once
on each side (the port's plain version computes in float32 from them,
the reference's kernels too) to the bf16 output's half ulp at |o| < 4,
BF16_TOL = 3e-2, and 2^-6 of each gradient's max; an int8 cache to
DECODE_TOL = 2e-5 (the same dequantized rows, V scaled at another
place, one float32 rounding apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.ops import flash_attention as jfa
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
     # the reference's multiples of 128 above 256: the wide route
     # (flash_simt.cu; chunked above 512) in every type and for bf16 and
     # int8 caches; 448 (not a multiple of 128) none
     (384, BF16, {}, ("wide", 384)), (384, F16, {"window": 16}, ("wide", 384)),
     (384, F32, {}, ("wide", 384)), (512, BF16, {}, ("wide", 512)),
     (512, F16, {}, ("wide", 512)), (512, F32, {}, ("wide", 512)),
     (448, BF16, {}, ("none", 448)), (640, BF16, {}, ("wide", 640)),
     (768, F16, {"window": 16}, ("wide", 768)), (1024, F32, {}, ("wide", 1024)),
     (2048, BF16, {}, ("wide", 2048)), (448, BF16, {"decode": True}, ("none", 448)),
     (384, BF16, {"decode": True}, ("wide", 384)),
     (512, BF16, {"decode": True, "cache_dtype": I8}, ("wide", 512)),
     (512, F32, {"decode": True}, ("wide", 512)),
     (640, BF16, {"decode": True}, ("wide", 640)),
     (768, F16, {"decode": True, "cache_dtype": I8}, ("wide", 768)),
     (1024, F32, {"decode": True}, ("wide", 1024)),
     (2048, BF16, {"decode": True}, ("wide", 2048)),
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
     (136, BF16, "simt"), (384, BF16, "simt"), (512, F16, "simt"), (512, F32, "simt"),
     (640, BF16, "simt"), (1024, F16, "simt")],
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
     (160, BF16, I8, "simt"), (136, F16, F16, "simt"), (384, BF16, BF16, "simt"),
     (512, BF16, I8, "simt"), (640, BF16, BF16, "simt"), (1024, F16, I8, "simt")],
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


# --------------------------------------------------------------------- #
# head dims 384-640 against the reference's kernels (interpret mode)     #
# --------------------------------------------------------------------- #

F32_TOL, BF16_TOL, F32_GRAD_REL, BF16_GRAD_REL, DECODE_TOL = 2e-5, 3e-2, 1e-4, 2 ** -6, 2e-5


@functools.lru_cache(maxsize=None)
def _big_dim_case(d, jdtype_name):
    """Inputs, and the reference's output and ``jax.vjp`` gradients, of a
    causal GQA call (b=1, s=128, h=4, g=2) at head dim ``d`` through
    ``flash_attention``'s Pallas kernels in interpret mode."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 128, 4, d), dtype=np.float32)
    k, v = (rng.standard_normal((1, 128, 2, d), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape, dtype=np.float32)
    jdt = getattr(jnp, jdtype_name)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    assert jfa.supports(q.shape, k.shape)
    out, pull = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, interpret=True),
        jq, jk, jv)
    return (q, k, v, do), np.asarray(out, np.float32), \
        tuple(np.asarray(g, np.float32) for g in pull(jdo))


@pytest.mark.parametrize("d", [384, 512, 640])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_big_head_dim_forward_and_grads_match_jax_kernels(d, dtype):
    """The wide route at head dims 384 and 512 (on the card
    csrc/flash_simt.cu's sixteen-lane kernels) and 640 (its chunked
    kernels, two output chunks): the output and dQ, dK, dV
    of ``attention`` on the CPU, its plain version, against the
    reference's Pallas forward and backward kernels."""
    (q, k, v, do), ref, ref_grads = _big_dim_case(d, "float32" if dtype == F32 else "bfloat16")
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    assert tuple(tfa.attention_route(tq.shape, tk.shape, dtype)) == ("wide", d)
    assert tfa.wide_kernel(tq.shape, dtype) == "simt"
    tfa.reset_launches()
    out = tfa.attention(tq, tk, tv)
    out.backward(torch.from_numpy(do).to(dtype))
    tol, rel = (F32_TOL, F32_GRAD_REL) if dtype == F32 else (BF16_TOL, BF16_GRAD_REL)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, atol=tol, rtol=0)
    for name, t, want in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max(), err_msg=name)
    assert (tfa.flash_attention_wide.launches, tfa.flash_bwd_dq_wide.launches,
            tfa.flash_bwd_dkv_wide.launches) == (0, 0, 0)


@pytest.mark.parametrize("d", [384, 512, 640])
@pytest.mark.parametrize("quant", [False, True])
def test_big_head_dim_decode_matches_jax_kernel(d, quant):
    """The wide decode at head dims 384, 512 and 640 over a bf16 or an int8
    cache (live length 332 of 384: the reference's decode needs max_len
    >= 256), g = 2 query rows under a window, against the reference's
    Pallas decode in interpret mode."""
    from torchgpipe_tpu.models import generation as jg

    rng = np.random.default_rng(d + quant)
    b, max_len, nh, nkv, g, pos0, window = 1, 384, 4, 2, 2, 330, 200
    q = rng.standard_normal((b, g, nh, d), dtype=np.float32)
    kf, vf = (rng.standard_normal((b, max_len, nkv, d), dtype=np.float32) for _ in range(2))
    if quant:
        (ck, cks), (cv, cvs) = (tuple(np.array(a) for a in jg._quant_rows(jnp.asarray(x)))
                                for x in (kf, vf))
        cks, cvs = (np.ascontiguousarray(a.transpose(0, 2, 1)) for a in (cks, cvs))
        jq, jk, jv = jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
        jsc = dict(k_scale=jnp.asarray(cks), v_scale=jnp.asarray(cvs))
        tsc = dict(k_scale=torch.from_numpy(cks), v_scale=torch.from_numpy(cvs))
    else:
        tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, kf, vf))
        jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (tq, tk, tv))
        jsc, tsc = {}, {}
    assert jfa.supports_decode(q.shape, kf.shape, window)
    ref = jfa.flash_decode_attention(jq, jk, jv, jnp.asarray(pos0, jnp.int32),
                                     window=window, interpret=True, **jsc)
    assert tuple(tfa.attention_route(tq.shape, tk.shape, tq.dtype, window=window, decode=True,
                                     cache_dtype=tk.dtype)) == ("wide", d)
    assert tfa.wide_kernel(tq.shape, tk.dtype, decode=True) == "simt"
    tfa.reset_launches()
    out = tfa.decode_attention(tq, tk, tv, pos0, window=window, **tsc)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=DECODE_TOL if quant else F32_TOL, rtol=0)
    assert tfa.flash_decode_wide.launches == 0


class _OnTheCard:
    """What ``_no_kernel`` reads of a CUDA tensor (this test needs no card)."""

    shape, dtype, device = (1, 4, 2, 448), BF16, torch.device("cuda", 0)


def test_no_kernel_names_the_cap():
    """A head dim above 256 that is not a multiple of 128 the card refuses,
    naming what is taken; there is no cap on the multiples of 128."""
    with pytest.raises(ValueError, match="every multiple of 128 above it are taken"):
        tfa._no_kernel(_OnTheCard(), (1, 4, 2, 448), "attention")
    assert tfa.attention_route((1, 4, 4, 4096), (1, 4, 2, 4096), BF16).kind == "wide"
