"""torchgpipe_tpu_torch.ops.flash_attention against the JAX kernels.

The same numpy inputs go through the reference Pallas kernels (run in
interpret mode on the CPU, as tests/test_flash_attention.py runs them)
and through the port's wrappers, which on CPU tensors run their plain
PyTorch versions.  The CUDA kernels themselves are held against those
plain versions by tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances.  float32: both sides form the same softmax from the same
float32 inputs and differ only in summation order (blocked online
softmax vs one dense reduction over <= 256 keys); scores and outputs are
O(1), so the gap is a few float32 ulps of O(1) values, ~1e-6; 2e-5
leaves an order of magnitude.  bfloat16: both round the float32 result
to bfloat16 once, so they differ by at most one bfloat16 ulp of the
output, 2^-7 * |o| <= 3e-2 for |o| < 4.

Gradients (``flash_attention``'s autograd backward against ``jax.vjp``
through the reference Pallas backward kernels), float32: both sides
recompute ``p = exp(s - lse)`` and form ``ds = p * (dp - delta)`` from
the same float32 inputs.  Scores and the LSE (~10 in magnitude) agree to
~1e-6 absolute, which moves ``p`` by ~1e-6 relative; ``dp`` and ``delta``
(~10) differ by summation order over d = 64..128 terms, ~1e-6 relative,
and their difference can cancel to ~1e-2 of their size, so ``ds`` agrees
to ~1e-5 of its scale, and the sums over <= 256 keys or queries keep that
relative figure.  1e-4 of max |grad| leaves an order of magnitude.
bfloat16: the port's plain backward works in float32 and rounds each
gradient once; the reference kernel's dK/dV are float32 sums rounded
once too, so the two differ by about one bfloat16 ulp at the largest
gradient, 2^-7 of max |grad|; 2^-6 allows a second rounding where the
reference casts dq to bfloat16 inside its kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.ops import flash_attention as jfa
from torchgpipe_tpu_torch.ops import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_REL_TOL = 1e-4
BF16_GRAD_REL_TOL = 2 ** -6


def _inputs(rng, b, s, h, g, d, sk=None):
    sk = s if sk is None else sk
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, g, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, g, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "h,g,d,window,causal",
    [
        (4, 2, 128, None, True),    # GQA r=2, full causal
        (4, 2, 128, 64, True),      # sliding window
        (4, 1, 64, None, True),     # MQA, head dim 64
        (2, 2, 64, 100, True),      # MHA, window not a tile multiple
        (2, 1, 128, None, False),   # bidirectional
    ],
)
def test_flash_attention_matches_jax(h, g, d, window, causal):
    q, k, v = _inputs(np.random.default_rng(1), 2, 256, h, g, d)
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True,
    )
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
    )
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)
    assert tfa.flash_attention.launches == before  # CPU: plain version only


def _jax_grads(q, k, v, do, streaming, **kw):
    """``(dq, dk, dv)`` of the reference through its Pallas backward
    kernels (interpret mode): resident (B5/B6) or streaming (B3/B4)."""
    _, pull = jax.vjp(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, interpret=True, streaming=streaming, **kw
        ),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    return pull(jnp.asarray(do))


def _torch_grads(q, k, v, do, dtype=torch.float32, **kw):
    qt, kt, vt = (
        torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)
    )
    out = tfa.flash_attention(qt, kt, vt, **kw)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do).to(dtype))


def _assert_grads_close(got, want, rel, names=("dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(
            a.float().numpy(), b, atol=rel * np.abs(b).max(), rtol=0, err_msg=name
        )


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize(
    "h,g,d,window,causal",
    [
        (4, 2, 128, None, True),    # GQA r=2, full causal
        (4, 2, 128, 64, True),      # sliding window
        (4, 1, 64, None, True),     # MQA, head dim 64
        (2, 2, 64, 100, True),      # MHA, window not a tile multiple
        (2, 1, 128, None, False),   # bidirectional
    ],
)
def test_flash_attention_grads_match_jax_kernels(h, g, d, window, causal, streaming):
    rng = np.random.default_rng(6)
    q, k, v = _inputs(rng, 2, 256, h, g, d)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    ref = _jax_grads(q, k, v, do, streaming, causal=causal, window=window)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    got = _torch_grads(q, k, v, do, causal=causal, window=window)
    _assert_grads_close(got, ref, GRAD_REL_TOL)
    # CPU: the plain backward only.
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before


def test_flash_attention_bf16_grads_match_jax_kernels():
    rng = np.random.default_rng(7)
    q, k, v = _inputs(rng, 1, 256, 4, 2, 128)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    _, pull = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, interpret=True),
        *jb[:3],
    )
    ref = pull(jb[3])
    got = _torch_grads(q, k, v, do, dtype=torch.bfloat16, causal=True)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _assert_grads_close(got, ref, BF16_GRAD_REL_TOL)


@pytest.mark.parametrize("window", [None, 37])
def test_flash_attention_ragged_grads_match_jax_dense(window):
    """s = 200 is no multiple of the reference kernels' 128-row block, so
    the oracle is ``jax.grad`` of the reference's dense attention."""
    from torchgpipe_tpu.parallel.ring_attention import full_attention

    rng = np.random.default_rng(8)
    q, k, v = _inputs(rng, 2, 200, 4, 2, 64)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    _, pull = jax.vjp(
        lambda q, k, v: full_attention(q, k, v, causal=True, window=window),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    ref = pull(jnp.asarray(do))
    got = _torch_grads(q, k, v, do, causal=True, window=window)
    _assert_grads_close(got, ref, GRAD_REL_TOL)


def test_flash_attention_bf16_matches_jax():
    q, k, v = _inputs(np.random.default_rng(2), 1, 256, 4, 2, 128)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = jfa.flash_attention(*jb, causal=True, interpret=True)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = tfa.flash_attention(*tb, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_TOL, rtol=0
    )


# Head dim 256 (Gemma's) in bfloat16: the wide route, whose forward and dQ
# run csrc/flash_fwd.cu's and csrc/flash_bwd.cu's d=256 instantiations on
# the card (``wide_kernel`` answers "tc").  s = 200 is ragged for every
# tile of the port's kernels (128 query rows; 64 or 32 keys); the
# reference kernels need the sequence divisible by their block, so they
# run at block_q = block_k = 40 there.  Tolerances as the bf16 cases
# above: each side computes in float32 from the same bf16 inputs and
# rounds the output once, so the forward differs by at most one bf16 ulp,
# 2^-7 * |o| < 3e-2 (|o| < 4: an average of unit-normal V rows); dQ by a
# bf16 ulp at the largest gradient plus the reference's own bf16 cast of
# dq inside its kernel, 2^-6 of max |dq| (BF16_GRAD_REL_TOL).  The d=256
# sums run over 256 head dims instead of 128, which moves the float32
# summation noise (~1e-6 relative) and not the bf16 roundings.
D256_CASES = [(256, None), (256, 64), (200, None), (200, 37)]


def _d256_inputs(s, window, seed):
    rng = np.random.default_rng(seed)
    q, k, v = _inputs(rng, 1, s, 4, 2, 256)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    blocks = dict(block_q=40, block_k=40) if s % 128 else {}
    kw = dict(causal=True, window=window)
    return q, k, v, do, blocks, kw


@pytest.mark.parametrize("s,window", D256_CASES)
def test_flash_attention_d256_bf16_forward_matches_jax_kernel(s, window):
    q, k, v, _, blocks, kw = _d256_inputs(s, window, 11)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = jfa.flash_attention(*jb, interpret=True, **blocks, **kw)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    assert tfa.attention_route(tb[0].shape, tb[1].shape, torch.bfloat16,
                               window=window).kind == "wide"
    assert tfa.wide_kernel(tb[0].shape, torch.bfloat16) == "tc"
    tfa.reset_launches()
    out, lse = tfa._flash_fwd_wide(*tb, True, 256 ** -0.5, window)
    assert torch.equal(out, tfa.attention(*tb, **kw))
    assert out.dtype == torch.bfloat16 and lse.shape == (4, s)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_TOL, rtol=0
    )
    # CPU: the plain version only, on neither counter.
    assert (tfa.flash_attention_wide.launches, tfa.flash_attention_wide.launches_d256) == (0, 0)


@functools.lru_cache(maxsize=None)
def _d256_jax_grads(s, window, seed):
    """dQ, dK and dV of ``_d256_inputs(s, window, seed)`` through
    ``jax.vjp`` of the reference's Pallas kernels in bf16 (one pull, which
    the dQ and the dK/dV tests share)."""
    q, k, v, do, blocks, kw = _d256_inputs(s, window, seed)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    _, pull = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True, **blocks, **kw),
        *jb[:3],
    )
    return tuple(np.asarray(x, np.float32) for x in pull(jb[3]))


@pytest.mark.parametrize("s,window", D256_CASES)
def test_flash_bwd_dq_d256_bf16_matches_jax_kernel(s, window):
    """dQ of the wide wrapper (``flash_bwd_dq_wide`` from the forward's
    own LSE and ``delta``) against ``jax.vjp`` through the reference's
    Pallas backward kernels."""
    q, k, v, do, _, _ = _d256_inputs(s, window, 12)
    ref_dq = _d256_jax_grads(s, window, 12)[0]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    scale = 256 ** -0.5
    tfa.reset_launches()
    o, lse = tfa._flash_fwd_wide(tq, tk, tv, True, scale, window)
    dq = tfa.flash_bwd_dq_wide(tq, tk, tv, tdo, lse, tfa._delta(tdo, o), causal=True,
                               sm_scale=scale, window=window)
    assert dq.dtype == torch.bfloat16
    _assert_grads_close([dq], [ref_dq], BF16_GRAD_REL_TOL)
    assert (tfa.flash_bwd_dq_wide.launches, tfa.flash_bwd_dq_wide.launches_d256) == (0, 0)


@pytest.mark.parametrize("s,window", D256_CASES)
def test_flash_bwd_dkv_d256_bf16_matches_jax_kernel(s, window):
    """dK and dV of the wide wrapper (``flash_bwd_dkv_wide``, whose card
    route is ``csrc/flash_bwd.cu``'s d=256 instantiation) from the
    forward's own LSE and ``delta``, against the dQ test's ``jax.vjp``
    through the reference's Pallas backward kernels (GQA r = 2: the
    reference sums its per-query-head dK/dV over each group after its
    kernel, the port inside).  Tolerance BF16_GRAD_REL_TOL, as for dQ:
    each side forms dK/dV in float32 and rounds to bf16, a bf16 ulp at the
    largest gradient, 2^-7 of max |grad|; 2^-6 leaves room for the
    reference's rounding of each query head's share before the group
    sum."""
    q, k, v, do, _, _ = _d256_inputs(s, window, 12)
    _, ref_dk, ref_dv = _d256_jax_grads(s, window, 12)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    assert tfa.wide_kernel(tq.shape, torch.bfloat16) == "tc"
    scale = 256 ** -0.5
    tfa.reset_launches()
    o, lse = tfa._flash_fwd_wide(tq, tk, tv, True, scale, window)
    dk, dv = tfa.flash_bwd_dkv_wide(tq, tk, tv, tdo, lse, tfa._delta(tdo, o), causal=True,
                                    sm_scale=scale, window=window)
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == dv.shape == tk.shape
    _assert_grads_close([dk, dv], [ref_dk, ref_dv], BF16_GRAD_REL_TOL, names=("dk", "dv"))
    assert (tfa.flash_bwd_dkv_wide.launches, tfa.flash_bwd_dkv_wide.launches_d256) == (0, 0)


# The decode at head dim 256 (Gemma's generate): on the card the wide
# route runs csrc/flash_decode.cu's 256 tiles for a bf16, f16 or int8
# cache.  The reference's decode takes hd = 256 at max_len >= 256
# (``supports_decode``).  Cases: 25c's g = 1, a speculative verify's g = 4
# with a window (16 rows a kv head), an int8 cache with its scales (g = 1
# and g = 3 with a window).  bf16: both sides hold the same bf16 inputs in
# float32 and compute in float32, so the float32 tolerance F32_TOL holds
# (summation order and the exp, ~1e-6).  int8: both dequantize the same
# int8 rows and float32 scales; the port's plain version scales V rows
# where the reference scales weights (one float32 rounding apart),
# DECODE_TOL = 2e-5 as tests/test_torch_kv_quant.py states it.
DECODE_TOL = 2e-5


@pytest.mark.parametrize("g,pos0,window,quant",
                         [(1, 135, None, False), (4, 200, 64, False),
                          (1, 255, None, True), (3, 100, 37, True)])
def test_flash_decode_d256_matches_jax_kernel(g, pos0, window, quant):
    from torchgpipe_tpu.models import generation as jg

    rng = np.random.default_rng(20 + g)
    b, max_len, nh, nkv, hd = 2, 256, 8, 2, 256
    mk = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    q = mk(b, g, nh, hd)
    kf, vf = mk(b, max_len, nkv, hd), mk(b, max_len, nkv, hd)
    if quant:
        (ck, cks), (cv, cvs) = (tuple(np.array(a) for a in jg._quant_rows(jnp.asarray(x)))
                                for x in (kf, vf))
        cks, cvs = (np.ascontiguousarray(a.transpose(0, 2, 1)) for a in (cks, cvs))
        jq, jk, jv = jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
        jsc = dict(k_scale=jnp.asarray(cks), v_scale=jnp.asarray(cvs))
        tsc = dict(k_scale=torch.from_numpy(cks), v_scale=torch.from_numpy(cvs))
        tol = DECODE_TOL
    else:
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kf, vf))
        jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (tq, tk, tv))
        jsc, tsc, tol = {}, {}, F32_TOL
    assert jfa.supports_decode(q.shape, kf.shape, window)
    ref = jfa.flash_decode_attention(jq, jk, jv, jnp.asarray(pos0, jnp.int32),
                                     window=window, interpret=True, **jsc)
    assert tfa.attention_route(tq.shape, tk.shape, tq.dtype, window=window, decode=True,
                               cache_dtype=tk.dtype).kind == "wide"
    assert tfa.wide_kernel(tq.shape, tk.dtype, decode=True) == "tc"
    tfa.reset_launches()
    out = tfa.decode_attention(tq, tk, tv, pos0, window=window, **tsc)
    assert out.dtype == torch.float32 and out.shape == (b, g, nh * hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol if quant else 0)
    # CPU: the plain version, on neither counter.
    assert (tfa.flash_decode_wide.launches, tfa.flash_decode_wide.launches_d256) == (0, 0)


@pytest.mark.parametrize(
    "g,pos0,window,nh,nkv",
    [
        (1, 0, None, 4, 2),       # first token: one live key
        (1, 100, None, 4, 2),
        (1, 255, None, 4, 1),     # last slot, MQA
        (4, 60, None, 4, 2),      # 4 consecutive queries (speculative verify)
        (4, 252, 32, 2, 2),       # window, MHA
        (1, 200, 17, 4, 2),       # window, odd width
    ],
)
def test_flash_decode_matches_jax(g, pos0, window, nh, nkv):
    rng = np.random.default_rng(3)
    b, max_len, hd = 2, 256, 128
    q = rng.standard_normal((b, g, nh, hd), dtype=np.float32)
    ck = rng.standard_normal((b, max_len, nkv, hd), dtype=np.float32)
    cv = rng.standard_normal((b, max_len, nkv, hd), dtype=np.float32)
    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos0, jnp.int32), window=window, interpret=True,
    )
    before = tfa.flash_decode_attention.launches
    out = tfa.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), pos0,
        window=window,
    )
    assert out.dtype == torch.float32 and out.shape == (b, g, nh * hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)
    assert tfa.flash_decode_attention.launches == before


@pytest.mark.parametrize(
    "g,pos0,window,nh,nkv,hd,dtype",
    [
        (1, 0, None, 4, 2, 128, torch.float32),
        (1, 255, None, 8, 2, 128, torch.bfloat16),
        (5, 200, None, 8, 2, 128, torch.bfloat16),   # 20 rows per kv head
        (5, 251, 40, 4, 1, 64, torch.float32),
        (2, 130, 17, 8, 8, 64, torch.bfloat16),
        (4, 99, None, 4, 2, 64, torch.float32),
    ],
)
def test_flash_decode_tensor_pos0_equals_int_and_jax(g, pos0, window, nh, nkv, hd, dtype):
    """pos0 as a 0-d int32 tensor gives the host int's bits, and both equal
    the reference kernel fed ``jnp.asarray(pos0, jnp.int32)``.  bfloat16
    inputs are held in float32 by both sides (the kernels' arithmetic), so
    the float32 tolerance holds."""
    rng = np.random.default_rng(8)
    b, max_len = 2, 256
    mk = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    q, ck, cv = mk(b, g, nh, hd), mk(b, max_len, nkv, hd), mk(b, max_len, nkv, hd)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, ck, cv))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for a in (tq, tk, tv))
    ref = jfa.flash_decode_attention(jq, jk, jv, jnp.asarray(pos0, jnp.int32),
                                     window=window, interpret=True)
    host = tfa.flash_decode_attention(tq, tk, tv, pos0, window=window)
    dev = tfa.flash_decode_attention(tq, tk, tv, torch.tensor(pos0, dtype=torch.int32),
                                     window=window)
    assert torch.equal(host, dev)
    np.testing.assert_allclose(dev.numpy(), np.asarray(ref, np.float32), atol=F32_TOL, rtol=0)


# The decode kernel's split of the live keys (``decode_split``, mirrored
# from csrc/flash_decode.cu): the generate cell (b=4, nkv=8, cache 1152,
# g=1), the long timing cache (32768), the speculative draft (b=1, 581,
# hd 64) and verify (g=5: 20 rows, one group), the CUDA tests' shapes, a
# window, and a grid of one block row.
_SPLIT_SHAPES = [
    # (b, nkv, rows, max_len, g, window)
    (4, 8, 4, 1152, 1, None),
    (4, 8, 4, 32768, 1, None),
    (1, 8, 4, 581, 1, None),
    (1, 8, 20, 581, 5, None),
    (2, 2, 4, 20000, 1, None),
    (2, 2, 20, 20000, 5, 9000),
    (4, 8, 4, 1152, 1, 256),
    (1, 1, 40, 700, 8, None),
    # Head dims other than 64/128 (the split does not depend on hd):
    # phase 5b's d=80 generate (MHA, 32 kv heads), its long d=80 cache,
    # the int8 d=32 case (g=5, 10 rows) and the float32 d=96 window.
    (4, 32, 1, 544, 1, None),
    (1, 8, 4, 20000, 1, None),
    (2, 4, 10, 517, 5, 64),
    (2, 2, 8, 1152, 2, 9),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,nkv,rows,max_len,g,window", _SPLIT_SHAPES)
def test_decode_split_covers_the_live_keys_once(b, nkv, rows, max_len, g, window, quant):
    """For every live length the chunks cover [first, pos0 + g) exactly once,
    in whole 64-key units but the last, and never outnumber the grid's split
    axis (sized from max_len alone)."""
    ngroups, group_rows = tfa.decode_groups(rows)
    assert ngroups * group_rows >= rows and group_rows <= tfa.DECODE_ROWS
    want = tfa.decode_want(b, nkv, ngroups, 132, quant)
    zmax = tfa.decode_zmax(max_len, want)
    step = 1 if max_len <= 2048 else 97
    for pos0 in list(range(0, max_len - g + 1, step)) + [max_len - g]:
        first, chunk, nsplit = tfa.decode_split(pos0, g, window, want)
        end = pos0 + g
        assert first == (0 if window is None else max(pos0 - window + 1, 0))
        assert chunk % tfa.DECODE_KEYS == 0 and 1 <= nsplit <= zmax
        starts = [first + i * chunk for i in range(nsplit)]
        covered = [k for st in starts for k in range(st, min(st + chunk, end))]
        assert covered == list(range(first, end))
        # One wave: the blocks of a call fit one (int8: two) to an SM.
        wave = tfa.DECODE_WAVE[quant] * 132
        assert b * nkv * ngroups * nsplit <= max(wave, b * nkv * ngroups)


@pytest.mark.parametrize("b,s,sk,h,causal,window", [
    (2, 1024, 1024, 32, True, None), (1, 12288, 12288, 4, True, None),
    (2, 17, 17, 8, True, None), (2, 129, 129, 4, True, None),
    (2, 1000, 1000, 8, True, 300), (2, 200, 200, 4, False, None),
    (2, 333, 200, 8, True, None), (2, 130, 1000, 8, True, None),
])
def test_dq_schedule_runs_every_tile_once(b, s, sk, h, causal, window):
    """flash_bwd_dq's work list (``fwd_schedule`` with 128-row query tiles
    and 64-key K/V tiles): every (head, query tile) once, at most one block
    per SM, each block a contiguous run."""
    offsets, tiles = tfa.fwd_schedule(b, s, sk, h, causal, window, 132,
                                      tfa.DQ_ROWS, tfa.DQ_KEYS)
    assert sorted(tiles) == list(range(b * h * -(-s // tfa.DQ_ROWS)))
    assert offsets[0] == 0 and offsets[-1] == len(tiles)
    assert len(offsets) - 1 <= 132
    assert all(a < e for a, e in zip(offsets, offsets[1:]))


def _live_key_tiles(q0, s, sk, causal, window, rows, keys):
    """The key tiles holding a (query, key) pair that a query of the tile
    from ``q0`` attends, by brute force over the pairs."""
    qpos = np.arange(q0, min(q0 + rows, s))[:, None]
    kpos = np.arange(sk)[None, :]
    seen = np.ones((qpos.size, sk), bool)
    if causal:
        seen = (kpos <= qpos) & (qpos - kpos < (window or sk + s))
    return sorted(set((np.nonzero(seen.any(0))[0] // keys).tolist()))


# Head dim 256's tiles (``fwd_tile``/``dq_tile``: 64- and 32-key K/V
# tiles) at the phase-25, timing and edge shapes.
D256_SCHEDULE_SHAPES = [
    (2, 512, 512, 16, True, None), (1, 4096, 4096, 16, True, None),
    (1, 333, 333, 8, True, 64), (2, 129, 129, 4, True, None),
    (1, 333, 512, 4, False, None), (2, 200, 200, 4, True, 37),
    (2, 333, 200, 8, True, None),
]


def _check_runs_every_tile_once_on_live_keys(b, s, sk, h, causal, window, rows, keys):
    offsets, tiles = tfa.fwd_schedule(b, s, sk, h, causal, window, 132, rows, keys)
    nqt = -(-s // rows)
    assert sorted(tiles) == list(range(b * h * nqt))
    assert offsets[0] == 0 and offsets[-1] == len(tiles)
    assert len(offsets) - 1 <= 132
    assert all(a < e for a, e in zip(offsets, offsets[1:]))
    if s * sk > 2 ** 22:
        return
    for j in range(nqt):
        q0 = j * rows
        first, n = tfa.fwd_key_tiles(q0, s, sk, causal, window, rows, keys)
        assert list(range(first, first + n)) == _live_key_tiles(
            q0, s, sk, causal, window, rows, keys)


@pytest.mark.parametrize("b,s,sk,h,causal,window", D256_SCHEDULE_SHAPES)
def test_dq_schedule_runs_every_tile_once_at_head_dim_256(b, s, sk, h, causal, window):
    """flash_bwd_dq's work list at d=256 (128-row query tiles, 32-key K/V
    tiles): every (head, query tile) once, and each query tile's key loop
    (the kernel's ``QueryTile``, mirrored by ``fwd_key_tiles``) exactly
    the key tiles holding a pair it attends."""
    assert tfa.dq_tile(256) == (128, 32) and tfa.dq_tile(128) == (tfa.DQ_ROWS, tfa.DQ_KEYS)
    _check_runs_every_tile_once_on_live_keys(b, s, sk, h, causal, window, *tfa.dq_tile(256))


@pytest.mark.parametrize("b,s,sk,h,causal,window", D256_SCHEDULE_SHAPES)
def test_fwd_schedule_runs_every_tile_once_at_head_dim_256(b, s, sk, h, causal, window):
    """The forward's work list at d=256 (128-row query tiles, 64-key K/V
    tiles), as the dQ test above."""
    assert tfa.fwd_tile(256) == (128, 64) and tfa.fwd_tile(128) == (128, tfa.FWD_KEYS)
    _check_runs_every_tile_once_on_live_keys(b, s, sk, h, causal, window, *tfa.fwd_tile(256))


@pytest.mark.parametrize("b,s,h", [(2, 1024, 32), (1, 12288, 4)])
def test_dq_schedule_balances_the_timing_shapes(b, s, h):
    """Key tiles (64 keys) per block within 1.15x of the mean at the dQ
    timing shapes: the causal tiles' work grows along the sequence, and the
    longest-first list spreads it."""
    offsets, tiles = tfa.fwd_schedule(b, s, s, h, True, None, 132,
                                      tfa.DQ_ROWS, tfa.DQ_KEYS)
    nqt = -(-s // tfa.DQ_ROWS)

    def work(t):   # causal: query tile q reads key tiles 0 .. 2q+1
        return 2 * (nqt - t // (b * h))

    loads = [sum(work(t) for t in tiles[a:e]) for a, e in zip(offsets, offsets[1:])]
    assert max(loads) <= 1.15 * sum(loads) / 132


def test_decode_reference_per_row_pos0_matches_jax_dense():
    """The ``[b]`` pos0 branch (the serving pool's dense read) against
    the reference's ``_attend_chunk`` dense path."""
    from torchgpipe_tpu.models.generation import _attend_chunk

    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 2, 4, 64), dtype=np.float32)
    ck = rng.standard_normal((3, 40, 2, 64), dtype=np.float32)
    cv = rng.standard_normal((3, 40, 2, 64), dtype=np.float32)
    pos0 = np.array([0, 17, 38], np.int32)
    ref = _attend_chunk(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos0),
        8, use_flash=False,
    )
    out = tfa.flash_decode_reference(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(pos0), window=8,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)


def test_lse_matches_jax_forward_residual():
    """The (o, lse) pair the training slice will save, against the
    reference kernel's residual."""
    q, k, v = _inputs(np.random.default_rng(5), 1, 128, 2, 1, 128)
    _, lse = jfa._flash_fwd_call(
        *(jnp.transpose(jnp.asarray(a), (0, 2, 1, 3)).reshape(-1, 128, 128)
          for a in (q, k, v)),
        2, 1, True, 128 ** -0.5, 128, 128, True,
    )
    _, tl = tfa._flash_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), True, 128 ** -0.5, None
    )
    np.testing.assert_allclose(
        tl.numpy(), np.asarray(lse)[..., 0], atol=F32_TOL, rtol=0
    )


def test_gates_and_refusals():
    assert tfa.supports((4, 1024, 32, 128), (4, 1024, 8, 128))
    assert tfa.supports((1, 1000, 4, 64), (1, 1000, 4, 64))
    assert not tfa.supports((1, 128, 4, 96), (1, 128, 4, 96))
    assert not tfa.supports((1, 128, 4, 128), (1, 128, 4, 128), torch.float32)
    assert not tfa.supports((1, 128, 6, 128), (1, 128, 4, 128))
    assert tfa.supports_decode((4, 1, 32, 128), (4, 1152, 8, 128), None)
    assert tfa.supports_decode((4, 4, 32, 128), (4, 1000, 8, 128), 256)
    # Any number of query rows (speculative verification: 8 x 4 = 32).
    assert tfa.supports_decode((4, 8, 32, 128), (4, 1152, 8, 128), None)
    assert tfa.supports_decode((4, 1, 32, 128), (4, 1152, 8, 128), None, torch.int8)
    assert not tfa.supports_decode((4, 1, 32, 128), (4, 1152, 8, 128), None,
                                   torch.float64)
    assert not tfa.supports_decode((4, 1, 32, 128), (4, 1152, 8, 128), 0)
    t = torch.zeros(1, 1, 2, 128)
    c = torch.zeros(1, 8, 2, 128)
    s = torch.zeros(1, 2, 8)
    with pytest.raises(TypeError, match="int8 cache"):
        tfa.flash_decode_attention(t, c, c, 0, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(t, c, c, causal=False, window=4)
    # pos0: a host int or a 0-d int32 tensor (the reference's runtime
    # scalar); other tensors are refused.
    for bad in (torch.tensor(3), torch.tensor([3], dtype=torch.int32)):
        with pytest.raises(TypeError, match="0-d int32"):
            tfa.flash_decode_attention(t, c, c, bad)
    with pytest.raises(ValueError, match="outside the cache"):
        tfa.flash_decode_attention(t, c, c, torch.tensor(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside the cache"):
        tfa.flash_decode_attention(t, c, c, 8)


# flash_bwd_dkv's work list (``dkv_schedule``): the two timing shapes of
# chip_smoke.py (one pipeline-1 micro-batch at Llama-3-8B width, and the
# long sequence), then edges of the 64-query and 128-key tiles, a window,
# no causal mask, and more keys than queries (key tiles no query attends).
_DKV_SHAPES = [
    # (b, s, sk, h, g, causal, window)
    (2, 1024, 1024, 32, 8, True, None),
    (1, 12288, 12288, 4, 1, True, None),
    (2, 17, 17, 8, 8, True, None),
    (2, 129, 129, 4, 1, True, None),
    (2, 191, 191, 8, 2, True, None),
    (2, 1000, 1000, 8, 2, True, None),
    (1, 2112, 2112, 8, 1, True, None),
    (2, 333, 333, 4, 4, True, 50),
    (2, 1024, 1024, 8, 2, True, 256),
    (2, 200, 200, 4, 1, False, None),
    (1, 300, 700, 4, 2, True, 100),
]


def _attended_tile_pairs(b, s, sk, h, causal, window, keys=128, queries=64):
    """Every (batch, query head, ``queries``-query tile, ``keys``-key tile)
    holding at least one attended (query, key) pair.  Over a tile pair, q -
    k takes every integer from q0 - k_last to q_last - k0, so a pair
    attends iff that range meets [0, window)."""
    out = set()
    for jq in range(-(-s // queries)):
        q0, q_last = jq * queries, min(jq * queries + queries - 1, s - 1)
        for kt in range(-(-sk // keys)):
            k0, k_last = kt * keys, min(kt * keys + keys - 1, sk - 1)
            if causal and (q_last - k0 < 0 or (window is not None
                                               and q0 - k_last >= window)):
                continue
            out.update((bi, hh, jq, kt) for bi in range(b) for hh in range(h))
    return out


def _check_dkv_schedule(b, s, sk, h, g, causal, window, keys, queries, whole=False):
    sch = tfa.dkv_schedule(b, s, sk, h, g, causal, window, 132, keys, queries, whole)
    r, nkt = h // g, -(-sk // keys)
    seen = {}
    for bi, kvh, kt, jq0, ntile, it0, it1, _ in sch.items:
        assert 0 <= it0 < it1 <= r * ntile
        for t in range(it0, it1):
            key = (bi, kvh * r + t // ntile, jq0 + t % ntile, kt)
            seen[key] = seen.get(key, 0) + 1
    assert set(seen.values()) <= {1}
    assert set(seen) == _attended_tile_pairs(b, s, sk, h, causal, window, keys, queries)
    # Blocks: at most one per SM, each with a contiguous run of items.
    assert sch.offsets[0] == 0 and sch.offsets[-1] == len(sch.items)
    assert len(sch.offsets) - 1 <= 132
    assert all(a < e for a, e in zip(sch.offsets, sch.offsets[1:]))
    # Slots: a combo cut into n items owns n consecutive slots, in the
    # order of its iterations (the sum kernel adds them in that order);
    # an uncut combo writes directly; a combo no query attends has none.
    by_combo = {}
    for it in sch.items:
        by_combo.setdefault((it[0] * g + it[1]) * nkt + it[2], []).append(it)
    assert len(sch.combos) == b * g * nkt
    slots = []
    for c, (first, count) in enumerate(sch.combos):
        pieces = sorted(by_combo.get(c, []), key=lambda it: it[5])
        if count == 0:
            assert not pieces
        elif count == -1:
            assert len(pieces) == 1 and pieces[0][7] == -1
        else:
            assert [it[7] for it in pieces] == list(range(first, first + count))
            slots.extend(range(first, first + count))
    assert sorted(slots) == list(range(sch.slots))
    return sch


@pytest.mark.parametrize("b,s,sk,h,g,causal,window", _DKV_SHAPES)
def test_dkv_schedule_covers_every_tile_pair_once(b, s, sk, h, g, causal, window):
    _check_dkv_schedule(b, s, sk, h, g, causal, window, 128, 64)


@pytest.mark.parametrize("b,s,h,g", [(2, 1024, 32, 8), (1, 12288, 4, 1)])
def test_dkv_schedule_balances_the_timing_shapes(b, s, h, g):
    """Longest first onto 132 SMs: the busiest SM holds at most 1.15x the
    mean work (64-query tiles).  One block per key tile would give its
    heaviest block 1.9-2.0x the mean, and a launch waits on it."""
    sch = tfa.dkv_schedule(b, s, s, h, g, True, None, 132)
    loads = [sum(it[6] - it[5] for it in sch.items[a:e])
             for a, e in zip(sch.offsets, sch.offsets[1:])]
    assert max(loads) <= 1.15 * sum(loads) / 132
    # Pure: the same call gives the same list (the sums' order rests on it).
    assert tfa.dkv_schedule(b, s, s, h, g, True, None, 132) == sch


# dK/dV at head dim 256 (``dkv_tile(256)``: 64-key items, 64-query Q/dO
# tiles) at phase 25's micro-batch, the s=4096 timing shape and edges:
# ragged tiles, windows, GQA, no mask with sk != s.
_DKV_D256_SHAPES = [
    (2, 512, 512, 16, 16, True, None), (1, 4096, 4096, 16, 16, True, None),
    (1, 333, 333, 8, 4, True, 64), (2, 129, 129, 4, 2, True, None),
    (1, 333, 512, 4, 2, False, None), (2, 200, 200, 4, 2, True, 37),
]


@pytest.mark.parametrize("b,s,sk,h,g,causal,window", _DKV_D256_SHAPES)
def test_dkv_schedule_covers_every_tile_pair_once_at_head_dim_256(b, s, sk, h, g, causal,
                                                                  window):
    """The d=256 work list: every (query head, 64-query tile, 64-key tile)
    pair that attends once, slots in item order, no block over ``ceil(mean
    work)``; at phase 25's and the s=4096 shapes (many short combos) as
    whole combos, longest first onto the least loaded block, with no
    partials.  Each cut item's f32 scratch slot is the kernel's [2 (dK,
    dV)][d/8 float4][2 * keys threads] layout, 2 * keys * d floats (128
    keys at d <= 128)."""
    assert tfa.dkv_tile(256) == (64, 64)
    assert tfa.dkv_tile(128) == tfa.dkv_tile(64) == (tfa.DKV_KEYS, tfa.DKV_QUERIES)
    for d in (64, 128, 256):
        assert tfa.dkv_slot_floats(d) == 2 * (d // 8) * (2 * tfa.dkv_tile(d)[0]) * 4
    sch = _check_dkv_schedule(b, s, sk, h, g, causal, window, *tfa.dkv_tile(256), True)
    loads = [sum(it[6] - it[5] for it in sch.items[a:e])
             for a, e in zip(sch.offsets, sch.offsets[1:])]
    assert max(loads) <= -(-sum(loads) // min(132, sum(loads)))
    if (b, s, h) in ((2, 512, 16), (1, 4096, 16)):
        assert sch.slots == 0 and all(it[7] == -1 for it in sch.items)
    # Pure: the same call gives the same list (the sums' order rests on it).
    assert tfa.dkv_schedule(b, s, sk, h, g, causal, window, 132, *tfa.dkv_tile(256),
                            True) == sch
    # Without ``whole`` (the d <= 128 and 3xTF32 kernels) the same tiles
    # take the cut list, which covers every pair once too.
    _check_dkv_schedule(b, s, sk, h, g, causal, window, *tfa.dkv_tile(256))


# The persistent forward's tile list (``fwd_schedule``): the shapes of
# chip_smoke.py's forward timings (generate prefill b=4, the training
# micro-batch b=2, the speculative prefills b=2 s=512, the beam prefill
# b=1, the long sequence), then edges of the 128-row tiles, a window, no
# causal mask and more keys than queries.
_FWD_SHAPES = [
    # (b, s, sk, h, causal, window)
    (4, 1024, 1024, 32, True, None),
    (2, 1024, 1024, 32, True, None),
    (2, 512, 512, 32, True, None),
    (1, 1024, 1024, 32, True, None),
    (1, 12288, 12288, 4, True, None),
    (2, 17, 17, 8, True, None),
    (2, 129, 129, 4, True, None),
    (2, 1000, 1000, 8, True, 300),
    (2, 200, 200, 4, False, None),
    (2, 333, 200, 8, True, None),
]


@pytest.mark.parametrize("b,s,sk,h,causal,window", _FWD_SHAPES)
def test_fwd_schedule_runs_every_tile_once(b, s, sk, h, causal, window):
    offsets, tiles = tfa.fwd_schedule(b, s, sk, h, causal, window, 132)
    assert sorted(tiles) == list(range(b * h * -(-s // 128)))
    assert offsets[0] == 0 and offsets[-1] == len(tiles)
    assert len(offsets) - 1 <= 132
    assert all(a < e for a, e in zip(offsets, offsets[1:]))


@pytest.mark.parametrize("b,s,h", [(4, 1024, 32), (2, 1024, 32), (1, 12288, 4)])
def test_fwd_schedule_balances_the_timing_shapes(b, s, h):
    """Key tiles per block within 1.15x of the mean; handing the
    heaviest-first tiles round-robin to the blocks left the busiest block
    1.34x the mean at s = 12288."""
    offsets, tiles = tfa.fwd_schedule(b, s, s, h, True, None, 132)
    nqt = -(-s // 128)

    def work(t):   # causal: query tile q reads key tiles 0 .. q
        return nqt - t // (b * h)

    loads = [sum(work(t) for t in tiles[a:e]) for a, e in zip(offsets, offsets[1:])]
    assert max(loads) <= 1.15 * sum(loads) / 132
