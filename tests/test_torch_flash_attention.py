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


def _assert_grads_close(got, want, rel):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
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
                                   torch.float16)
    assert not tfa.supports_decode((4, 1, 32, 128), (4, 1152, 8, 128), 0)
    t = torch.zeros(1, 1, 2, 128)
    c = torch.zeros(1, 8, 2, 128)
    s = torch.zeros(1, 2, 8)
    with pytest.raises(TypeError, match="int8 cache"):
        tfa.flash_decode_attention(t, c, c, 0, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(t, c, c, causal=False, window=4)
    with pytest.raises(TypeError, match="host int"):
        tfa.flash_decode_attention(t, c, c, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside the cache"):
        tfa.flash_decode_attention(t, c, c, 8)
