"""The CUDA kernels of torchgpipe_tpu_torch against their plain versions.

Needs an NVIDIA GPU with nvcc; every test skips without a card.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's, derived there: bf16 forward output 3.2e-2
(two bf16 ulps of |o| < 5), float32 decode output 2e-4 (summation order
over <= 1152 terms; for an int8 cache the plain version dequantizes each
element where the kernel scales each score and weight, one rounding per
key apart), bf16 gradients row by row: for each (batch,
position, head) row, 2^-6 of the row's largest magnitude (one bf16 ulp
between the two output roundings plus the bf16 rounding of P and dS inside
the products, ~3 x 2^-8 of it) plus a floor of 2^-9 of the median row's
largest magnitude (for rows that are zero in exact arithmetic).  Causal
gradients span orders of magnitude across rows, so a tolerance per tensor
would hide a tile left out of a loop.  The wgmma self-test of
csrc/hopper_tiles.cuh against torch.matmul: bf16 products are exact in
float32 and only the order of the <= 128-term sums differs (~1e-6 of
|c| ~ 11), so 1e-3 absolute; a wrong descriptor or swizzle moves whole
rows or columns by O(1).
"""

import ctypes

import pytest
import torch

from torchgpipe_tpu_torch.ops import _build
from torchgpipe_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 3.2e-2
DECODE_TOL = 2e-4
BWD_ROW_TOL = 2 ** -6
BWD_FLOOR = 2 ** -9


def bwd_row_ratio(got, want):
    """Worst ratio of a row's error to its tolerance (<= 1 passes)."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(-1)
    tol = BWD_ROW_TOL * scale + BWD_FLOOR * scale.median()
    return ((g - w).abs().amax(-1) / tol).max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,h,g,d,window,causal",
    [(1024, 8, 2, 128, None, True), (1000, 8, 2, 128, None, True),
     (1024, 8, 2, 128, 256, True), (333, 4, 4, 64, 50, True),
     (200, 4, 1, 128, None, False),
     # Edges of the 64/128-row tiles and of the dK/dV work items.
     (17, 8, 1, 128, None, True), (129, 4, 4, 128, None, True),
     (191, 8, 8, 64, None, True), (2112, 8, 1, 128, None, True),
     (1000, 8, 2, 64, 300, True), (129, 4, 1, 64, None, False)],
)
def test_flash_fwd_kernel_matches_plain(cuda_device, s, h, g, d, window, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, s, h, d, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(2, s, g, d, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(2, s, g, d, generator=gen, device=cuda_device).bfloat16()
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    ref = tfa.flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= FWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,h,g,d,window,causal",
    [(1024, 8, 2, 128, None, True), (1000, 8, 2, 128, None, True),
     (1024, 8, 2, 128, 256, True), (333, 4, 4, 64, 50, True),
     (200, 4, 1, 128, None, False),
     # Edges of the 64/128-row tiles and of the dK/dV work items.
     (17, 8, 1, 128, None, True), (129, 4, 4, 128, None, True),
     (191, 8, 8, 64, None, True), (2112, 8, 1, 128, None, True),
     (1000, 8, 2, 64, 300, True), (129, 4, 1, 64, None, False)],
)
def test_flash_bwd_kernels_match_plain(cuda_device, s, h, g, d, window, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn(2, s, n, d, generator=gen, device=cuda_device).bfloat16()
        for n in (h, g, g)
    )
    do = torch.randn(2, s, h, d, generator=gen, device=cuda_device).bfloat16()
    scale = d ** -0.5
    o, lse = tfa._flash_fwd(q, k, v, causal, scale, window)
    delta = tfa._delta(do, o)
    kw = dict(causal=causal, sm_scale=scale, window=window)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    ref = tfa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1
    )
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert bwd_row_ratio(got, want) <= 1.0
    if window is not None:
        # The check's reach: the same LSE and delta over half the band
        # (keys left out of both kernels' loops) must fail it.
        cut = tfa._reference_grads(q, k, v, do, lse, delta, causal, scale,
                                   window // 2)
        for got, want in zip((dq, dk, dv), cut):
            assert bwd_row_ratio(got, want) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("s,sk,causal", [(200, 333, False), (333, 200, True),
                                         (130, 1000, True)])
def test_flash_kernels_with_other_key_lengths(cuda_device, s, sk, causal):
    """s_k != s: queries and keys both count from 0 (keys past s are never
    attended under the causal mask, and their dK/dV rows are zeros)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, s, 8, 128, generator=gen, device=cuda_device).bfloat16()
    k, v = (torch.randn(2, sk, 2, 128, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    do = torch.randn(2, s, 8, 128, generator=gen, device=cuda_device).bfloat16()
    scale = 128 ** -0.5
    o, lse = tfa._flash_fwd(q, k, v, causal, scale, None)
    ro, rlse = tfa._reference_fwd(q, k, v, causal, scale, None)
    delta = tfa._delta(do, o)
    kw = dict(causal=causal, sm_scale=scale, window=None)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    _, rdk, rdv = tfa._reference_grads(q, k, v, do, lse, delta, causal, scale, None)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= FWD_TOL
    assert (lse - rlse).abs().max().item() <= 2e-3
    for got, want in ((dk, rdk), (dv, rdv)):
        if causal and sk > s:
            # Keys past the last query: no query attends them.
            assert not got[:, s:].any()
            got, want = got[:, :s], want[:, :s]
        assert bwd_row_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,d", [(2, 1024, 32, 8, 128), (1, 4096, 4, 1, 128),
                                       (2, 1000, 8, 2, 64)])
def test_flash_bwd_dkv_is_bitwise_deterministic(cuda_device, b, s, h, g, d):
    """No atomics: partial sums go to their own slots and are added in
    item order, so two calls give equal bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, do = (torch.randn(b, s, h, d, generator=gen, device=cuda_device).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, s, g, d, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    o, lse = tfa._flash_fwd(q, k, v, True, d ** -0.5, None)
    delta = tfa._delta(do, o)
    kw = dict(causal=True, sm_scale=d ** -0.5, window=None)
    first = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    second = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_hopper_tiles_wgmma_self_test(cuda_device, mode):
    """csrc/hopper_selftest.cu: one TMA-loaded, 128-byte-swizzled tile per
    operand form of csrc/hopper_tiles.cuh, against torch.matmul.  Modes 0/1:
    C[64, n] = A[64, 128] B[n, 128]^T (both K-major, n = 64 / 128); modes
    2/3: C[64, n] = A[64, 64] B[64, n] (A from registers, B MN-major)."""
    gen = torch.Generator(device=cuda_device).manual_seed(mode)
    n = 128 if mode % 2 else 64
    if mode < 2:
        a = torch.randn(64, 128, generator=gen, device=cuda_device).bfloat16()
        b = torch.randn(n, 128, generator=gen, device=cuda_device).bfloat16()
        want = a.float() @ b.float().T
    else:
        a = torch.randn(64, 64, generator=gen, device=cuda_device).bfloat16()
        b = torch.randn(64, n, generator=gen, device=cuda_device).bfloat16()
        want = a.float() @ b.float()
    c = torch.full((64, n), float("nan"), device=cuda_device)
    P = ctypes.c_void_p
    fn = _build.function("hopper_selftest", "tgt_hopper_selftest",
                         [ctypes.c_int, P, P, P, ctypes.c_int, P])
    rc = fn(mode, P(a.data_ptr()), P(b.data_ptr()), P(c.data_ptr()), 64 * 128,
            P(torch.cuda.current_stream().cuda_stream))
    _build.check(rc, "hopper_selftest")
    torch.cuda.synchronize()
    assert (c - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_attention_backward_launches_both_kernels(cuda_device):
    q = torch.randn(1, 128, 4, 128, device=cuda_device).bfloat16().requires_grad_()
    k = torch.randn(1, 128, 2, 128, device=cuda_device).bfloat16().requires_grad_()
    v = torch.randn(1, 128, 2, 128, device=cuda_device).bfloat16().requires_grad_()
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1
    )
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.cuda
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 4, 128, device=cuda_device).bfloat16()
    lse = torch.zeros(4, 64, device=cuda_device)
    kw = dict(causal=True, sm_scale=1.0, window=None)
    for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(TypeError, match="bfloat16"):
            fn(q.float(), q.float(), q.float(), q.float(), lse, lse, **kw)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, q, q, q.transpose(1, 2), lse, lse, **kw)
        with pytest.raises(ValueError, match="float32"):
            fn(q, q, q, q, lse.bfloat16(), lse, **kw)
        odd = torch.zeros(1, 64, 4, 96, device=cuda_device).bfloat16()
        with pytest.raises(ValueError, match="head dim"):
            fn(odd, odd, odd, odd, lse, lse, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,pos0,window,hd,dtype",
    [(1, 0, None, 128, torch.bfloat16), (1, 1151, None, 128, torch.bfloat16),
     (4, 600, 256, 128, torch.bfloat16), (2, 77, 9, 64, torch.float32),
     (5, 1000, None, 128, torch.bfloat16), (8, 500, 100, 64, torch.float32),
     (1, 500, None, 64, torch.bfloat16),
     # Long caches: chunks grow past 64 keys (DECODE_BLOCKS).
     (1, 19999, None, 128, torch.bfloat16), (5, 15000, 9000, 64, torch.float32)],
)
def test_flash_decode_kernel_matches_plain(cuda_device, g, pos0, window, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    L = 20000 if pos0 > 1152 else 1152
    q = torch.randn(2, g, 8, hd, generator=gen, device=cuda_device).to(dtype)
    ck = torch.randn(2, L, 2, hd, generator=gen, device=cuda_device).to(dtype)
    cv = torch.randn(2, L, 2, hd, generator=gen, device=cuda_device).to(dtype)
    pos0 = min(pos0, L - g)
    out = tfa.flash_decode_attention(q, ck, cv, pos0, window=window)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= DECODE_TOL


def _int8_cache(gen, b, L, nkv, hd, device):
    """An int8 cache and its float32 [b, nkv, L] scales, from random rows
    quantized as the generation path quantizes them."""
    from torchgpipe_tpu_torch.models.generation import _quant_rows

    rows = torch.randn(b, L, nkv, hd, generator=gen, device=device) * 2
    q, s = _quant_rows(rows)
    return q, s.transpose(1, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,pos0,window,hd,L,qdtype",
    [(1, 0, None, 128, 1152, torch.bfloat16),
     (1, 1087, None, 128, 1152, torch.bfloat16),
     (4, 600, 256, 128, 1152, torch.bfloat16),
     (5, 999, None, 128, 1000, torch.bfloat16),   # 20 rows: two row groups
     (5, 300, 64, 64, 517, torch.float32),
     (2, 77, 9, 64, 1152, torch.bfloat16),
     (8, 40, None, 64, 100, torch.float32),       # 32 rows
     (1, 20000, None, 128, 20480, torch.bfloat16),  # chunks past 64 keys
     (5, 20000, 3000, 64, 20480, torch.float32)],
)
def test_flash_decode_int8_kernel_matches_plain(cuda_device, g, pos0, window, hd,
                                                L, qdtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, g, 16, hd, generator=gen, device=cuda_device).to(qdtype)
    ck, ks = _int8_cache(gen, 2, L, 4, hd, cuda_device)
    cv, vs = _int8_cache(gen, 2, L, 4, hd, cuda_device)
    pos0 = min(pos0, L - g)
    before = (tfa.flash_decode_attention.launches,
              tfa.flash_decode_attention.launches_int8)
    out = tfa.flash_decode_attention(q, ck, cv, pos0, window=window,
                                     k_scale=ks, v_scale=vs)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (tfa.flash_decode_attention.launches,
            tfa.flash_decode_attention.launches_int8) == (before[0], before[1] + 1)
    assert (out - ref).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
def test_flash_decode_int8_refusals(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, 1, 8, 128, generator=gen, device=cuda_device).bfloat16()
    ck, ks = _int8_cache(gen, 1, 64, 2, 128, cuda_device)
    n = (tfa.flash_decode_attention.launches, tfa.flash_decode_attention.launches_int8)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tfa.flash_decode_attention(q, ck, ck, 3, k_scale=ks)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        tfa.flash_decode_attention(q, ck, ck, 3, k_scale=ks.transpose(1, 2),
                                   v_scale=ks)
    with pytest.raises(TypeError, match="bfloat16 or float32 q"):
        tfa.flash_decode_attention(q.half(), ck, ck, 3, k_scale=ks, v_scale=ks)
    with pytest.raises(TypeError, match="int8 cache"):
        tfa.flash_decode_attention(q, ck.bfloat16(), ck.bfloat16(), 3,
                                   k_scale=ks, v_scale=ks)
    assert (tfa.flash_decode_attention.launches,
            tfa.flash_decode_attention.launches_int8) == n


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 4, 128, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(qb.transpose(1, 2), qb, qb)
    odd = torch.zeros(1, 64, 4, 96, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(odd, odd, odd)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,n_head_dim,error,match",
    [(torch.float32, 128, TypeError, "bfloat16"),
     (torch.bfloat16, 96, ValueError, "head dim")],
)
def test_generation_on_the_card_raises_for_what_the_kernels_do_not_take(
    cuda_device, dtype, n_head_dim, error, match
):
    """prefill and generate call the kernels on the card and never fall
    back to the plain version."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab=64, dim=192, n_layers=1, n_heads=2,
                               n_kv_heads=1, n_head_dim=n_head_dim, dtype=dtype)
    model = tt.llama(cfg, device=cuda_device)
    prompt = torch.zeros(1, 16, dtype=torch.int64, device=cuda_device)
    with pytest.raises(error, match=match):
        tg.prefill(cfg, model, prompt, 20)
    with pytest.raises(error, match=match):
        tg.generate(cfg, model, prompt, 2)
