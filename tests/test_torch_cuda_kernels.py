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
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    rdq, rdk, rdv = tfa._reference_grads(q, k, v, do, lse, delta, causal, scale, None)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= FWD_TOL
    assert (lse - rlse).abs().max().item() <= 2e-3
    assert bwd_row_ratio(dq, rdq) <= 1.0
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
@pytest.mark.parametrize("b,s,h,g,d,window", [(2, 1024, 32, 8, 128, None),
                                              (1, 4096, 4, 1, 128, None),
                                              (2, 1000, 8, 2, 64, 300)])
def test_flash_bwd_dq_is_bitwise_deterministic(cuda_device, b, s, h, g, d, window):
    """dQ stays in registers across the key loop and is written once: no
    atomics, so two calls give equal bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, do = (torch.randn(b, s, h, d, generator=gen, device=cuda_device).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, s, g, d, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    o, lse = tfa._flash_fwd(q, k, v, True, d ** -0.5, window)
    delta = tfa._delta(do, o)
    kw = dict(causal=True, sm_scale=d ** -0.5, window=window)
    first = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    second = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
     # Long caches: chunks of many 64-key tiles (decode_split).
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
    "dtype,n_head_dim",
    [(torch.float16, 128), (torch.bfloat16, 256), (torch.float32, 256)],
)
def test_generation_on_the_card_raises_for_what_the_kernels_do_not_take(
    cuda_device, dtype, n_head_dim
):
    """prefill and generate call the kernels on the card and never fall
    back to the plain version: what no kernel takes (float16, a head dim
    above 128) raises."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab=64, dim=192, n_layers=1, n_heads=2,
                               n_kv_heads=1, n_head_dim=n_head_dim, dtype=dtype)
    model = tt.llama(cfg, device=cuda_device)
    prompt = torch.zeros(1, 16, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        tg.prefill(cfg, model, prompt, 20)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        tg.generate(cfg, model, prompt, 2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,n_head_dim,route",
    [(torch.float32, 128, "f32"), (torch.float32, 80, "f32"),
     (torch.bfloat16, 96, "pad")],
)
def test_generation_on_the_card_routes_what_the_kernels_do_not_take(
    cuda_device, dtype, n_head_dim, route
):
    """prefill and generate route attention as ``attention_route`` says,
    always to a kernel: float32 through the 3xTF32 forward, bf16 at d=96
    through the forward kernel on a zero-padded head dim; the decode
    through ``flash_decode`` at the real head dim (128, 80 and 96 rows are
    multiples of 16 bytes; a cache is never padded).  The bf16 forward
    wrapper still refuses those shapes when called directly."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab=64, dim=192, n_layers=1, n_heads=2,
                               n_kv_heads=1, n_head_dim=n_head_dim, dtype=dtype)
    model = tt.llama(cfg, device=cuda_device)
    prompt = torch.zeros(1, 16, dtype=torch.int64, device=cuda_device)
    tfa.reset_launches()
    tg.prefill(cfg, model, prompt, 20)
    tg.generate(cfg, model, prompt, 2)
    torch.cuda.synchronize()
    fwd = (tfa.flash_attention.launches, tfa.flash_attention_tf32.launches,
           tfa.flash_attention_f32.launches)
    assert fwd == ((0, 2, 0) if route == "f32" else (2, 0, 0))
    dec = (tfa.flash_decode_attention.launches, tfa.flash_decode_simt.launches)
    assert dec == (2, 0)
    q = torch.zeros(1, 16, 2, n_head_dim, device=cuda_device, dtype=dtype)
    with pytest.raises((TypeError, ValueError)):
        tfa.flash_attention(q, q[:, :, :1], q[:, :, :1])


def _decode_inputs(gen, b, g, nh, nkv, hd, L, kind, device):
    """q and a cache of `kind` (bf16, f32 or int8 with scales) as keyword
    arguments of flash_decode_attention."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn(b, g, nh, hd, generator=gen, device=device).to(dtype)
    if kind == "int8":
        ck, ks = _int8_cache(gen, b, L, nkv, hd, device)
        cv, vs = _int8_cache(gen, b, L, nkv, hd, device)
        return q, ck, cv, dict(k_scale=ks, v_scale=vs)
    ck, cv = (torch.randn(b, L, nkv, hd, generator=gen, device=device).to(dtype)
              for _ in range(2))
    return q, ck, cv, {}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,g,pos0,window,hd,L",
    [("bf16", 1, 1087, None, 128, 1152), ("bf16", 5, 576, None, 128, 581),
     ("bf16", 4, 600, 256, 128, 1152), ("f32", 2, 77, 9, 64, 1152),
     ("int8", 1, 1087, None, 128, 1152), ("int8", 5, 300, 64, 64, 517),
     ("bf16", 1, 19999, None, 128, 20000)],
)
def test_flash_decode_tensor_pos0_equals_host_int(cuda_device, kind, g, pos0, window,
                                                  hd, L):
    """pos0 as a 0-d int32 CUDA tensor: the kernel reads it on the device
    and derives the same split, so the output has the host int's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, ck, cv, sc = _decode_inputs(gen, 2, g, 8, 2, hd, L, kind, cuda_device)
    host = tfa.flash_decode_attention(q, ck, cv, pos0, window=window, **sc)
    dev = tfa.flash_decode_attention(
        q, ck, cv, torch.tensor(pos0, dtype=torch.int32, device=cuda_device),
        window=window, **sc)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window, **sc)
    torch.cuda.synchronize()
    assert torch.equal(host, dev)
    assert (dev - ref).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_flash_decode_graph_replays_at_two_lengths(cuda_device, kind):
    """One decode call captured in a CUDA graph with a device pos0, replayed
    after writing two live lengths into it: each replay equals the eager
    call at that length (the grid does not depend on pos0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, ck, cv, sc = _decode_inputs(gen, 4, 1, 32, 8, 128, 1152, kind, cuda_device)
    pos = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up: build, work-list caches
        tfa.flash_decode_attention(q, ck, cv, pos, **sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.flash_decode_attention(q, ck, cv, pos, **sc)
    for p in (1000, 100, 1151):
        pos.fill_(p)
        graph.replay()
        want = tfa.flash_decode_attention(q, ck, cv, p, **sc)
        ref = tfa.flash_decode_reference(q, ck, cv, p, **sc)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert (out - ref).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
def test_flash_decode_tensor_pos0_is_clamped(cuda_device):
    """A device pos0 past the cache is clamped to max_len - g, as the
    reference's index maps clamp (a host int is refused instead)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, ck, cv, _ = _decode_inputs(gen, 1, 2, 8, 2, 128, 300, "bf16", cuda_device)
    big = torch.tensor(10_000, dtype=torch.int32, device=cuda_device)
    got = tfa.flash_decode_attention(q, ck, cv, big)
    want = tfa.flash_decode_attention(q, ck, cv, 298)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside the cache"):
        tfa.flash_decode_attention(q, ck, cv, 299)


# csrc/flash_simt.cu: every product in float32 FMAs on both sides, so the
# kernels and the plain versions differ only in summation order (~1e-6 of
# O(1) outputs over <= 2048 keys and <= 128 dims): 1e-4 absolute on the
# forward, and per row 1e-4 of the row's largest gradient plus a floor of
# 1e-4 of the median row's.  The floor is for rows that are zero in exact
# arithmetic (query 0's dQ: p = 1, dS = dP - delta = 0), where each side
# keeps the float32 noise of dP - delta (~1e-6 of |dP| ~ sqrt(d)) times
# |k| * scale: a few 1e-7 absolute, ~1e-5 of a median row's max.
F32_TOL = 1e-4
F32_ROW_TOL, F32_FLOOR = 1e-4, 1e-4


def f32_row_ratio(got, want):
    scale = want.abs().amax(-1)
    tol = F32_ROW_TOL * scale + F32_FLOOR * scale.median()
    return ((got - want).abs().amax(-1) / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,h,g,d,window,causal",
    [(1024, 8, 2, 128, None, True), (333, 4, 4, 64, 50, True),
     (200, 4, 1, 80, None, False), (17, 8, 1, 32, None, True),
     (1000, 8, 2, 80, 300, True), (129, 4, 2, 96, None, True)],
)
def test_flash_simt_f32_matches_plain(cuda_device, s, h, g, d, window, causal):
    """float32 forward, dQ and dK/dV against the plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, s, n, d, generator=gen, device=cuda_device)
               .requires_grad_() for n in (h, g, g))
    do = torch.randn(2, s, h, d, generator=gen, device=cuda_device)
    before = (tfa.flash_attention_f32.launches, tfa.flash_bwd_dq_f32.launches,
              tfa.flash_bwd_dkv_f32.launches)
    out = tfa.flash_attention_f32(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = tfa.flash_attention_reference(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_f32.launches, tfa.flash_bwd_dq_f32.launches,
            tfa.flash_bwd_dkv_f32.launches) == tuple(n + 1 for n in before)
    assert (out - ref).abs().max().item() <= F32_TOL
    for a, b in zip(got, want):
        assert f32_row_ratio(a, b) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,g,pos0,window,hd,L",
    [("bf16", 1, 1087, None, 80, 1152), ("bf16", 5, 576, None, 32, 581),
     ("f32", 4, 600, 256, 80, 1152), ("f32", 2, 77, 9, 96, 1152),
     ("int8", 1, 1087, None, 80, 1152), ("int8", 5, 300, 64, 32, 517),
     ("bf16", 1, 19999, None, 80, 20000)],
)
def test_flash_decode_simt_matches_plain(cuda_device, kind, g, pos0, window, hd, L):
    """The CUDA-core decode at head dims the tensor-core decode does not
    take, with a host and a device ``pos0`` (equal bits)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, ck, cv, sc = _decode_inputs(gen, 2, g, 8, 2, hd, L, kind, cuda_device)
    before = tfa.flash_decode_simt.launches
    host = tfa.flash_decode_simt(q, ck, cv, pos0, window=window, **sc)
    dev = tfa.flash_decode_simt(
        q, ck, cv, torch.tensor(pos0, dtype=torch.int32, device=cuda_device),
        window=window, **sc)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window, **sc)
    torch.cuda.synchronize()
    assert tfa.flash_decode_simt.launches == before + 2
    assert torch.equal(host, dev)
    assert (dev - ref).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
def test_flash_decode_simt_graph_replays_at_two_lengths(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, ck, cv, sc = _decode_inputs(gen, 4, 1, 32, 8, 80, 1152, "bf16", cuda_device)
    pos = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    tfa.flash_decode_simt(q, ck, cv, pos, **sc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.flash_decode_simt(q, ck, cv, pos, **sc)
    for p in (1000, 100, 1151):
        pos.fill_(p)
        graph.replay()
        want = tfa.flash_decode_simt(q, ck, cv, p, **sc)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_flash_simt_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_f32(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_attention_f32(q[..., :64].bfloat16().contiguous(),
                                q[..., :64].bfloat16().contiguous(),
                                q[..., :64].bfloat16().contiguous())
    c = torch.zeros(1, 64, 2, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_decode_simt(q[:, :1].contiguous(), c, c, 3)


# flash_decode at head dims other than 64 and 128: the tiles of the 64 or
# 128 instantiation, the tensor maps over the real head dim (TMA fills
# the columns past it with zeros).  The same arithmetic as at 64/128, so
# DECODE_TOL holds.
@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,g,pos0,window,hd,L,nh,nkv",
    [("bf16", 1, 527, None, 80, 544, 32, 32), ("bf16", 5, 576, None, 32, 581, 8, 2),
     ("bf16", 3, 400, 100, 48, 500, 16, 4), ("bf16", 1, 19999, None, 80, 20000, 32, 8),
     ("f32", 2, 1000, 9, 96, 1152, 8, 2), ("f32", 4, 600, 256, 80, 1152, 8, 2),
     ("f32", 5, 200, None, 36, 300, 10, 2), ("int8", 5, 300, 64, 32, 517, 8, 4),
     ("int8", 1, 1087, None, 80, 1152, 8, 2), ("int8", 2, 900, None, 112, 1000, 16, 16)],
)
def test_flash_decode_other_head_dims_match_plain(cuda_device, kind, g, pos0, window, hd, L,
                                                  nh, nkv):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, ck, cv, sc = _decode_inputs(gen, 2, g, nh, nkv, hd, L, kind, cuda_device)
    assert tfa.attention_route(q.shape, ck.shape, q.dtype, window=window, decode=True,
                               cache_dtype=ck.dtype).kind == "kernel"
    before = (tfa.flash_decode_attention.launches, tfa.flash_decode_attention.launches_int8,
              tfa.flash_decode_simt.launches)
    host = tfa.flash_decode_attention(q, ck, cv, pos0, window=window, **sc)
    dev = tfa.flash_decode_attention(
        q, ck, cv, torch.tensor(pos0, dtype=torch.int32, device=cuda_device),
        window=window, **sc)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window, **sc)
    torch.cuda.synchronize()
    quant = kind == "int8"
    assert (tfa.flash_decode_attention.launches, tfa.flash_decode_attention.launches_int8,
            tfa.flash_decode_simt.launches) == (before[0] + 2 * (not quant),
                                                before[1] + 2 * quant, before[2])
    assert torch.equal(host, dev)
    assert (dev - ref).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,hd", [("bf16", 80), ("f32", 96)])
def test_flash_decode_other_head_dims_graph_replays_at_two_lengths(cuda_device, kind, hd):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, ck, cv, sc = _decode_inputs(gen, 4, 1, 32, 8, hd, 1152, kind, cuda_device)
    pos = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    tfa.flash_decode_attention(q, ck, cv, pos, **sc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.flash_decode_attention(q, ck, cv, pos, **sc)
    for p in (1000, 100, 1151):
        pos.fill_(p)
        graph.replay()
        want = tfa.flash_decode_attention(q, ck, cv, p, **sc)
        ref = tfa.flash_decode_reference(q, ck, cv, p, **sc)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert (out - ref).abs().max().item() <= DECODE_TOL


# csrc/flash_fwd_tf32.cu: 3xTF32 products (~2^-21 relative each) summed in
# float32, against the plain float32 version: the F32 tolerances above
# (tests/test_torch_tf32_split.py measures the split against float64).
@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,g,d,window,causal,sk",
    [(2, 1024, 32, 8, 64, None, True, None), (1, 129, 8, 8, 128, None, True, None),
     (2, 333, 8, 2, 80, None, False, None), (2, 700, 8, 4, 32, 100, True, None),
     (2, 200, 4, 1, 96, None, True, None), (1, 17, 4, 2, 64, None, True, None),
     (2, 1000, 8, 2, 128, 300, True, None), (2, 300, 4, 4, 36, None, False, 77),
     (1, 64, 2, 1, 4, None, True, None)],
)
def test_flash_fwd_tf32_matches_plain(cuda_device, b, s, h, g, d, window, causal, sk):
    """The 3xTF32 forward (O and LSE) and the gradients it feeds to
    flash_simt's backward kernels, against the plain versions."""
    sk = sk or s
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda_device).requires_grad_()
    k, v = (torch.randn(b, sk, g, d, generator=gen, device=cuda_device).requires_grad_()
            for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen, device=cuda_device)
    before = (tfa.flash_attention_tf32.launches, tfa.flash_attention_f32.launches,
              tfa.flash_bwd_dq_f32.launches, tfa.flash_bwd_dkv_f32.launches)
    out = tfa.flash_attention_tf32(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = tfa._flash_fwd_tf32(q.detach(), k.detach(), v.detach(), causal, d ** -0.5, window)
    ro, rl = tfa._reference_fwd(q.detach(), k.detach(), v.detach(), causal, d ** -0.5, window)
    ref = tfa.flash_attention_reference(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_tf32.launches, tfa.flash_attention_f32.launches,
            tfa.flash_bwd_dq_f32.launches, tfa.flash_bwd_dkv_f32.launches) == (
        before[0] + 2, before[1], before[2] + 1, before[3] + 1)
    assert torch.equal(o, out.detach())
    assert (out - ref).abs().max().item() <= F32_TOL
    assert (lse - rl).abs().max().item() <= F32_TOL
    for a, c in zip(got, want):
        assert f32_row_ratio(a, c) <= 1.0


@pytest.mark.cuda
def test_new_routes_refuse_what_their_kernels_do_not_take(cuda_device):
    """flash_attention_tf32 and flash_decode_attention raise, launching
    nothing, on the rows TMA cannot map (those route to flash_simt) and
    on what no kernel takes."""
    n = (tfa.flash_attention_tf32.launches, tfa.flash_decode_attention.launches,
         tfa.flash_decode_attention.launches_int8)
    q = torch.zeros(1, 64, 4, 30, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_tf32(q, q, q)
    assert tfa.attention_route(q.shape, q.shape, q.dtype).kind == "simt"
    big = torch.zeros(1, 64, 4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_tf32(big, big, big)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_attention_tf32(*(torch.zeros(1, 64, 4, 64, device=cuda_device).bfloat16()
                                   for _ in range(3)))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for kind, hd in (("int8", 24), ("bf16", 20), ("f32", 30), ("bf16", 256)):
        qd, ck, cv, sc = _decode_inputs(gen, 1, 1, 8, 2, hd, 64, kind, cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_decode_attention(qd, ck, cv, 3, **sc)
        want = "none" if hd > 128 else "simt"
        assert tfa.attention_route(qd.shape, ck.shape, qd.dtype, decode=True,
                                   cache_dtype=ck.dtype).kind == want
    assert (tfa.flash_attention_tf32.launches, tfa.flash_decode_attention.launches,
            tfa.flash_decode_attention.launches_int8) == n
