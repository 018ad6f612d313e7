"""The CUDA kernels of torchgpipe_tpu_torch against their plain versions.

Needs an NVIDIA GPU with nvcc; every test skips without a card.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's, derived there: bf16 forward output 3.2e-2
(two bf16 ulps of |o| < 5), float32 decode output 2e-4 (summation order
over <= 1152 terms).
"""

import pytest
import torch

from torchgpipe_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 3.2e-2
DECODE_TOL = 2e-4


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
     (200, 4, 1, 128, None, False)],
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
    "g,pos0,window,hd,dtype",
    [(1, 0, None, 128, torch.bfloat16), (1, 1151, None, 128, torch.bfloat16),
     (4, 600, 256, 128, torch.bfloat16), (2, 77, 9, 64, torch.float32)],
)
def test_flash_decode_kernel_matches_plain(cuda_device, g, pos0, window, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, g, 8, hd, generator=gen, device=cuda_device).to(dtype)
    ck = torch.randn(2, 1152, 2, hd, generator=gen, device=cuda_device).to(dtype)
    cv = torch.randn(2, 1152, 2, hd, generator=gen, device=cuda_device).to(dtype)
    pos0 = min(pos0, 1152 - g)
    out = tfa.flash_decode_attention(q, ck, cv, pos0, window=window)
    ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= DECODE_TOL


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
