"""The arithmetic of the 3xTF32 float32 forward (``csrc/flash_fwd_tf32.cu``)
and the host-side plans of the kernels that now run float32 attention and
decode at other head dims, on the CPU.

The tensor cores read a float32 operand as TF32 (sign, exponent, 10
mantissa bits).  One TF32 product moves a product by ~2^-11 relative;
3xTF32 splits each operand into ``big`` (the TF32 value) and ``small``
(the rest, itself read as TF32) and adds ``As Bb + Ab Bs + Ab Bb``
(``ops.flash_attention.tf32_split``).  Emulated here with bit masks and
float64 sums (products of two TF32 values are exact in float64), an
attention forward at d=128 over 1024 keys lands as close to float64 as
plain float32 does (~3e-7 of O(1) outputs), while one TF32 product a term
misses by ~6e-4: the 1e-4 tolerance that ``chip_smoke.py`` and the CUDA
tests hold the kernel to needs no loosening, and would catch 1xTF32.
"""

import numpy as np
import pytest
import torch

from torchgpipe_tpu_torch.ops import flash_attention as tfa

F32_TOL = 1e-4


def _tf32(x):
    """x as the tensor core reads it: the low 13 mantissa bits dropped."""
    return tfa.tf32_split(x)[0]


def _mm_3x(a, b):
    ab, a_s = tfa.tf32_split(a)
    bb, b_s = tfa.tf32_split(b)
    ab, a_s, bb, b_s = (t.double() for t in (ab, _tf32(a_s), bb, _tf32(b_s)))
    return (a_s @ bb + ab @ b_s + ab @ bb).float()


def _mm_1x(a, b):
    return (_tf32(a).double() @ _tf32(b).double()).float()


def _attention(q, k, v, mm):
    """Softmax attention in float32 with both products through ``mm``:
    ``(o, lse)``."""
    s = mm(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + l.log()).squeeze(-1)


def test_tf32_split_is_exact():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = torch.cat([x * 1e-20, x, x * 1e20, torch.tensor([0.0, -0.0, 1.0, -3.0])])
    big, small = tfa.tf32_split(x)
    assert torch.equal(big + small, x)
    assert bool(((big.view(torch.int32) & 8191) == 0).all())
    assert bool((small.abs() <= 2.0 ** -10 * x.abs()).all())


def test_3xtf32_attention_stays_inside_the_float32_tolerance():
    """d=128, 1024 keys: 3xTF32 against float64 as plain float32 is;
    1xTF32 outside the tolerance."""
    rng = np.random.default_rng(0)
    h, s, sk, d = 2, 256, 1024, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((h, s, d), (h, sk, d), (h, sk, d)))
    s64 = (q.double() @ k.double().transpose(1, 2)) * d ** -0.5
    o64, lse64 = torch.softmax(s64, -1) @ v.double(), torch.logsumexp(s64, -1)

    def err(mm):
        o, lse = _attention(q, k, v, mm)
        return max((o.double() - o64).abs().max().item(),
                   (lse.double() - lse64).abs().max().item())

    plain, three, one = err(torch.matmul), err(_mm_3x), err(_mm_1x)
    assert three <= 4 * plain and three <= F32_TOL / 50
    assert one > F32_TOL


@pytest.mark.parametrize("b,s,sk,h,causal,window,d", [
    (2, 1024, 1024, 32, True, None, 64), (4, 512, 512, 32, True, None, 64),
    (1, 129, 129, 8, True, None, 128), (2, 333, 333, 8, False, None, 80),
    (2, 700, 700, 8, True, 100, 32), (2, 300, 77, 4, False, None, 36),
    (1, 17, 17, 4, True, None, 4),
])
def test_tf32_forward_schedule_runs_every_tile_once(b, s, sk, h, causal, window, d):
    """The 3xTF32 forward's work list (``fwd_schedule`` at ``TF32_TILES``:
    128-row/64-key tiles up to d=64, 64/32 above): every (head, query
    tile) once, at most one block per SM, each block a contiguous run."""
    rows, keys = tfa.TF32_TILES[64 if d <= 64 else 128]
    offsets, tiles = tfa.fwd_schedule(b, s, sk, h, causal, window, 132, rows, keys)
    assert sorted(tiles) == list(range(b * h * -(-s // rows)))
    assert offsets[0] == 0 and offsets[-1] == len(tiles) and len(offsets) - 1 <= 132
    assert all(a < e for a, e in zip(offsets, offsets[1:]))


@pytest.mark.parametrize("hd", [8, 16, 20, 24, 30, 32, 36, 48, 64, 72, 80, 96, 112, 128, 136])
def test_decode_and_tf32_gates_at_other_head_dims(hd):
    """``supports_decode`` takes a head dim up to 128 whose cache row is a
    multiple of 16 bytes, for each cache type; the float32 forward takes
    d % 4 == 0."""
    q, k = (2, 1, 8, hd), (2, 64, 2, hd)
    for dtype, elem in ((torch.bfloat16, 2), (torch.float32, 4), (torch.int8, 1)):
        assert tfa.supports_decode(q, k, None, dtype) == (hd <= 128 and hd * elem % 16 == 0)
    assert tfa.supports_tf32((2, 16, 8, hd), (2, 16, 2, hd)) == (hd <= 128 and hd % 4 == 0)
