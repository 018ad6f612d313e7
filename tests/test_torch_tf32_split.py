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


def _row_ratio(got, want):
    """chip_smoke.py's ``simt_rows``: the worst row's error over 1e-4 of
    the row's largest magnitude plus 1e-4 of the median row's."""
    scale = want.abs().amax(-1)
    tol = F32_TOL * scale + F32_TOL * scale.median()
    return ((got - want).abs().amax(-1) / tol).max().item()


def _backward(q, k, v, do, mm):
    """The backward kernels' five products through ``mm``, from float64's
    LSE and delta: ``(dq, dk, dv)``.  Transposes are explicit copies, as
    the kernels read Qt, dOt and Kt."""
    scale = q.shape[-1] ** -0.5
    s64 = (q.double() @ k.double().transpose(1, 2)) * scale
    lse = torch.logsumexp(s64, -1, keepdim=True).float()
    o = (torch.softmax(s64, -1) @ v.double()).float()
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(mm(q, k.transpose(1, 2).contiguous()) * scale - lse)
    dp = mm(do, v.transpose(1, 2).contiguous())
    ds = p * (dp - delta)
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(1, 2).contiguous(), q) * scale
    dv = mm(p.transpose(1, 2).contiguous(), do)
    return dq, dk, dv


def test_3xtf32_backward_stays_inside_the_row_tolerance():
    """d=128 over 1024 keys: the backward's five products (S, dP, dQ, dK,
    dV) in 3xTF32 hold every row of dQ, dK and dV to float64 as closely as
    plain float32 does, far inside the row tolerance that chip_smoke.py and
    the CUDA tests hold ``flash_bwd_tf32.cu`` to, so that tolerance needs no
    loosening for the tensor cores; one TF32 product a term falls outside
    it, so the tolerance would catch a kernel that dropped the split."""
    rng = np.random.default_rng(1)
    h, s, sk, d = 2, 128, 1024, 128
    q, do = (torch.from_numpy(rng.standard_normal((h, s, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((h, sk, d)).astype(np.float32))
            for _ in range(2))
    want = _backward(q.double(), k.double(), v.double(), do.double(), torch.matmul)

    def worst(mm):
        got = _backward(q, k, v, do, mm)
        return max(_row_ratio(a.double(), c) for a, c in zip(got, want))

    plain, three, one = worst(torch.matmul), worst(_mm_3x), worst(_mm_1x)
    assert three <= 4 * plain and three <= 0.1
    assert one > 1.0


def test_tf32_transpose_mirrors_the_prologue_layout():
    """``tf32_transpose`` (the prologue's Qt/dOt/Kt, and its plain
    version's): position p of each aligned group of 8 holds position 0 2 4
    6 1 3 5 7, zeros past n up to a multiple of 32; an accumulator whose
    columns are taken in that order (the A fragments) times it is the
    product in natural order, exactly.  The prologue's buffer holds every
    part of ``tf32_bwd_split_shapes`` in order, big + small exact."""
    rng = np.random.default_rng(2)
    b, n, heads, d = 2, 37, 3, 12
    x = torch.from_numpy(rng.integers(-8, 8, (b, n, heads, d)).astype(np.float32))
    xt = tfa.tf32_transpose(x)
    assert xt.shape == (b, heads, d, 64)
    j = np.arange(64) % 8
    perm = np.arange(64) - j + np.where(j < 4, 2 * j, 2 * j - 7)
    assert sorted(perm[:40].tolist()) == list(range(40))
    for p in range(64):
        src = perm[p]
        want = x[:, src] if src < n else torch.zeros(b, heads, d)
        assert torch.equal(xt[..., p], want)
    m = torch.from_numpy(rng.integers(-8, 8, (heads, 16, 64)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 64 - n))[0].transpose(0, 1)  # [heads, 64, d]
    assert torch.equal(m[..., perm] @ xt[0].transpose(1, 2), m @ xp)
    q, do = (torch.from_numpy(rng.standard_normal((b, 33, 4, 8)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, 70, 2, 8)).astype(np.float32))
            for _ in range(2))
    shapes = tfa.tf32_bwd_split_shapes(b, 33, 70, 4, 2, 8)
    flat = tfa.tf32_bwd_split(q, k, v, do)
    parts, at = {}, 0
    for name, shape in shapes.items():
        size = int(np.prod(shape))
        parts[name] = flat[at:at + size].reshape(shape)
        at += size
    assert at == flat.numel()
    for name, t in (("q", q), ("do", do), ("k", k), ("v", v)):
        assert torch.equal(parts[name + "b"] + parts[name + "s"], t)
        assert bool(((parts[name + "b"].view(torch.int32) & 8191) == 0).all())
    for name, t in (("q", q), ("do", do), ("k", k)):
        assert torch.equal(parts[name + "tb"] + parts[name + "ts"], tfa.tf32_transpose(t))


# dkv_schedule at the 3xTF32 kernel's tiles (128- or 64-key items over
# 32-query tiles), on the shapes of test_torch_flash_attention.py's schedule tests
# and the float32 step's micro-batch.
_DKV_TF32_SHAPES = [
    # (b, s, sk, h, g, causal, window)
    (2, 1024, 1024, 32, 8, True, None),
    (4, 512, 512, 32, 8, True, None),
    (2, 17, 17, 8, 8, True, None),
    (2, 129, 129, 4, 1, True, None),
    (2, 191, 191, 8, 2, True, None),
    (2, 700, 700, 8, 4, True, 100),
    (2, 333, 333, 4, 4, True, 50),
    (2, 333, 333, 8, 2, False, None),
    (1, 300, 700, 4, 2, True, 100),
    (2, 300, 77, 4, 4, False, None),
]


def _attended_tile_pairs(b, s, sk, h, causal, window, keys, queries):
    """Every (batch, query head, query tile, key tile) holding an attended
    (query, key) pair: over a tile pair q - k spans q0 - k_last ..
    q_last - k0, which must meet [0, window)."""
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


@pytest.mark.parametrize("dt", [64, 128])
@pytest.mark.parametrize("b,s,sk,h,g,causal,window", _DKV_TF32_SHAPES)
def test_dkv_schedule_at_the_tf32_tiles_runs_every_pair_once(b, s, sk, h, g, causal,
                                                            window, dt):
    """At either template dim's tiles (128 or 64 keys, 32 queries): every
    (query head, query tile, key tile) pair that attends runs exactly
    once, no SM holds more than the mean work plus one iteration, a cut
    combo's slots follow its iterations, and the default tiles give the
    bf16 kernel's lists unchanged."""
    keys, queries = tfa.TF32_DKV_TILES[dt]
    sch = tfa.dkv_schedule(b, s, sk, h, g, causal, window, 132, keys, queries)
    r, nkt = h // g, -(-sk // keys)
    seen = {}
    for bi, kvh, kt, jq0, ntile, it0, it1, _ in sch.items:
        assert 0 <= it0 < it1 <= r * ntile
        for t in range(it0, it1):
            key = (bi, kvh * r + t // ntile, jq0 + t % ntile, kt)
            seen[key] = seen.get(key, 0) + 1
    assert set(seen.values()) <= {1}
    assert set(seen) == _attended_tile_pairs(b, s, sk, h, causal, window, keys, queries)
    loads = [sum(it[6] - it[5] for it in sch.items[a:e])
             for a, e in zip(sch.offsets, sch.offsets[1:])]
    assert len(loads) <= 132 and max(loads) <= -(-sum(loads) // 132) + 1
    assert len(sch.combos) == b * g * nkt
    for c, (first, count) in enumerate(sch.combos):
        pieces = sorted((it for it in sch.items if (it[0] * g + it[1]) * nkt + it[2] == c),
                        key=lambda it: it[5])
        if count > 0:
            assert [it[7] for it in pieces] == list(range(first, first + count))
        else:
            assert len(pieces) == -count and all(it[7] == -1 for it in pieces)
    assert tfa.dkv_schedule(b, s, sk, h, g, causal, window, 132) == tfa.dkv_schedule(
        b, s, sk, h, g, causal, window, 132, tfa.DKV_KEYS, tfa.DKV_QUERIES)


@pytest.mark.parametrize("b,s,sk,h,causal,window,d", [
    (2, 1024, 1024, 32, True, None, 64), (4, 512, 512, 32, True, None, 64),
    (1, 129, 129, 8, True, None, 128), (2, 333, 333, 8, False, None, 80),
    (2, 700, 700, 8, True, 100, 32),
])
def test_tf32_dq_schedule_runs_every_tile_once(b, s, sk, h, causal, window, d):
    """The 3xTF32 dQ's work list (``fwd_schedule`` at ``TF32_DQ_TILES``:
    128-row/32-key tiles up to d=64, 64/32 above): every (head, query
    tile) once, each block a contiguous run."""
    rows, keys = tfa.TF32_DQ_TILES[64 if d <= 64 else 128]
    offsets, tiles = tfa.fwd_schedule(b, s, sk, h, causal, window, 132, rows, keys)
    assert sorted(tiles) == list(range(b * h * -(-s // rows)))
    assert offsets[0] == 0 and offsets[-1] == len(tiles) and len(offsets) - 1 <= 132
    assert all(a < e for a, e in zip(offsets, offsets[1:]))
