"""Flash attention forward, backward and KV-cache decode: CUDA kernels
for Hopper.

Counterpart of ``torchgpipe_tpu/ops/flash_attention.py``.  On the TPU
each pass exists twice (K/V resident in VMEM, or streamed on a grid
axis) because of VMEM size; on Hopper one tile loop serves every length.

* :func:`flash_attention` launches ``csrc/flash_fwd.cu``, bfloat16 or
  float16 (replaces
  ``_fwd_kernel`` and ``_fwd_stream_kernel``).  It is differentiable: a
  ``torch.autograd.Function`` saves ``(q, k, v, o, lse)``, as the
  reference's ``_flash_vjp_fwd`` does, and its backward launches
  :func:`flash_bwd_dq` (replaces ``_dq_kernel`` and ``_dq_stream_kernel``)
  and :func:`flash_bwd_dkv` (replaces ``_dkv_kernel`` and
  ``_dkv_stream_kernel``), both in ``csrc/flash_bwd.cu``.
* ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` run one persistent
  block per SM over a work list that this module builds in plain Python
  and caches per shape (:func:`fwd_schedule`: query tiles, longest first
  onto the least loaded block, for the forward and for dQ;
  :func:`dkv_schedule`: the causal dK/dV loops cut so that every SM holds
  the mean work), so the CPU tests cover the balance.
* :func:`flash_decode_attention` launches ``csrc/flash_decode.cu``, which
  replaces ``_decode_kernel``: a bf16, float16 or float32 cache, or an int8 cache
  with float32 per-(position, kv head) scales (the ``quant=True``
  variant), dequantized in registers, at any head dim up to 128 whose
  cache row TMA can map (:func:`supports_decode`).  ``pos0`` may be a
  device int32 scalar: the kernel derives its split of the live keys on
  the device (:func:`decode_split` mirrors it), and its grid depends only
  on the cache's size.
* :func:`flash_attention_tf32` launches ``csrc/flash_fwd_tf32.cu``, the
  float32 forward on the tensor cores at float32 accuracy (3xTF32, the
  split of :func:`tf32_split`; the reference's kernels take float32);
  its backward launches :func:`tf32_bwd_split` (a prologue writing the
  split operands, some transposed), then :func:`flash_bwd_dq_tf32` and
  :func:`flash_bwd_dkv_tf32`, all in ``csrc/flash_bwd_tf32.cu``.
* :func:`flash_attention_f32` (with :func:`flash_bwd_dq_f32` and
  :func:`flash_bwd_dkv_f32`) and :func:`flash_decode_simt` launch
  ``csrc/flash_simt.cu``, CUDA-core kernels for the shapes TMA cannot map:
  a float32 head dim that is not a multiple of 4, a decode cache row that
  is not a multiple of 16 bytes.  :func:`flash_attention_wide` (with
  :func:`flash_bwd_dq_wide` and :func:`flash_bwd_dkv_wide`) and
  :func:`flash_decode_wide` launch the same kernels at head dims 129 to
  256 and at every multiple of 128 above 256 (the reference's; above 512
  the chunked kernels, which split the output head dim over the grid) in
  bfloat16, float16 or float32, except at
  head dim 256 (Gemma's):
  there the forward, dQ and dK/dV in bfloat16 or float16 run the
  tensor-core kernels' d=256 instantiation, and the decode of a bfloat16,
  float16 or int8 cache ``csrc/flash_decode.cu``'s 256 tiles
  (:func:`wide_kernel`).
* :func:`attention_route` says which of these a shape runs on (a
  bfloat16 head dim below 128 is zero-padded for the tensor-core
  kernels); :func:`attention` and :func:`decode_attention` follow it.

Each wrapper launches its kernel for CUDA tensors and raises for what the
kernel does not take (device, dtype, contiguity, head dim).  It runs the
plain PyTorch version beside it (:func:`flash_attention_reference`,
:func:`_reference_bwd`, :func:`flash_decode_reference`) only when its
inputs lie on the CPU, or on the meta device, where nothing runs and
``balance.layer_flops`` counts the FLOPs of shapes.  Each keeps a plain-integer count of kernel
launches in its ``launches`` attribute; the decode wrapper keeps one
count per variant, ``launches`` for a bf16/float32 cache and
``launches_int8`` for an int8 cache, and adds one to exactly one of them
a launch; so do the wide wrappers, ``launches`` for
``csrc/flash_simt.cu`` and ``launches_d256`` for the tensor-core kernels.
A launch recorded into a CUDA graph capture is not counted (its replays
launch the kernel without the wrapper; ``chip_smoke.py`` counts those
from a profile).  The plain versions never touch them.  :func:`reset_launches`
sets every count to 0.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torchgpipe_tpu_torch import checkpoint as _ckpt
from torchgpipe_tpu_torch.ops import _build

_NEG = -1e30
# Devices whose tensors take the plain versions: the CPU, and meta
# (shapes only: FLOP counting).
_PLAIN_DEVICES = ("cpu", "meta")
FWD_HEAD_DIMS = (64, 128)
# The decode kernel's tile dims: a head dim up to 64 runs on the 64 tiles,
# up to 128 on the 128 ones (csrc/flash_decode.cu HD).
DECODE_HEAD_DIMS = (64, 128)
DECODE_KEYS = 64      # keys per decode tile (csrc/flash_decode.cu KT)
DECODE_ROWS = 32      # query rows a decode block holds (MAX_ROWS)
# Decode blocks per SM that the split aims at: one for a bf16/f32 cache
# (bytes set the pace; on an H100 two per SM read ~5% slower at a
# 32704-key cache), two for an int8 cache (its per-tile work sets the
# pace).  Measurements in PERF.md.
DECODE_WAVE = {False: 1, True: 2}
# At head dim 256 a block's K/V ring takes 128 KB (csrc/flash_decode.cu
# Cfg::RING), so one block fits an SM whatever the cache type.
DECODE_WAVE_D256 = 1
# Element-type codes of csrc/flash_decode.cu.
_DECODE_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
                 torch.float16: 3}
# Element types of the tensor-core forward and backward kernels, by the
# suffix of their C entry points.
_HALF_TYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}

# C signatures (csrc/*.cu): pointers and the stream as c_void_p.
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse, tiles, nblocks, b, s, sk, h, g, d, scale, causal,
# window, stream
_FWD_ARGS = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dq, plan, nblocks, b, s, sk, h, g, d, scale,
# causal, window, stream
_BWD_DQ_ARGS = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dk, dv, items, offsets, combos, partial,
# nblocks, sum, b, s, sk, h, g, d, scale, causal, window, stream
_BWD_DKV_ARGS = [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]
# q, ck, cv, k_scale, v_scale, out, scratch, pos_dev, pos_host, b, g, nh,
# nkv, hd, max_len, window, want, zmax, q_type, kv_type, stream
_DECODE_ARGS = [_P] * 8 + [_I] * 12 + [_P]


def _validate_window(causal: bool, window: Optional[int]) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    if window < 1:
        raise ValueError("window must be >= 1")


# --------------------------------------------------------------------- #
# plain PyTorch versions                                                #
# --------------------------------------------------------------------- #


def _reference_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked softmax in float32: ``(out [b, s, h, d] in q.dtype,
    lse [b*h, s] float32)``.  Query ``i`` and key ``j`` both count from
    0, as in the kernels' ``_mask_causal``."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    r = h // g
    qg = q.reshape(b, s, g, r, d).float()
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qg, k.float()) * sm_scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        valid = kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        scores = scores.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)               # [b, g, r, s]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqs,bsgd->bqgrd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype), lse.reshape(b * h, s)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of :func:`flash_attention`: the dense causal
    (optionally banded) GQA softmax of ``generation._attend_full``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _reference_fwd(q, k, v, causal, sm_scale, window)[0]


def _delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in float32 as ``[b*h, s]`` (the reference
    computes it outside Pallas too, ``_flash_bwd_resident``)."""
    b, s, h, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                 # [b, s, h]
    return d.permute(0, 2, 1).reshape(b * h, s).contiguous()


def _reference_grads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool, sm_scale: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense float32 ``(dq, dk, dv)`` from the saved LSE and ``delta``,
    the kernels' arithmetic: ``p = exp(s - lse)``, ``dv = pᵀ·do``,
    ``dp = do·vᵀ``, ``ds = p*(dp - delta)``, ``dq = ds·k·scale``,
    ``dk = dsᵀ·q·scale``, dk/dv summed over each kv head's ``h/g`` query
    heads.  Cast to the inputs' dtypes."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    r = h // g
    qf = q.reshape(b, s, g, r, d).float()
    dof = do.reshape(b, s, g, r, d).float()
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qf, kf) * sm_scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        valid = kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.exp(scores - lse.reshape(b, g, r, s, 1))
    dv = torch.einsum("bgrqs,bqgrd->bsgd", p, dof)
    dp = torch.einsum("bqgrd,bsgd->bgrqs", dof, vf)
    ds = p * (dp - delta.reshape(b, g, r, s, 1))
    dq = torch.einsum("bgrqs,bsgd->bqgrd", ds, kf) * sm_scale
    dk = torch.einsum("bgrqs,bqgrd->bsgd", ds, qf) * sm_scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _reference_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool, sm_scale: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernels: ``(dq, dk, dv)`` of
    :func:`flash_attention` from its residuals ``(q, k, v, o, lse)`` and
    the output cotangent ``do``."""
    return _reference_grads(
        q, k, v, do, lse, _delta(do, o), causal, sm_scale, window
    )


def dequant_rows(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 cache rows ``[b, L, nkv, hd]`` times their float32 scales
    ``[b, nkv, L]`` (positions last, the cache's layout), in float32: the
    reference's ``_dequant_rows``."""
    return rows.float() * scale.transpose(1, 2)[..., None]


def flash_decode_reference(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of :func:`flash_decode_attention`: ``g``
    consecutive queries (positions ``pos0 .. pos0+g-1``) against the
    whole cache, masked to ``<= qpos`` (and the window band), float32.
    ``pos0`` is a scalar or ``[b]`` (one frontier per row, the serving
    pool's case).  With ``k_scale``/``v_scale`` the cache is int8 and is
    dequantized first (:func:`dequant_rows`).  Returns float32
    ``[b, g, nh*hd]``."""
    if k_scale is not None:
        ck, cv = dequant_rows(ck, k_scale), dequant_rows(cv, v_scale)
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    r = nh // nkv
    qg = q.reshape(b, g, nkv, r, hd).float()
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qg, ck.float()) * (hd ** -0.5)
    p0 = torch.as_tensor(pos0, device=q.device)
    qpos = p0.reshape(-1, 1, 1) + torch.arange(g, device=q.device)[None, :, None]
    idx = torch.arange(max_len, device=q.device)[None, None, :]
    valid = idx <= qpos                                 # [B', g, max_len]
    if window is not None:
        valid &= idx > qpos - window
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqs,bsgd->bqgrd", p, cv.float())
    return out.reshape(b, g, nh * hd)


# --------------------------------------------------------------------- #
# gates                                                                 #
# --------------------------------------------------------------------- #


def supports(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether ``csrc/flash_fwd.cu`` takes these shapes on the kernel
    route: bfloat16 or float16, head dim 64 or 128, ``h`` a multiple of
    ``g``.  Any sequence length (the ragged last tile is masked).  Its
    head-dim-256 instantiation (and ``csrc/flash_bwd.cu``'s dQ) runs on
    the wide route (:func:`supports_wide`, :func:`wide_kernel`), beside
    the CUDA-core dK/dV and decode there."""
    b, s, h, d = q_shape
    g = k_shape[2]
    return (
        dtype in _HALF_TYPES and d in FWD_HEAD_DIMS and g > 0 and h % g == 0
        and k_shape[3] == d
    )


def supports_decode(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    window: Optional[int], dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether ``csrc/flash_decode.cu`` takes these shapes: a bfloat16,
    float16, float32 or int8 cache (``dtype``), a head dim up to 128 whose
    cache row is a multiple of 16 bytes (TMA's stride rule: bf16 and f16 ``hd % 8``,
    float32 ``hd % 4``, int8 ``hd % 16``), ``nh`` a multiple of ``nkv``.
    Any cache length and any number of query rows (a block holds at most
    32 of a kv head's ``g * nh / nkv`` rows; more rows take more
    blocks)."""
    b, g, nh, hd = q_shape
    nkv = k_shape[2]
    return (
        dtype in _DECODE_TYPES
        and 0 < hd <= DECODE_HEAD_DIMS[-1] and hd * dtype.itemsize % 16 == 0
        and k_shape[3] == hd and nkv > 0 and nh % nkv == 0
        and (window is None or window >= 1)
    )


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{what}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _check_tma(what: str, *ts: torch.Tensor) -> None:
    """The TMA tensor maps of flash_fwd.cu / flash_bwd.cu need 16-byte
    aligned bases."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")


def _count(fn: Any, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel.  Inside a CUDA graph capture the
    launch is recorded, not run, and is not counted: the graph's replays
    run it without passing through the wrapper."""
    if not torch.cuda.is_current_stream_capturing():
        setattr(fn, attr, getattr(fn, attr) + 1)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# --------------------------------------------------------------------- #
# work lists of the persistent kernels                                  #
# --------------------------------------------------------------------- #

FWD_ROWS = 128     # query rows per forward tile (csrc/flash_fwd.cu BQ)
FWD_KEYS = 128     # keys per K/V tile (BK_OF) up to head dim 128
DQ_ROWS = 128      # query rows per dQ tile (csrc/flash_bwd.cu DQ_BQ)
DQ_KEYS = 64       # keys per dQ K/V tile (DqSmem::BK) up to head dim 128
# Head dim 256 on the tensor-core forward and dQ (the wide route's "tc"
# kernels, :func:`wide_kernel`): smaller K/V tiles, so that a block's
# tiles fit its 227 KB of shared memory.
TC_WIDE_HEAD_DIM = 256
FWD_KEYS_D256 = 64
DQ_KEYS_D256 = 32


def fwd_tile(d: int) -> Tuple[int, int]:
    """``(rows, keys)`` of ``csrc/flash_fwd.cu``'s tiles at head dim ``d``."""
    return FWD_ROWS, FWD_KEYS_D256 if d == TC_WIDE_HEAD_DIM else FWD_KEYS


def dq_tile(d: int) -> Tuple[int, int]:
    """``(rows, keys)`` of ``csrc/flash_bwd.cu``'s dQ tiles at head dim
    ``d``."""
    return DQ_ROWS, DQ_KEYS_D256 if d == TC_WIDE_HEAD_DIM else DQ_KEYS


def fwd_key_tiles(q0: int, s: int, sk: int, causal: bool,
                  window: Optional[int], rows: int = FWD_ROWS,
                  keys: int = FWD_KEYS) -> Tuple[int, int]:
    """``(first, n)``: the key tiles ``first .. first+n-1`` that the query
    tile of ``rows`` rows from ``q0`` reads (csrc/hopper_tiles.cuh
    ``QueryTile``): up to the diagonal, from the window's first."""
    nkt = -(-sk // keys)
    first = 0
    if causal:
        nkt = min(nkt, (min(q0 + rows, s) - 1) // keys + 1)
        if window is not None:
            first = max(q0 - (window - 1), 0) // keys
    return first, max(nkt - first, 0)


def fwd_schedule(
    b: int, s: int, sk: int, h: int, causal: bool, window: Optional[int],
    n_sms: int, rows: int = FWD_ROWS, keys: int = FWD_KEYS,
) -> Tuple[List[int], List[int]]:
    """``(offsets, tiles)`` of a persistent kernel over query tiles of
    ``rows`` rows and K/V tiles of ``keys`` keys (the forward's 128/128 by
    default; the kernels take :func:`fwd_tile` and :func:`dq_tile` of their
    head dim):
    block ``i`` runs ``tiles[offsets[i]:offsets[i+1]]``.  Tile ``t`` is
    query tile ``nqt-1-t//(b*h)`` of head ``t % (b*h)``.  Longest
    processing time first: tiles sorted by their key-tile count (plus one
    for the epilogue), each given to the least loaded block, so a long
    causal sequence (tiles of 1..s/128 key tiles) balances as well as many
    short ones."""
    nqt = -(-s // rows)
    bhn = b * h
    n = nqt * bhn
    blocks = min(n_sms, n)
    cost = [fwd_key_tiles((nqt - 1 - t // bhn) * rows, s, sk, causal,
                          window, rows, keys)[1] + 1 for t in range(n)]
    heap = [(0, i) for i in range(blocks)]
    lists: List[List[int]] = [[] for _ in range(blocks)]
    for t in sorted(range(n), key=lambda t: (-cost[t], t)):
        load, i = heapq.heappop(heap)
        lists[i].append(t)
        heapq.heappush(heap, (load + cost[t], i))
    offsets, tiles = [0], []
    for blk in lists:
        tiles.extend(blk)
        offsets.append(len(tiles))
    return offsets, tiles


@functools.lru_cache(maxsize=64)
def _fwd_plan(device: torch.device, *key,
              tile: Tuple[int, int] = (FWD_ROWS, FWD_KEYS)) -> Tuple[torch.Tensor, int]:
    """:func:`fwd_schedule` of ``key = (b, s, sk, h, causal, window)`` and
    ``tile = (rows, keys)`` on ``device``'s SMs as one int32 device tensor
    (offsets, then tiles) and its block count."""
    offsets, tiles = fwd_schedule(*key, _sm_count(device), *tile)
    return (torch.tensor(offsets + tiles, dtype=torch.int32, device=device),
            len(offsets) - 1)


DKV_KEYS = 128     # keys per work item (csrc/flash_bwd.cu DkvSmem::BK) up to head dim 128
DKV_QUERIES = 64   # queries per Q/dO tile (KV_BQ)
# Head dim 256: 64-key items that both consumer warpgroups take (one owns
# dV, the other dK), so that a block's tiles and accumulators fit.
DKV_KEYS_D256 = 64


def dkv_tile(d: int) -> Tuple[int, int]:
    """``(keys, queries)`` of ``csrc/flash_bwd.cu``'s dK/dV items at head
    dim ``d``: the key tile of an item and the Q/dO tile of its loop."""
    return DKV_KEYS_D256 if d == TC_WIDE_HEAD_DIM else DKV_KEYS, DKV_QUERIES


def dkv_slot_floats(d: int) -> int:
    """Floats of one f32 scratch slot of the dK/dV kernel at head dim
    ``d``: a cut item's dK and dV partials, ``2 * keys * d``."""
    return 2 * dkv_tile(d)[0] * d


class DkvSchedule(NamedTuple):
    """How a persistent dK/dV kernel (``csrc/flash_bwd.cu``,
    ``csrc/flash_bwd_tf32.cu``) splits one call.  A *combo* is one
    (batch, kv head, key tile: 128 keys by default); its work is a loop
    over (query head of the group, live query tile: 64 queries by
    default), ``r * ntile`` iterations.  ``items`` are contiguous ranges
    of those loops: ``(bi, kvh, kt, jq0, ntile, it0, it1, slot)``,
    iteration ``t`` being query head ``kvh * r + t // ntile`` and query
    tile ``jq0 + t % ntile``; ``slot`` is the item's f32 scratch slot, or
    -1 when the item holds its combo's whole loop and writes its output
    itself.  Block ``i`` runs ``items[offsets[i]:offsets[i+1]]``.  ``combos[c] =
    (first_slot, count)`` for combo ``c = (bi * g + kvh) * nkt + kt``:
    count -1 = written by its item, 0 = no query attends it (zeros)."""

    items: List[Tuple[int, ...]]
    offsets: List[int]
    combos: List[Tuple[int, int]]
    slots: int


def _dkv_live_tiles(kt: int, s: int, sk: int, causal: bool,
                    window: Optional[int], keys: int = DKV_KEYS,
                    queries: int = DKV_QUERIES) -> Tuple[int, int]:
    """``(first, count)`` of the ``queries``-query tiles that attend some
    key of ``keys``-key tile ``kt``: from the diagonal to the window's
    last query."""
    nq = -(-s // queries)
    if not causal:
        return 0, nq
    k0 = kt * keys
    first, end = k0 // queries, nq
    if window is not None:
        last_key = min(k0 + keys, sk) - 1
        end = min((last_key + window - 1) // queries + 1, nq)
    return first, max(end - first, 0)


def dkv_schedule(
    b: int, s: int, sk: int, h: int, g: int, causal: bool,
    window: Optional[int], n_sms: int, keys: int = DKV_KEYS,
    queries: int = DKV_QUERIES,
    whole: bool = False,
) -> DkvSchedule:
    """The balanced causal schedule of ``flash_bwd_dkv`` (``keys``-key
    combos over ``queries``-query tiles: 128/64 by default, 64/64 at head
    dim 256 (:func:`dkv_tile`); ``flash_bwd_dkv_tf32`` takes
    :data:`TF32_DKV_TILES`).  No SM holds more than ``per = ceil(total /
    n_sms)`` iterations.  With ``whole`` (the head-dim-256 kernel, whose
    64-key tiles make many short combos), where whole combos, longest
    first onto the least loaded SM, stay within ``per`` (phase 25's and
    the s=4096 shapes), each combo is one item that writes its output
    itself: no partials.  Otherwise combos sorted longest first fill the
    SMs in turn, each SM up to ``per``, a combo cut where an SM fills
    (McNaughton's wrap-around rule), so at most ``n_sms - 1`` combos are
    cut.  Pure and deterministic: the kernel's sums
    depend on the slots, not on which SM runs an item."""
    r = h // g
    nkt = -(-sk // keys)
    combos = []   # (work, combo index, bi, kvh, kt, jq0, ntile)
    for bi in range(b):
        for kvh in range(g):
            for kt in range(nkt):
                jq0, ntile = _dkv_live_tiles(kt, s, sk, causal, window, keys,
                                             queries)
                c = (bi * g + kvh) * nkt + kt
                combos.append((r * ntile, c, bi, kvh, kt, jq0, ntile))
    live = sorted((x for x in combos if x[0]), key=lambda x: (-x[0], x[1]))
    total = sum(x[0] for x in live)
    table = [(0, 0)] * len(combos)
    if total == 0:
        return DkvSchedule([], [0], table, 0)
    per = -(-total // min(n_sms, total))
    bins: List[List[list]] = []
    if whole:
        heap = [(0, i) for i in range(min(n_sms, len(live)))]
        dealt: List[List[list]] = [[] for _ in heap]
        for work, c, bi, kvh, kt, jq0, ntile in live:
            load, i = heapq.heappop(heap)
            dealt[i].append([bi, kvh, kt, jq0, ntile, 0, work, -1])
            heapq.heappush(heap, (load + work, i))
        if max(load for load, _ in heap) <= per:
            for x in live:
                table[x[1]] = (0, -1)
            bins = dealt
    slots = 0
    if not bins:
        bins = [[]]
        fill = 0
        pieces: Dict[int, List[list]] = {}
        for work, c, bi, kvh, kt, jq0, ntile in live:
            it = 0
            while it < work:
                take = min(work - it, per - fill)
                item = [bi, kvh, kt, jq0, ntile, it, it + take, -1]
                bins[-1].append(item)
                pieces.setdefault(c, []).append(item)
                it += take
                fill += take
                if fill == per:
                    bins.append([])
                    fill = 0
        for c in sorted(pieces):
            if len(pieces[c]) == 1:
                table[c] = (0, -1)
                continue
            table[c] = (slots, len(pieces[c]))
            for item in pieces[c]:
                item[7] = slots
                slots += 1
    items, offsets = [], [0]
    for blk in bins:
        if blk:
            items.extend(tuple(x) for x in blk)
            offsets.append(len(items))
    return DkvSchedule(items, offsets, table, slots)


@functools.lru_cache(maxsize=64)
def _dkv_plan(device: torch.device, *key,
              tile: Tuple[int, int] = (DKV_KEYS, DKV_QUERIES), whole: bool = False,
              ) -> Tuple[torch.Tensor, int, int, int, bool]:
    """:func:`dkv_schedule` of ``key = (b, s, sk, h, g, causal, window)``,
    ``tile = (keys, queries)`` and ``whole`` on ``device``'s SMs as one
    int32 device tensor (items, then offsets, then combos) with its block
    count, slot count, where the offsets start, and whether the sum kernel
    runs: always without ``whole``; with it only where a combo needs it
    (cut into slots, or no query attends it: zeros)."""
    sch = dkv_schedule(*key, _sm_count(device), *tile, whole)
    flat = [v for it in sch.items for v in it] + sch.offsets + [
        v for c in sch.combos for v in c]
    return (torch.tensor(flat, dtype=torch.int32, device=device),
            len(sch.offsets) - 1, sch.slots, 8 * len(sch.items),
            not whole or any(count >= 0 for _, count in sch.combos))


def decode_groups(rows: int) -> Tuple[int, int]:
    """``(ngroups, group_rows)``: a kv head's ``rows = g * nh / nkv``
    query rows cut into equal groups of at most :data:`DECODE_ROWS`, one
    decode block each (``csrc/flash_decode.cu``'s entry)."""
    ngroups = -(-rows // DECODE_ROWS)
    return ngroups, -(-rows // ngroups)


def decode_want(b: int, nkv: int, ngroups: int, n_sms: int, quant: bool,
                hd: int = DECODE_HEAD_DIMS[-1]) -> int:
    """The most chunks a (batch row, kv head, row group) is cut into:
    :data:`DECODE_WAVE` blocks per SM (``quant``: an int8 cache;
    :data:`DECODE_WAVE_D256` at head dim ``hd`` 256) over the ``b * nkv *
    ngroups`` block rows, at least 1."""
    wave = DECODE_WAVE_D256 if hd > DECODE_HEAD_DIMS[-1] else DECODE_WAVE[quant]
    return max(1, wave * n_sms // (b * nkv * ngroups))


def decode_split(pos0: int, g: int, window: Optional[int],
                 want: int) -> Tuple[int, int, int]:
    """``(first, chunk, nsplit)``: the decode kernel's split of the live
    keys ``[first, pos0 + g)`` into ``nsplit`` chunks of ``chunk`` keys
    (the last one shorter), 64-key tiles dealt in equal runs to at most
    ``want`` chunks.  The kernel computes the same on the device from the
    live length (``decode_split`` in ``csrc/flash_decode.cu``); the grid
    is sized by :func:`decode_zmax`, which no live length exceeds."""
    first = 0 if not window else max(pos0 - window + 1, 0)
    ntiles = -(-(pos0 + g - first) // DECODE_KEYS)
    per = -(-ntiles // min(ntiles, want))
    return first, per * DECODE_KEYS, -(-ntiles // per)


def decode_zmax(max_len: int, want: int) -> int:
    """The decode grid's split axis (and the scratch's): the most chunks
    any live length up to ``max_len`` needs."""
    return min(-(-max_len // DECODE_KEYS), want)


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------- #
# forward                                                               #
# --------------------------------------------------------------------- #


def _check_fwd_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The forward kernel is bf16 or f16 (one type for q/k/v): float32
    attention on the card is refused, never routed to the plain version."""
    if q.dtype not in _HALF_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_fwd kernel takes bfloat16 q/k/v, got {q.dtype}/"
            f"{k.dtype}/{v.dtype} (or float16 ones)"
        )


def _flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the kernel on CUDA tensors, the plain version on
    CPU tensors.  ``lse`` is float32 ``[b*h, s]`` in scaled-score units,
    as the reference kernel's residual."""
    if q.device.type in _PLAIN_DEVICES:
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda("flash_attention", q, k, v)
    _check_tma("flash_attention", q, k, v)
    _check_fwd_dtype(q, k, v)
    if not supports(q.shape, k.shape, q.dtype) or v.shape != k.shape:
        raise ValueError(
            f"flash_fwd kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: head dim must be one "
            f"of {FWD_HEAD_DIMS} and h a multiple of g"
        )
    out = _tc_fwd("flash_fwd", q, k, v, causal, sm_scale, window)
    _count(flash_attention)
    return out


def _tc_fwd(what, q, k, v, causal, sm_scale, window):
    """``(out, lse)`` from ``csrc/flash_fwd.cu`` (checked CUDA tensors of
    one 16-bit type, at an instantiated head dim)."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window,
                              tile=fwd_tile(d))
    fn = _build.function("flash_fwd", f"tgt_flash_fwd_{_HALF_TYPES[q.dtype]}",
                         _FWD_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(plan), nblocks,
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, what)
    return o, lse


# --------------------------------------------------------------------- #
# backward                                                              #
# --------------------------------------------------------------------- #


def _check_bwd(what: str, q, k, v, do, lse, delta) -> None:
    _check_cuda(what, q, k, v, do, lse, delta)
    _check_tma(what, q, k, v, do)
    if q.dtype not in _HALF_TYPES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(
            f"{what} kernel takes bfloat16 q/k/v/do, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype} (or float16 ones)"
        )
    b, s, h, _ = q.shape
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
            or lse.shape != (b * h, s) or delta.shape != (b * h, s):
        raise ValueError(f"{what}: lse and delta must be float32 [b*h, s]")
    if not supports(q.shape, k.shape, q.dtype) or v.shape != k.shape \
            or do.shape != q.shape:
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, do {tuple(do.shape)}: head "
            f"dim must be one of {FWD_HEAD_DIMS} and h a multiple of g"
        )


def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> torch.Tensor:
    """dQ ``[b, s, h, d]`` of :func:`flash_attention` from the output
    cotangent ``do``, the forward's ``lse`` and ``delta = rowsum(do*o)``
    (both float32 ``[b*h, s]``): ``csrc/flash_bwd.cu`` on CUDA tensors,
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    dq = _tc_dq("flash_bwd_dq", q, k, v, do, lse, delta, causal, sm_scale, window)
    _count(flash_bwd_dq)
    return dq


flash_bwd_dq.launches = 0


def _tc_dq(what, q, k, v, do, lse, delta, causal, sm_scale, window):
    """dQ from ``csrc/flash_bwd.cu`` (checked CUDA tensors of one 16-bit
    type, at an instantiated head dim)."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window,
                              tile=dq_tile(d))
    fn = _build.function("flash_bwd", f"tgt_flash_bwd_dq_{_HALF_TYPES[q.dtype]}",
                         _BWD_DQ_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        _ptr(plan), nblocks, b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, what)
    return dq


def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` ``[b, s_k, g, d]``, summed over each kv head's query
    heads, from the same inputs as :func:`flash_bwd_dq`."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    out = _tc_dkv("flash_bwd_dkv", q, k, v, do, lse, delta, causal, sm_scale, window)
    _count(flash_bwd_dkv)
    return out


flash_bwd_dkv.launches = 0


def _tc_dkv(what, q, k, v, do, lse, delta, causal, sm_scale, window):
    """``(dK, dV)`` from ``csrc/flash_bwd.cu`` (checked CUDA tensors of one
    16-bit type, at an instantiated head dim): the work list of
    :func:`dkv_schedule` at :func:`dkv_tile`, an f32 scratch slot
    (:func:`dkv_slot_floats`) for each cut item."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan, nblocks, slots, at_offsets, needs_sum = _dkv_plan(
        q.device, b, s, sk, h, g, bool(causal), window, tile=dkv_tile(d),
        whole=d == TC_WIDE_HEAD_DIM)
    at_combos = at_offsets + nblocks + 1
    partial = torch.empty(max(slots, 1) * dkv_slot_floats(d), dtype=torch.float32,
                          device=q.device)
    fn = _build.function("flash_bwd", f"tgt_flash_bwd_dkv_{_HALF_TYPES[q.dtype]}",
                         _BWD_DKV_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), _ptr(plan), _ptr(plan[at_offsets:]), _ptr(plan[at_combos:]),
        _ptr(partial), nblocks, int(needs_sum), b, s, sk, h, g, d, float(sm_scale),
        int(causal), 0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, what)
    return dk, dv


def _flash_backward(ctx, do, dq_fn, dkv_fn):
    """The backward of a flash ``autograd.Function`` that saved ``(q, k,
    v, o, lse)``: its dQ and dK/dV kernels, or, for CPU tensors, one call
    of the plain version."""
    q, k, v, o, lse = ctx.saved_tensors
    causal, sm_scale, window = ctx.args
    do = do.contiguous()
    delta = _delta(do, o)
    if q.device.type in _PLAIN_DEVICES:
        dq, dk, dv = _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )
    else:
        kw = dict(causal=causal, sm_scale=sm_scale, window=window)
        dq = dq_fn(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv, None, None, None


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_fwd`` saving ``(q, k, v, o, lse)``;
    backward through the two backward kernels, or, for CPU tensors, one
    call of the plain version.  Counterpart of the reference's ``_flash``
    custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _ckpt.flash_call(_flash_fwd, q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        return _flash_backward(ctx, do, flash_bwd_dq, flash_bwd_dkv)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention.  ``q: [b, s, h, d]``; ``k, v: [b, s_k, g, d]``
    with ``g`` dividing ``h`` (query head ``i`` reads kv head
    ``i // (h/g)``).  Returns ``[b, s, h, d]`` in ``q.dtype``.
    ``window`` (needs ``causal``): attend iff ``0 <= qpos - kpos <
    window``.  Differentiable in ``q``, ``k`` and ``v``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _FlashAttention.apply(q, k, v, causal, sm_scale, window)


flash_attention.launches = 0


# --------------------------------------------------------------------- #
# decode                                                                #
# --------------------------------------------------------------------- #


def _check_scales(
    ck: torch.Tensor, cv: torch.Tensor, k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
) -> bool:
    """Whether the cache is int8 with scales; raises for a half-given or
    misshapen pair, or scales beside a float cache (and the reverse)."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if quant != (ck.dtype == torch.int8) or cv.dtype != ck.dtype:
        raise TypeError(
            f"k_scale/v_scale go with an int8 cache and only with one; got a "
            f"{ck.dtype}/{cv.dtype} cache {'with' if quant else 'without'} scales"
        )
    if quant:
        want = (ck.shape[0], ck.shape[2], ck.shape[1])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(
                    f"{name} must be float32 [b, nkv, max_len] = {list(want)} "
                    f"(positions last), got {t.dtype} {list(t.shape)}"
                )
    return quant


# Query types of the decode kernels: a cache of the same type, or int8.
_QUERY_TYPES = (torch.bfloat16, torch.float16, torch.float32)


def _decode_args(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any,
    window: Optional[int], k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
) -> Tuple[bool, Optional[torch.Tensor], int]:
    """The decode wrappers' argument checks: ``(quant, pos_dev, pos0)``,
    ``pos_dev`` the device ``pos0`` tensor (else None and ``pos0`` a
    range-checked host int)."""
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    if nh % nkv != 0:
        raise ValueError(f"nh={nh} not divisible by nkv={nkv}")
    quant = _check_scales(ck, cv, k_scale, v_scale)
    pos_dev = None
    if isinstance(pos0, torch.Tensor):
        if pos0.ndim != 0 or pos0.dtype != torch.int32:
            raise TypeError(
                f"pos0 must be a host int or a 0-d int32 tensor, got "
                f"{pos0.dtype} of shape {list(pos0.shape)}"
            )
        if pos0.device != q.device:
            raise ValueError(f"pos0 is on {pos0.device}, q on {q.device}")
        if pos0.device.type == "cuda":
            pos_dev = pos0
    if pos_dev is None:
        pos0 = int(pos0)
        if not 0 <= pos0 <= max_len - g:
            raise ValueError(f"pos0={pos0} + g={g} outside the cache ({max_len})")
    return quant, pos_dev, pos0


def flash_decode_attention(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``g`` consecutive rope'd queries ``q: [b, g, nh, hd]`` (positions
    ``pos0 .. pos0+g-1``) against the live prefix ``[0, pos0+g)`` of a
    ``[b, max_len, nkv, hd]`` cache.  ``pos0`` is a host ``int`` or a 0-d
    int32 tensor on ``q``'s device, as the reference's runtime scalar
    (:func:`flash_decode_reference` also takes one per row).  The kernel
    reads a tensor ``pos0`` on the device and clamps it to ``[0, max_len
    - g]``; its grid and scratch depend on ``max_len``, not on ``pos0``, so
    a captured call replays at any length, and the two forms give equal
    bits.  A host ``int`` (and a CPU tensor) is range-checked.  With
    ``k_scale``/``v_scale`` (both or neither: float32 ``[b, nkv,
    max_len]``) the cache is int8, as the reference's ``QuantKVCache``
    stores it.  Returns float32 ``[b, g, nh*hd]``."""
    quant, pos_dev, pos0 = _decode_args(q, ck, cv, pos0, window, k_scale, v_scale)
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    if q.device.type == "cpu":
        return flash_decode_reference(q, ck, cv, pos0, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    scales = (k_scale, v_scale) if quant else ()
    _check_cuda("flash_decode_attention", q, ck, cv, *scales)
    if q.dtype not in _QUERY_TYPES or (not quant and ck.dtype != q.dtype):
        raise TypeError(
            f"flash_decode kernel takes a bfloat16, float16 or float32 q with "
            f"a cache of its type or an int8 cache, got {q.dtype}/{ck.dtype}/"
            f"{cv.dtype}"
        )
    if not supports_decode(q.shape, ck.shape, window, ck.dtype) \
            or cv.shape != ck.shape:
        raise ValueError(
            f"flash_decode kernel does not take q {tuple(q.shape)}, cache "
            f"{tuple(ck.shape)}: head dim must be at most "
            f"{DECODE_HEAD_DIMS[-1]} with a cache row of a multiple of 16 bytes"
        )
    out = _tc_decode("flash_decode", q, ck, cv, quant, pos_dev, pos0, window,
                     k_scale, v_scale)
    if quant:
        _count(flash_decode_attention, "launches_int8")
    else:
        _count(flash_decode_attention)
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_int8 = 0


def _tc_decode(what, q, ck, cv, quant, pos_dev, pos0, window, k_scale, v_scale):
    """Float32 ``[b, g, nh*hd]`` from ``csrc/flash_decode.cu`` (checked CUDA
    tensors and ``pos0`` forms, at a head dim one of its tile dims takes)."""
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    _check_tma(what, ck, cv)
    rows = g * (nh // nkv)
    ngroups, _ = decode_groups(rows)
    want = decode_want(b, nkv, ngroups, _sm_count(q.device), quant, hd)
    zmax = decode_zmax(max_len, want)
    out = torch.empty((b, g, nh * hd), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        (b, nkv, zmax, rows, 2 + hd), dtype=torch.float32, device=q.device
    )
    ks_p, vs_p = (_ptr(k_scale), _ptr(v_scale)) if quant else (None, None)
    fn = _build.function("flash_decode", "tgt_flash_decode", _DECODE_ARGS)
    rc = fn(
        _ptr(q), _ptr(ck), _ptr(cv), ks_p, vs_p, _ptr(out), _ptr(scratch),
        None if pos_dev is None else _ptr(pos_dev),
        0 if pos_dev is not None else pos0, b, g, nh, nkv, hd, max_len,
        0 if window is None else int(window), want, zmax,
        _DECODE_TYPES[q.dtype], _DECODE_TYPES[ck.dtype], _stream(q),
    )
    _build.check(rc, what)
    return out


# --------------------------------------------------------------------- #
# what TMA cannot map, and head dims above 128: csrc/flash_simt.cu     #
# --------------------------------------------------------------------- #

SIMT_HEAD_DIM_MAX = 128   # the float32 and decode routes below the wide dims
# The wide route: every head dim from 129 to 256, and above 256 every
# multiple of 128, as the reference's kernels take (csrc/flash_simt.cu's
# row kernels up to 512, its chunked kernels above).  The other head dims
# above 256 (320, 448, ...) the reference's callers compute densely.


def _wide_dim(d: int) -> bool:
    return SIMT_HEAD_DIM_MAX < d <= 256 or (d > 256 and d % 128 == 0)

_SIMT_TYPES = (torch.bfloat16, torch.float16, torch.float32)
# q, k, v, o, lse, b, s, sk, h, g, d, scale, causal, window, type, stream
_FWD_SIMT_ARGS = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
# q, k, v, dout, lse, delta, dq, b, s, sk, h, g, d, scale, causal, window,
# type, stream
_BWD_DQ_SIMT_ARGS = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
# q, k, v, dout, lse, delta, dk, dv, b, s, sk, h, g, d, scale, causal,
# window, type, stream
_BWD_DKV_SIMT_ARGS = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
# q, ck, cv, k_scale, v_scale, out, pos_dev, pos_host, b, g, nh, nkv, hd,
# max_len, window, scale, q_type, kv_type, stream
_DECODE_SIMT_ARGS = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]


def supports_f32(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
) -> bool:
    """Whether the float32 kernels of ``csrc/flash_simt.cu`` take these
    shapes on the float32 route: float32, any head dim up to 128, ``h`` a
    multiple of ``g``."""
    b, s, h, d = q_shape
    g = k_shape[2]
    return (
        dtype == torch.float32 and 0 < d <= SIMT_HEAD_DIM_MAX and g > 0
        and h % g == 0 and k_shape[3] == d
    )


def supports_wide(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether the wide route takes these shapes: bfloat16, float16 or
    float32, a head dim from 129 to 256 or a multiple of 128 above it, ``h`` a multiple
    of ``g``.  :func:`wide_kernel` says which kernels run them."""
    b, s, h, d = q_shape
    g = k_shape[2]
    return (
        dtype in _SIMT_TYPES and _wide_dim(d)
        and g > 0 and h % g == 0 and k_shape[3] == d
    )


def wide_kernel(q_shape: Tuple[int, ...], dtype: torch.dtype, *,
                decode: bool = False) -> str:
    """Which kernels a wide-route shape runs on: ``"tc"``, the tensor-core
    kernels at their head-dim-256 instantiation (Gemma's head dim, exactly
    256), or ``"simt"``, the CUDA-core kernels of ``csrc/flash_simt.cu``
    (the other wide head dims, 129 to 255 and the multiples of 128 above
    256, and float32).  Forward, dQ and
    dK/dV (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``): ``"tc"`` for
    bfloat16 or float16 ``dtype``.  The decode (``decode=True``, ``dtype``
    the cache's; ``csrc/flash_decode.cu``): ``"tc"`` for a bfloat16,
    float16 or int8 cache."""
    types = _DECODE_TC_WIDE if decode else _HALF_TYPES
    return "tc" if dtype in types and q_shape[-1] == TC_WIDE_HEAD_DIM else "simt"


# Cache types of the decode's head-dim-256 instantiation.
_DECODE_TC_WIDE = (torch.bfloat16, torch.float16, torch.int8)


def _decode_dims_ok(q_shape, k_shape, window, dtype, lo: int, hi: int) -> bool:
    b, g, nh, hd = q_shape
    nkv = k_shape[2]
    return (
        dtype in _DECODE_TYPES and lo < hd <= hi
        and k_shape[3] == hd and nkv > 0 and nh % nkv == 0
        and (window is None or window >= 1)
    )


def supports_decode_simt(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    window: Optional[int], dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether the decode of ``csrc/flash_simt.cu`` takes these shapes: a
    bfloat16, float16, float32 or int8 cache (``dtype``), any head dim up
    to 128, ``nh`` a multiple of ``nkv``."""
    return _decode_dims_ok(q_shape, k_shape, window, dtype, 0, SIMT_HEAD_DIM_MAX)


def supports_decode_wide(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    window: Optional[int], dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """:func:`supports_decode_simt` at head dims 129 to 256 and the
    multiples of 128 above 256."""
    return _wide_dim(q_shape[-1]) and _decode_dims_ok(
        q_shape, k_shape, window, dtype, SIMT_HEAD_DIM_MAX, q_shape[-1])


def _check_f32(what: str, *ts: torch.Tensor) -> None:
    _check_cuda(what, *ts)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(
            f"{what} kernel takes float32 operands, got "
            f"{'/'.join(str(t.dtype) for t in ts)}"
        )


def _check_f32_shapes(what: str, q, k, v, do=None) -> None:
    if not supports_f32(q.shape, k.shape, q.dtype) or v.shape != k.shape \
            or (do is not None and do.shape != q.shape):
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: head dim must be at most "
            f"{SIMT_HEAD_DIM_MAX} and h a multiple of g"
        )


def _check_wide(what: str, q, k, v, do=None, lse=None, delta=None) -> None:
    """The wide wrappers' checks: one element type for q/k/v (and do),
    float32 lse/delta, the :func:`supports_wide` shapes."""
    ts = [t for t in (q, k, v, do) if t is not None]
    _check_cuda(what, *ts, *[t for t in (lse, delta) if t is not None])
    if q.dtype not in _SIMT_TYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(
            f"{what} kernel takes bfloat16, float16 or float32 operands of one "
            f"type, got {'/'.join(str(t.dtype) for t in ts)}"
        )
    if any(t is not None and t.dtype != torch.float32 for t in (lse, delta)):
        raise TypeError(f"{what}: lse and delta must be float32")
    if not supports_wide(q.shape, k.shape, q.dtype) or v.shape != k.shape \
            or (do is not None and do.shape != q.shape):
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: head dim must be from "
            f"{SIMT_HEAD_DIM_MAX + 1} to 256 or a multiple of 128 above it and h "
            "a multiple of g"
        )


def _simt_fwd(what, q, k, v, causal, sm_scale, window):
    """``(out, lse)`` from ``csrc/flash_simt.cu``'s forward (checked
    CUDA tensors of one type)."""
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_simt", "tgt_flash_fwd_simt", _FWD_SIMT_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), b, s, sk, h, g, d,
        float(sm_scale), int(causal), 0 if window is None else int(window),
        _DECODE_TYPES[q.dtype], _stream(q),
    )
    _build.check(rc, what)
    return o, lse


def _simt_dq(what, q, k, v, do, lse, delta, causal, sm_scale, window):
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    fn = _build.function("flash_simt", "tgt_flash_bwd_dq_simt", _BWD_DQ_SIMT_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _DECODE_TYPES[q.dtype], _stream(q),
    )
    _build.check(rc, what)
    return dq


def _simt_dkv(what, q, k, v, do, lse, delta, causal, sm_scale, window):
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("flash_simt", "tgt_flash_bwd_dkv_simt", _BWD_DKV_SIMT_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _DECODE_TYPES[q.dtype], _stream(q),
    )
    _build.check(rc, what)
    return dk, dv


def _flash_fwd_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of float32 attention: ``csrc/flash_simt.cu`` on
    CUDA tensors, the plain version on CPU tensors."""
    if q.device.type in _PLAIN_DEVICES:
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_f32: unsupported device {q.device}")
    _check_f32("flash_fwd_f32", q, k, v)
    _check_f32_shapes("flash_fwd_f32", q, k, v)
    out = _simt_fwd("flash_fwd_f32", q, k, v, causal, sm_scale, window)
    _count(flash_attention_f32)
    return out


def flash_bwd_dq_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> torch.Tensor:
    """dQ of :func:`flash_attention_f32`, as :func:`flash_bwd_dq` for
    bfloat16: ``csrc/flash_simt.cu`` on CUDA tensors, the plain version
    on CPU tensors."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq_f32: unsupported device {q.device}")
    _check_f32("flash_bwd_dq_f32", q, k, v, do, lse, delta)
    _check_f32_shapes("flash_bwd_dq_f32", q, k, v, do)
    dq = _simt_dq("flash_bwd_dq_f32", q, k, v, do, lse, delta, causal, sm_scale,
                  window)
    _count(flash_bwd_dq_f32)
    return dq


flash_bwd_dq_f32.launches = 0


def flash_bwd_dkv_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of :func:`flash_attention_f32`, summed over each kv
    head's query heads, from the same inputs as :func:`flash_bwd_dq_f32`."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv_f32: unsupported device {q.device}")
    _check_f32("flash_bwd_dkv_f32", q, k, v, do, lse, delta)
    _check_f32_shapes("flash_bwd_dkv_f32", q, k, v, do)
    out = _simt_dkv("flash_bwd_dkv_f32", q, k, v, do, lse, delta, causal,
                    sm_scale, window)
    _count(flash_bwd_dkv_f32)
    return out


flash_bwd_dkv_f32.launches = 0


class _FlashAttentionF32(torch.autograd.Function):
    """:class:`_FlashAttention` for float32: forward and backward
    through ``csrc/flash_simt.cu``, or the plain version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _ckpt.flash_call(_flash_fwd_f32, q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        return _flash_backward(ctx, do, flash_bwd_dq_f32, flash_bwd_dkv_f32)


def flash_attention_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention` for float32 ``q``/``k``/``v`` at any head
    dim up to 128, on the CUDA cores.  Differentiable in ``q``, ``k``
    and ``v``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _FlashAttentionF32.apply(q, k, v, causal, sm_scale, window)


flash_attention_f32.launches = 0


def _flash_fwd_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` at a wide head dim (:func:`supports_wide`) on the kernel
    :func:`wide_kernel` names (``csrc/flash_fwd.cu`` at d=256 in bfloat16
    or float16, counted in ``flash_attention_wide.launches_d256``;
    ``csrc/flash_simt.cu`` otherwise, in ``launches``) for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type in _PLAIN_DEVICES:
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_wide: unsupported device {q.device}")
    _check_wide("flash_fwd_wide", q, k, v)
    if wide_kernel(q.shape, q.dtype) == "tc":
        _check_tma("flash_fwd_wide", q, k, v)
        out = _tc_fwd("flash_fwd_wide", q, k, v, causal, sm_scale, window)
        _count(flash_attention_wide, "launches_d256")
    else:
        out = _simt_fwd("flash_fwd_wide", q, k, v, causal, sm_scale, window)
        _count(flash_attention_wide)
    return out


def flash_bwd_dq_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> torch.Tensor:
    """dQ of :func:`flash_attention_wide` (its element type) on the kernel
    :func:`wide_kernel` names (``csrc/flash_bwd.cu`` at d=256 in bfloat16
    or float16, counted in ``launches_d256``; ``csrc/flash_simt.cu``
    otherwise, in ``launches``) for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq_wide: unsupported device {q.device}")
    _check_wide("flash_bwd_dq_wide", q, k, v, do, lse, delta)
    if wide_kernel(q.shape, q.dtype) == "tc":
        _check_tma("flash_bwd_dq_wide", q, k, v, do)
        dq = _tc_dq("flash_bwd_dq_wide", q, k, v, do, lse, delta, causal,
                    sm_scale, window)
        _count(flash_bwd_dq_wide, "launches_d256")
    else:
        dq = _simt_dq("flash_bwd_dq_wide", q, k, v, do, lse, delta, causal,
                      sm_scale, window)
        _count(flash_bwd_dq_wide)
    return dq


flash_bwd_dq_wide.launches = 0
flash_bwd_dq_wide.launches_d256 = 0


def flash_bwd_dkv_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of :func:`flash_attention_wide`, summed over each kv
    head's query heads, from the same inputs as :func:`flash_bwd_dq_wide`,
    on the kernel :func:`wide_kernel` names (``csrc/flash_bwd.cu`` at d=256
    in bfloat16 or float16, counted in ``launches_d256``;
    ``csrc/flash_simt.cu`` otherwise, in ``launches``)."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv_wide: unsupported device {q.device}")
    _check_wide("flash_bwd_dkv_wide", q, k, v, do, lse, delta)
    if wide_kernel(q.shape, q.dtype) == "tc":
        _check_tma("flash_bwd_dkv_wide", q, k, v, do)
        out = _tc_dkv("flash_bwd_dkv_wide", q, k, v, do, lse, delta, causal,
                      sm_scale, window)
        _count(flash_bwd_dkv_wide, "launches_d256")
    else:
        out = _simt_dkv("flash_bwd_dkv_wide", q, k, v, do, lse, delta, causal,
                        sm_scale, window)
        _count(flash_bwd_dkv_wide)
    return out


flash_bwd_dkv_wide.launches = 0
flash_bwd_dkv_wide.launches_d256 = 0


class _FlashAttentionWide(torch.autograd.Function):
    """:class:`_FlashAttention` at the wide head dims: forward, dQ
    and dK/dV through the kernels :func:`wide_kernel` names, or the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _ckpt.flash_call(_flash_fwd_wide, q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        return _flash_backward(ctx, do, flash_bwd_dq_wide, flash_bwd_dkv_wide)


def flash_attention_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention` at a head dim from 129 to 256 (Gemma's 256),
    or a multiple of 128 above 256 in bfloat16, float16 or float32: on the
    CUDA cores (above 512 the chunked kernels), except at d=256 in
    bfloat16 or float16 (the tensor cores for the forward, dQ and dK/dV,
    :func:`wide_kernel`).  Differentiable in ``q``, ``k`` and ``v``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _FlashAttentionWide.apply(q, k, v, causal, sm_scale, window)


flash_attention_wide.launches = 0
flash_attention_wide.launches_d256 = 0


def _decode_checks(what, gate, dims, q, ck, cv, quant, window, k_scale,
                   v_scale) -> None:
    """The refusals of a decode on the card behind :func:`flash_decode_simt`
    and :func:`flash_decode_wide` (``gate`` their shape test, ``dims`` what
    it takes, for the message)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    scales = (k_scale, v_scale) if quant else ()
    _check_cuda(what, q, ck, cv, *scales)
    if q.dtype not in _QUERY_TYPES or (not quant and ck.dtype != q.dtype):
        raise TypeError(
            f"{what} kernel takes a bfloat16, float16 or float32 q with a "
            f"cache of its type or an int8 cache, got {q.dtype}/{ck.dtype}/"
            f"{cv.dtype}"
        )
    if not gate(q.shape, ck.shape, window, ck.dtype) or cv.shape != ck.shape:
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, cache "
            f"{tuple(ck.shape)}: head dim must be {dims}"
        )


def _decode_simt_call(fn, what, gate, dims, q, ck, cv, pos0, window,
                      k_scale, v_scale) -> torch.Tensor:
    """The decode of ``csrc/flash_simt.cu`` behind :func:`flash_decode_simt`
    and :func:`flash_decode_wide` (``gate`` their shape test, ``dims`` what
    it takes, for the refusal); counts one launch on ``fn``."""
    quant, pos_dev, pos0 = _decode_args(q, ck, cv, pos0, window, k_scale, v_scale)
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    if q.device.type == "cpu":
        return flash_decode_reference(q, ck, cv, pos0, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    _decode_checks(what, gate, dims, q, ck, cv, quant, window, k_scale, v_scale)
    out = torch.empty((b, g, nh * hd), dtype=torch.float32, device=q.device)
    ks_p, vs_p = (_ptr(k_scale), _ptr(v_scale)) if quant else (None, None)
    call = _build.function("flash_simt", "tgt_flash_decode_simt", _DECODE_SIMT_ARGS)
    rc = call(
        _ptr(q), _ptr(ck), _ptr(cv), ks_p, vs_p, _ptr(out),
        None if pos_dev is None else _ptr(pos_dev),
        0 if pos_dev is not None else pos0, b, g, nh, nkv, hd, max_len,
        0 if window is None else int(window), float(hd ** -0.5),
        _DECODE_TYPES[q.dtype], _DECODE_TYPES[ck.dtype], _stream(q),
    )
    _build.check(rc, what)
    _count(fn)
    return out


def flash_decode_simt(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`flash_decode_attention` at any head dim up to 128 (the
    decode of ``csrc/flash_simt.cu``, on the CUDA cores): the same
    arguments, the same ``pos0`` forms, float32 ``[b, g, nh*hd]``."""
    return _decode_simt_call(
        flash_decode_simt, "flash_decode_simt", supports_decode_simt,
        f"at most {SIMT_HEAD_DIM_MAX}", q, ck, cv, pos0, window, k_scale, v_scale)


flash_decode_simt.launches = 0


def flash_decode_wide(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`flash_decode_simt` at head dims 129 to 256 and the multiples
    of 128 above 256: the same
    arguments and output, on the kernel :func:`wide_kernel` names for the
    cache (``decode=True``): at head dim 256 (Gemma's) with a bfloat16,
    float16 or int8 cache, ``csrc/flash_decode.cu``'s 256 tiles (counted
    in ``launches_d256``); else ``csrc/flash_simt.cu`` (``launches``)."""
    what, dims = ("flash_decode_wide",
                  f"from {SIMT_HEAD_DIM_MAX + 1} to 256 or a multiple of 128 above it")
    if q.device.type == "cpu" or wide_kernel(q.shape, ck.dtype, decode=True) == "simt":
        return _decode_simt_call(flash_decode_wide, what, supports_decode_wide, dims,
                                 q, ck, cv, pos0, window, k_scale, v_scale)
    quant, pos_dev, pos0 = _decode_args(q, ck, cv, pos0, window, k_scale, v_scale)
    _decode_checks(what, supports_decode_wide, dims, q, ck, cv, quant, window,
                   k_scale, v_scale)
    out = _tc_decode(what, q, ck, cv, quant, pos_dev, pos0, window, k_scale, v_scale)
    _count(flash_decode_wide, "launches_d256")
    return out


flash_decode_wide.launches = 0
flash_decode_wide.launches_d256 = 0


# --------------------------------------------------------------------- #
# the float32 forward on the tensor cores: csrc/flash_fwd_tf32.cu       #
# --------------------------------------------------------------------- #

# (query rows, keys) of a forward tile by template head dim (csrc/
# flash_fwd_tf32.cu Cfg): two consumer warpgroups at 64, one at 128.
TF32_TILES = {64: (128, 64), 128: (64, 32)}
TF32_KEY_PAD = 64    # V transposed is padded to a multiple of this many keys
# q, k, v, o, lse, split, plan, nblocks, b, s, sk, h, g, d, scale, causal,
# window, stream
_FWD_TF32_ARGS = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` of float32 ``x`` as the 3xTF32 kernel splits it:
    ``big`` is ``x`` with its low 13 mantissa bits cleared (a TF32 value,
    read exactly by the tensor cores), ``small = x - big`` (exact in
    float32).  ``A @ B`` is then formed as ``As Bb + Ab Bs + Ab Bb`` with
    each operand read as TF32 (``small`` truncated too)."""
    big = (x.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return big, x - big


def supports_tf32(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
) -> bool:
    """Whether ``csrc/flash_fwd_tf32.cu`` takes these shapes: float32, a
    head dim up to 128 that is a multiple of 4 (TMA's 16-byte rows), ``h``
    a multiple of ``g``."""
    b, s, h, d = q_shape
    g = k_shape[2]
    return (
        dtype == torch.float32 and 0 < d <= SIMT_HEAD_DIM_MAX and d % 4 == 0
        and g > 0 and h % g == 0 and k_shape[3] == d
    )


def _flash_fwd_tf32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of float32 attention: ``csrc/flash_fwd_tf32.cu`` on
    CUDA tensors, the plain version on CPU tensors.  ``lse`` is what
    :func:`_flash_fwd_f32` writes (natural log, ``[b*h, s]``), so the
    float32 backward kernels take it."""
    if q.device.type in _PLAIN_DEVICES:
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_tf32: unsupported device {q.device}")
    _check_f32("flash_fwd_tf32", q, k, v)
    _check_tma("flash_fwd_tf32", q, k, v)
    _check_tf32_shapes("flash_fwd_tf32", q, k, v)
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    skp = -(-sk // TF32_KEY_PAD) * TF32_KEY_PAD
    split = torch.empty(2 * k.numel() + 2 * b * g * d * skp, dtype=torch.float32,
                        device=q.device)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window,
                              tile=TF32_TILES[64 if d <= 64 else 128])
    fn = _build.function("flash_fwd_tf32", "tgt_flash_fwd_tf32", _FWD_TF32_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(split), _ptr(plan),
        nblocks, b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_fwd_tf32")
    _count(flash_attention_tf32)
    return o, lse


# By template head dim (csrc/flash_bwd_tf32.cu Dq, Dkv): (query rows, keys)
# of a dQ tile, and (keys, queries) of a dK/dV work item.
TF32_DQ_TILES = {64: (128, 32), 128: (64, 32)}
TF32_DKV_TILES = {64: (128, 32), 128: (64, 32)}
TF32_BWD_PAD = 32    # Qt, dOt and Kt are padded to a multiple of this many positions
# q, k, v, dout, split, b, s, sk, h, g, d, stream
_BWD_SPLIT_TF32_ARGS = [_P] * 5 + [_I] * 6 + [_P]
# split, lse, delta, dq, plan, nblocks, b, s, sk, h, g, d, scale, causal,
# window, stream
_BWD_DQ_TF32_ARGS = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# split, lse, delta, dk, dv, items, offsets, combos, partial, nblocks, b,
# s, sk, h, g, d, scale, causal, window, stream
_BWD_DKV_TF32_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]


def tf32_bwd_split_shapes(
    b: int, s: int, sk: int, h: int, g: int, d: int,
) -> Dict[str, Tuple[int, ...]]:
    """The parts of the float32 backward's prologue buffer, in order:
    the big and small parts (:func:`tf32_split`) of q, dO, k and v as
    stored, then of q, dO and k transposed to ``[b, heads, d, n]``
    (:func:`tf32_transpose`)."""
    pad = TF32_BWD_PAD
    rq, rk = (b, s, h, d), (b, sk, g, d)
    tq, tk = (b, h, d, -(-s // pad) * pad), (b, g, d, -(-sk // pad) * pad)
    return {"qb": rq, "qs": rq, "dob": rq, "dos": rq, "kb": rk, "ks": rk,
            "vb": rk, "vs": rk, "qtb": tq, "qts": tq, "dotb": tq, "dots": tq,
            "ktb": tk, "kts": tk}


def tf32_transpose(x: torch.Tensor) -> torch.Tensor:
    """``[b, n, heads, d]`` as the float32 backward's B operands take it:
    ``[b, heads, d, n']`` with the positions contiguous, zeros past ``n``
    up to a multiple of :data:`TF32_BWD_PAD`, and in each aligned group
    of 8 the positions 0 2 4 6 1 3 5 7 (the order in which an
    accumulator's columns fall into the next product's A fragment)."""
    n = x.shape[1]
    n_pad = -(-n // TF32_BWD_PAD) * TF32_BWD_PAD
    xt = F.pad(x, (0, 0, 0, 0, 0, n_pad - n)).permute(0, 2, 3, 1)
    j = torch.arange(n_pad, device=x.device) % 8
    order = torch.arange(n_pad, device=x.device) - j + torch.where(j < 4, 2 * j, 2 * j - 7)
    return xt[..., order].contiguous()


def _tf32_bwd_split_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
) -> torch.Tensor:
    """The plain version of :func:`tf32_bwd_split`: the parts of
    :func:`tf32_bwd_split_shapes` flattened into one float32 tensor."""
    parts = {}
    for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
        parts[name + "b"], parts[name + "s"] = tf32_split(x.float())
    for name, x in (("q", q), ("do", do), ("k", k)):
        parts[name + "tb"], parts[name + "ts"] = tf32_split(tf32_transpose(x.float()))
    shapes = tf32_bwd_split_shapes(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                                   q.shape[3])
    return torch.cat([parts[name].reshape(-1) for name in shapes])


def tf32_bwd_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
) -> torch.Tensor:
    """The float32 backward's prologue: one float32 buffer holding the
    parts of :func:`tf32_bwd_split_shapes`, which :func:`flash_bwd_dq_tf32`
    and :func:`flash_bwd_dkv_tf32` read.  ``tf32_bwd_split_kernel`` of
    ``csrc/flash_bwd_tf32.cu`` on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return _tf32_bwd_split_reference(q, k, v, do)
    if q.device.type != "cuda":
        raise ValueError(f"tf32_bwd_split: unsupported device {q.device}")
    _check_f32("tf32_bwd_split", q, k, v, do)
    _check_tf32_shapes("tf32_bwd_split", q, k, v, do)
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    numel = sum(math.prod(x) for x in tf32_bwd_split_shapes(b, s, sk, h, g, d).values())
    split = torch.empty(numel, dtype=torch.float32, device=q.device)
    fn = _build.function("flash_bwd_tf32", "tgt_flash_bwd_tf32_split", _BWD_SPLIT_TF32_ARGS)
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(split), b, s, sk, h, g, d,
            _stream(q))
    _build.check(rc, "tf32_bwd_split")
    _count(tf32_bwd_split)
    return split


tf32_bwd_split.launches = 0


def _check_tf32_shapes(what: str, q, k, v, do=None) -> None:
    if not supports_tf32(q.shape, k.shape, q.dtype) or v.shape != k.shape \
            or (do is not None and do.shape != q.shape):
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: head dim must be a "
            f"multiple of 4 up to {SIMT_HEAD_DIM_MAX} and h a multiple of g"
        )


def _check_tf32_bwd(what: str, q, k, v, do, lse, delta, split) -> None:
    """The float32 backward wrappers' checks, ``split`` included."""
    _check_f32(what, q, k, v, do, lse, delta)
    _check_tf32_shapes(what, q, k, v, do)
    b, s, h, d = q.shape
    if lse.shape != (b * h, s) or delta.shape != (b * h, s):
        raise ValueError(f"{what}: lse and delta must be float32 [b*h, s]")
    numel = sum(math.prod(x) for x in tf32_bwd_split_shapes(
        b, s, k.shape[1], h, k.shape[2], d).values())
    if split.dtype != torch.float32 or split.numel() != numel \
            or split.device != q.device or split.data_ptr() % 16:
        raise ValueError(f"{what}: split is not tf32_bwd_split's buffer for these shapes")


def flash_bwd_dq_tf32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int], split: torch.Tensor,
) -> torch.Tensor:
    """dQ of :func:`flash_attention_tf32`, as :func:`flash_bwd_dq` for
    bfloat16: ``csrc/flash_bwd_tf32.cu`` (3xTF32 wgmma) on CUDA tensors,
    reading :func:`tf32_bwd_split`'s buffer of the same q, k, v and ``do``
    (``split``); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq_tf32: unsupported device {q.device}")
    _check_tf32_bwd("flash_bwd_dq_tf32", q, k, v, do, lse, delta, split)
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window,
                              tile=TF32_DQ_TILES[64 if d <= 64 else 128])
    fn = _build.function("flash_bwd_tf32", "tgt_flash_bwd_dq_tf32", _BWD_DQ_TF32_ARGS)
    rc = fn(
        _ptr(split), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(plan), nblocks,
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dq_tf32")
    _count(flash_bwd_dq_tf32)
    return dq


flash_bwd_dq_tf32.launches = 0


def flash_bwd_dkv_tf32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
    window: Optional[int], split: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of :func:`flash_attention_tf32`, summed over each kv
    head's query heads, from the same inputs as
    :func:`flash_bwd_dq_tf32` (its kernel and ``flash_bwd_dkv_tf32_sum``:
    no atomics, bitwise equal run to run)."""
    if q.device.type == "cpu":
        return _reference_grads(
            q, k, v, do, lse, delta, causal, sm_scale, window
        )[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv_tf32: unsupported device {q.device}")
    _check_tf32_bwd("flash_bwd_dkv_tf32", q, k, v, do, lse, delta, split)
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dt = 64 if d <= 64 else 128
    plan, nblocks, slots, at_offsets, _ = _dkv_plan(
        q.device, b, s, sk, h, g, bool(causal), window, tile=TF32_DKV_TILES[dt])
    at_combos = at_offsets + nblocks + 1
    partial = torch.empty(max(slots, 1) * 2 * TF32_DKV_TILES[dt][0] * dt,
                          dtype=torch.float32, device=q.device)
    fn = _build.function("flash_bwd_tf32", "tgt_flash_bwd_dkv_tf32", _BWD_DKV_TF32_ARGS)
    rc = fn(
        _ptr(split), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), _ptr(plan),
        _ptr(plan[at_offsets:]), _ptr(plan[at_combos:]), _ptr(partial), nblocks,
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dkv_tf32")
    _count(flash_bwd_dkv_tf32)
    return dk, dv


flash_bwd_dkv_tf32.launches = 0


class _FlashAttentionTF32(torch.autograd.Function):
    """:class:`_FlashAttention` for float32 on the tensor cores:
    ``csrc/flash_fwd_tf32.cu``, then the prologue and ``csrc/
    flash_bwd_tf32.cu``'s dQ and dK/dV from its LSE; the plain version on
    the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _ckpt.flash_call(_flash_fwd_tf32, q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, window = ctx.args
        do = do.contiguous()
        delta = _delta(do, o)
        if q.device.type in _PLAIN_DEVICES:
            dq, dk, dv = _reference_grads(
                q, k, v, do, lse, delta, causal, sm_scale, window
            )
        else:
            kw = dict(causal=causal, sm_scale=sm_scale, window=window,
                      split=tf32_bwd_split(q, k, v, do))
            dq = flash_bwd_dq_tf32(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv_tf32(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_tf32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention` for float32 ``q``/``k``/``v`` at a head dim
    that is a multiple of 4 up to 128: the forward and the backward on the
    tensor cores at float32 accuracy (3xTF32).  Differentiable in ``q``,
    ``k`` and ``v``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _FlashAttentionTF32.apply(q, k, v, causal, sm_scale, window)


flash_attention_tf32.launches = 0


# --------------------------------------------------------------------- #
# routing: which kernel the callers run                                 #
# --------------------------------------------------------------------- #


class Route(NamedTuple):
    """:func:`attention_route`'s answer: ``kind`` is ``"kernel"`` (the
    tensor-core kernel as is; a decode at any head dim it maps), ``"pad"``
    (the head dim zero-padded to ``head_dim`` for the tensor-core kernel),
    ``"f32"`` (float32: the 3xTF32 forward of ``csrc/flash_fwd_tf32.cu``
    with the 3xTF32 backward of ``csrc/flash_bwd_tf32.cu``), ``"simt"`` (the CUDA-core
    kernels of ``csrc/flash_simt.cu``, for rows TMA cannot map),
    ``"wide"`` (head dims 129 to 256 and the multiples of 128 above 256:
    the same kernels, chunked above 512, or at d=256 the
    tensor-core kernels, :func:`wide_kernel`) or ``"none"``
    (no kernel takes it: the plain version on the CPU, refused on the
    card); ``head_dim`` is the dim the work runs at."""

    kind: str
    head_dim: int


@functools.lru_cache(maxsize=256)
def attention_route(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...], dtype: torch.dtype,
    *, window: Optional[int] = None, decode: bool = False,
    cache_dtype: Optional[torch.dtype] = None,
) -> Route:
    """Which kernel attention of these shapes runs on, where the
    reference's callers route around its kernels' limits.

    Forward and backward (the training block, the prefill): a
    :func:`supports` shape runs the tensor-core kernels (bfloat16 or
    float16); bfloat16 or float16 with a
    head dim below 128 that is not instantiated (d=32, Phi-2's 80) is
    zero-padded to the next instantiated dim, as the reference pads to
    128 lanes (exact: the zero columns add nothing to ``q·k`` and give
    zero output columns, sliced off); float32 up to d=128 runs the 3xTF32
    forward and backward (:func:`supports_tf32`: ``d % 4 == 0``) or, at
    other dims, the CUDA-core forward and backward.  Head dims from 129 to
    256, and every multiple of 128 above 256 (the reference's), run the
    CUDA-core kernels in bfloat16,
    float16 or float32 (``"wide"``), except at 256 (Gemma's) in bfloat16 or float16, which
    runs the tensor-core kernels (:func:`wide_kernel`).  Decode (``decode=True``, the cache in
    ``cache_dtype``): a :func:`supports_decode` shape (any head dim up to
    128 whose cache row is a multiple of 16 bytes) runs the tensor-core
    decode, any other head dim up to 128 the CUDA-core one, head dims 129
    to 256 and the multiples of 128 above it the wide one (the tensor-core
    decode's 256 tiles at 256 for a
    bfloat16, float16 or int8 cache).  A decode is never padded: that would copy the
    whole cache every token.  Anything else (another dtype, a head dim
    above 256 that is not a multiple of 128) has no kernel.  Answers are
    cached by shape: a decode step
    asks once a layer."""
    d = q_shape[-1]
    if decode:
        cdt = dtype if cache_dtype is None else cache_dtype
        if dtype not in _QUERY_TYPES or cdt not in (dtype, torch.int8):
            return Route("none", d)
        if supports_decode(q_shape, k_shape, window, cdt):
            return Route("kernel", d)
        if supports_decode_simt(q_shape, k_shape, window, cdt):
            return Route("simt", d)
        if supports_decode_wide(q_shape, k_shape, window, cdt):
            return Route("wide", d)
        return Route("none", d)
    if supports(q_shape, k_shape, dtype):
        return Route("kernel", d)
    if supports_tf32(q_shape, k_shape, dtype):
        return Route("f32", d)
    if supports_f32(q_shape, k_shape, dtype):
        return Route("simt", d)
    padded = next((D for D in FWD_HEAD_DIMS if D > d), None)
    if padded is not None and supports(
            (*q_shape[:-1], padded), (*k_shape[:-1], padded), dtype):
        return Route("pad", padded)
    if supports_wide(q_shape, k_shape, dtype):
        return Route("wide", d)
    return Route("none", d)


def _no_kernel(q: torch.Tensor, k_shape: Tuple[int, ...], what: str) -> None:
    """Refuse, on the card, attention that no kernel takes."""
    if q.device.type not in _PLAIN_DEVICES:
        raise ValueError(
            f"{what}: no CUDA kernel takes {q.dtype} q {tuple(q.shape)} with "
            f"k/cache {tuple(k_shape)} (bfloat16, float16 and float32 at head "
            "dims up to 256 and at every multiple of 128 above it are taken; "
            "another head dim above 256 none, as the reference's kernels)"
        )


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable attention as :func:`attention_route` routes it:
    :func:`flash_attention`, :func:`flash_attention` on ``q``/``k``/``v``
    zero-padded in the head dim (``sm_scale`` of the real dim) with the
    output sliced back, :func:`flash_attention_tf32`,
    :func:`flash_attention_f32` or :func:`flash_attention_wide`.  On the CPU each runs its plain version;
    on the card a shape no kernel takes raises.  The training block and
    the prefill call this."""
    d = q.shape[-1]
    route = attention_route(q.shape, k.shape, q.dtype, window=window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if route.kind == "none":
        _no_kernel(q, k.shape, "attention")
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    if route.kind == "f32":
        return flash_attention_tf32(q, k, v, causal=causal, window=window)
    if route.kind == "simt":
        return flash_attention_f32(q, k, v, causal=causal, window=window)
    if route.kind == "wide":
        return flash_attention_wide(q, k, v, causal=causal, window=window)
    if route.kind == "pad":
        pad = (0, route.head_dim - d)
        out = flash_attention(
            F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), causal=causal,
            sm_scale=d ** -0.5, window=window)
        return out[..., :d]
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention of ``g`` queries against a cache as
    :func:`attention_route` routes it (``decode=True``):
    :func:`flash_decode_attention` (any head dim it maps),
    :func:`flash_decode_simt` or :func:`flash_decode_wide` over the whole
    cache, never padded.  On the card a shape no kernel takes
    raises.  Float32 ``[b, g, nh*hd]``."""
    route = attention_route(q.shape, ck.shape, q.dtype, window=window,
                            decode=True, cache_dtype=ck.dtype)
    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale)
    if route.kind == "kernel":
        return flash_decode_attention(q, ck, cv, pos0, **kw)
    if route.kind == "simt":
        return flash_decode_simt(q, ck, cv, pos0, **kw)
    if route.kind == "wide":
        return flash_decode_wide(q, ck, cv, pos0, **kw)
    _no_kernel(q, ck.shape, "decode_attention")
    return flash_decode_reference(q, ck, cv, pos0, **kw)


def reset_launches() -> None:
    """Set every kernel launch count of this module to 0."""
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv,
               flash_decode_attention, flash_attention_tf32, flash_attention_f32,
               flash_bwd_dq_f32, flash_bwd_dkv_f32, flash_decode_simt,
               tf32_bwd_split, flash_bwd_dq_tf32, flash_bwd_dkv_tf32,
               flash_attention_wide, flash_bwd_dq_wide, flash_bwd_dkv_wide,
               flash_decode_wide):
        fn.launches = 0
    flash_decode_attention.launches_int8 = 0
    flash_attention_wide.launches_d256 = flash_bwd_dq_wide.launches_d256 = 0
    flash_bwd_dkv_wide.launches_d256 = flash_decode_wide.launches_d256 = 0
