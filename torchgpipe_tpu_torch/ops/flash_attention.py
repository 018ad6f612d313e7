"""Flash attention forward, backward and KV-cache decode: CUDA kernels
for Hopper.

Counterpart of ``torchgpipe_tpu/ops/flash_attention.py``.  On the TPU
each pass exists twice (K/V resident in VMEM, or streamed on a grid
axis) because of VMEM size; on Hopper one tile loop serves every length.

* :func:`flash_attention` launches ``csrc/flash_fwd.cu`` (replaces
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
  replaces ``_decode_kernel``: a bf16 or float32 cache, or an int8 cache
  with float32 per-(position, kv head) scales (the ``quant=True``
  variant), dequantized in registers.  ``pos0`` may be a device int32
  scalar: the kernel derives its split of the live keys on the device
  (:func:`decode_split` mirrors it), and its grid depends only on the
  cache's size.

Each wrapper launches its kernel for CUDA tensors and raises for what the
kernel does not take (device, dtype, contiguity, head dim).  It runs the
plain PyTorch version beside it (:func:`flash_attention_reference`,
:func:`_reference_bwd`, :func:`flash_decode_reference`) only when its
inputs lie on the CPU, or on the meta device, where nothing runs and
``balance.layer_flops`` counts the FLOPs of shapes.  Each keeps a plain-integer count of kernel
launches in its ``launches`` attribute; the decode wrapper keeps one
count per variant, ``launches`` for a bf16/float32 cache and
``launches_int8`` for an int8 cache, and adds one to exactly one of them
a launch.  A launch recorded into a CUDA graph capture is not counted
(its replays launch the kernel without the wrapper; ``chip_smoke.py``
counts those from a profile).  The plain versions never touch them.  :func:`reset_launches`
sets every count to 0.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from torchgpipe_tpu_torch.ops import _build

_NEG = -1e30
# Devices whose tensors take the plain versions: the CPU, and meta
# (shapes only: FLOP counting).
_PLAIN_DEVICES = ("cpu", "meta")
FWD_HEAD_DIMS = (64, 128)
DECODE_HEAD_DIMS = (64, 128)
DECODE_KEYS = 64      # keys per decode tile (csrc/flash_decode.cu KT)
DECODE_ROWS = 32      # query rows a decode block holds (MAX_ROWS)
# Decode blocks per SM that the split aims at: one for a bf16/f32 cache
# (bytes set the pace; on an H100 two per SM read ~5% slower at a
# 32704-key cache), two for an int8 cache (its per-tile work sets the
# pace).  Measurements in PERF.md.
DECODE_WAVE = {False: 1, True: 2}
# Element-type codes of csrc/flash_decode.cu.
_DECODE_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

# C signatures (csrc/*.cu): pointers and the stream as c_void_p.
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse, tiles, nblocks, b, s, sk, h, g, d, scale, causal,
# window, stream
_FWD_ARGS = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dq, plan, nblocks, b, s, sk, h, g, d, scale,
# causal, window, stream
_BWD_DQ_ARGS = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dk, dv, items, offsets, combos, partial,
# nblocks, b, s, sk, h, g, d, scale, causal, window, stream
_BWD_DKV_ARGS = [_P] * 12 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
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
    """Whether ``csrc/flash_fwd.cu`` takes these shapes: bfloat16, head
    dim 64 or 128, ``h`` a multiple of ``g``.  Any sequence length (the
    ragged last tile is masked)."""
    b, s, h, d = q_shape
    g = k_shape[2]
    return (
        dtype == torch.bfloat16 and d in FWD_HEAD_DIMS and g > 0 and h % g == 0
        and k_shape[3] == d
    )


def supports_decode(
    q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
    window: Optional[int], dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Whether ``csrc/flash_decode.cu`` takes these shapes: a bfloat16,
    float32 or int8 cache (``dtype``), head dim 64 or 128, ``nh`` a
    multiple of ``nkv``.  Any cache length and any number of query rows
    (a block holds at most ``1024 / hd`` of a kv head's ``g * nh / nkv``
    rows; more rows take more blocks)."""
    b, g, nh, hd = q_shape
    nkv = k_shape[2]
    return (
        dtype in _DECODE_TYPES
        and hd in DECODE_HEAD_DIMS and k_shape[3] == hd
        and nkv > 0 and nh % nkv == 0
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
FWD_KEYS = 128     # keys per K/V tile (BK)
DQ_ROWS = 128      # query rows per dQ tile (csrc/flash_bwd.cu DQ_BQ)
DQ_KEYS = 64       # keys per dQ K/V tile (DQ_BK)


def _fwd_live_tiles(q0: int, s: int, sk: int, causal: bool,
                    window: Optional[int], rows: int = FWD_ROWS,
                    keys: int = FWD_KEYS) -> int:
    """Key tiles the query tile of ``rows`` rows from ``q0`` reads (the
    kernels' ``Tile``/``DqTile``): up to the diagonal, from the window's
    first."""
    nkt = -(-sk // keys)
    first = 0
    if causal:
        nkt = min(nkt, (min(q0 + rows, s) - 1) // keys + 1)
        if window is not None:
            first = max(q0 - (window - 1), 0) // keys
    return max(nkt - first, 0)


def fwd_schedule(
    b: int, s: int, sk: int, h: int, causal: bool, window: Optional[int],
    n_sms: int, rows: int = FWD_ROWS, keys: int = FWD_KEYS,
) -> Tuple[List[int], List[int]]:
    """``(offsets, tiles)`` of a persistent kernel over query tiles of
    ``rows`` rows and K/V tiles of ``keys`` keys (the forward's 128/128 by
    default; ``flash_bwd_dq`` takes :data:`DQ_ROWS`/:data:`DQ_KEYS`):
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
    cost = [_fwd_live_tiles((nqt - 1 - t // bhn) * rows, s, sk, causal,
                            window, rows, keys) + 1 for t in range(n)]
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


DKV_KEYS = 128     # keys per work item (csrc/flash_bwd.cu KV_BK)
DKV_QUERIES = 64   # queries per Q/dO tile (KV_BQ)


class DkvSchedule(NamedTuple):
    """How ``csrc/flash_bwd.cu``'s persistent dK/dV kernel splits one
    call.  A *combo* is one (batch, kv head, 128-key tile); its work is
    a loop over (query head of the group, live 64-query tile), ``r *
    ntile`` iterations.  ``items`` are contiguous ranges of those loops:
    ``(bi, kvh, kt, jq0, ntile, it0, it1, slot)``, iteration ``t`` being
    query head ``kvh * r + t // ntile`` and query tile ``jq0 + t %
    ntile``; ``slot`` is the item's f32 scratch slot, or -1 when the
    item holds its combo's whole loop and writes bf16 itself.  Block
    ``i`` runs ``items[offsets[i]:offsets[i+1]]``.  ``combos[c] =
    (first_slot, count)`` for combo ``c = (bi * g + kvh) * nkt + kt``:
    count -1 = written by its item, 0 = no query attends it (zeros)."""

    items: List[Tuple[int, ...]]
    offsets: List[int]
    combos: List[Tuple[int, int]]
    slots: int


def _dkv_live_tiles(kt: int, s: int, sk: int, causal: bool,
                    window: Optional[int]) -> Tuple[int, int]:
    """``(first, count)`` of the 64-query tiles that attend some key of
    128-key tile ``kt``: from the diagonal to the window's last query."""
    nq = -(-s // DKV_QUERIES)
    if not causal:
        return 0, nq
    k0 = kt * DKV_KEYS
    first, end = k0 // DKV_QUERIES, nq
    if window is not None:
        last_key = min(k0 + DKV_KEYS, sk) - 1
        end = min((last_key + window - 1) // DKV_QUERIES + 1, nq)
    return first, max(end - first, 0)


def dkv_schedule(
    b: int, s: int, sk: int, h: int, g: int, causal: bool,
    window: Optional[int], n_sms: int,
) -> DkvSchedule:
    """The balanced causal schedule of ``flash_bwd_dkv``: combos sorted
    longest first fill the SMs in turn, each SM up to ``ceil(total /
    n_sms)`` iterations, a combo cut where an SM fills (McNaughton's
    wrap-around rule), so no SM holds more than the mean work plus one
    iteration, and at most ``n_sms - 1`` combos are cut.  Pure and
    deterministic: the kernel's sums depend on the slots, not on which
    SM runs an item."""
    r = h // g
    nkt = -(-sk // DKV_KEYS)
    combos = []   # (work, combo index, bi, kvh, kt, jq0, ntile)
    for bi in range(b):
        for kvh in range(g):
            for kt in range(nkt):
                jq0, ntile = _dkv_live_tiles(kt, s, sk, causal, window)
                c = (bi * g + kvh) * nkt + kt
                combos.append((r * ntile, c, bi, kvh, kt, jq0, ntile))
    total = sum(c[0] for c in combos)
    table = [(0, 0)] * len(combos)
    if total == 0:
        return DkvSchedule([], [0], table, 0)
    per = -(-total // min(n_sms, total))
    bins: List[List[list]] = [[]]
    fill = 0
    pieces: Dict[int, List[list]] = {}
    for work, c, bi, kvh, kt, jq0, ntile in sorted(
            (x for x in combos if x[0]), key=lambda x: (-x[0], x[1])):
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
    slots = 0
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
def _dkv_plan(device: torch.device, *key) -> Tuple[torch.Tensor, int, int, int]:
    """:func:`dkv_schedule` of ``key = (b, s, sk, h, g, causal, window)``
    on ``device``'s SMs as one int32 device tensor (items, then offsets,
    then combos) with its block count, slot count and where the offsets
    start."""
    sch = dkv_schedule(*key, _sm_count(device))
    flat = [v for it in sch.items for v in it] + sch.offsets + [
        v for c in sch.combos for v in c]
    return (torch.tensor(flat, dtype=torch.int32, device=device),
            len(sch.offsets) - 1, sch.slots, 8 * len(sch.items))


def decode_groups(rows: int) -> Tuple[int, int]:
    """``(ngroups, group_rows)``: a kv head's ``rows = g * nh / nkv``
    query rows cut into equal groups of at most :data:`DECODE_ROWS`, one
    decode block each (``csrc/flash_decode.cu``'s entry)."""
    ngroups = -(-rows // DECODE_ROWS)
    return ngroups, -(-rows // ngroups)


def decode_want(b: int, nkv: int, ngroups: int, n_sms: int, quant: bool) -> int:
    """The most chunks a (batch row, kv head, row group) is cut into:
    :data:`DECODE_WAVE` blocks per SM (``quant``: an int8 cache) over the
    ``b * nkv * ngroups`` block rows, at least 1."""
    return max(1, DECODE_WAVE[quant] * n_sms // (b * nkv * ngroups))


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
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_fwd kernel takes bfloat16 q/k/v, got {q.dtype}/"
            f"{k.dtype}/{v.dtype}"
        )
    if not supports(q.shape, k.shape, q.dtype) or v.shape != k.shape:
        raise ValueError(
            f"flash_fwd kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: head dim must be one "
            f"of {FWD_HEAD_DIMS} and h a multiple of g"
        )
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window)
    fn = _build.function("flash_fwd", "tgt_flash_fwd_bf16", _FWD_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(plan), nblocks,
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_fwd")
    _count(flash_attention)
    return o, lse


# --------------------------------------------------------------------- #
# backward                                                              #
# --------------------------------------------------------------------- #


def _check_bwd(what: str, q, k, v, do, lse, delta) -> None:
    _check_cuda(what, q, k, v, do, lse, delta)
    _check_tma(what, q, k, v, do)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, do)):
        raise TypeError(
            f"{what} kernel takes bfloat16 q/k/v/do, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}/{do.dtype}"
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
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    plan, nblocks = _fwd_plan(q.device, b, s, sk, h, bool(causal), window,
                              tile=(DQ_ROWS, DQ_KEYS))
    fn = _build.function("flash_bwd", "tgt_flash_bwd_dq_bf16", _BWD_DQ_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        _ptr(plan), nblocks, b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dq")
    _count(flash_bwd_dq)
    return dq


flash_bwd_dq.launches = 0


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
    b, s, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan, nblocks, slots, at_offsets = _dkv_plan(
        q.device, b, s, sk, h, g, bool(causal), window)
    at_combos = at_offsets + nblocks + 1
    partial = torch.empty(max(slots, 1) * 256 * d, dtype=torch.float32,
                          device=q.device)
    fn = _build.function("flash_bwd", "tgt_flash_bwd_dkv_bf16", _BWD_DKV_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), _ptr(plan), _ptr(plan[at_offsets:]), _ptr(plan[at_combos:]),
        _ptr(partial), nblocks, b, s, sk, h, g, d, float(sm_scale),
        int(causal), 0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dkv")
    _count(flash_bwd_dkv)
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_fwd`` saving ``(q, k, v, o, lse)``;
    backward through the two backward kernels, or, for CPU tensors, one
    call of the plain version.  Counterpart of the reference's ``_flash``
    custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale, window)
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
            kw = dict(causal=causal, sm_scale=sm_scale, window=window)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


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
    if q.device.type == "cpu":
        return flash_decode_reference(q, ck, cv, pos0, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    scales = (k_scale, v_scale) if quant else ()
    _check_cuda("flash_decode_attention", q, ck, cv, *scales)
    if q.dtype not in (torch.bfloat16, torch.float32) or (
        not quant and ck.dtype != q.dtype
    ):
        raise TypeError(
            f"flash_decode kernel takes a bfloat16 or float32 q with a cache "
            f"of its type or an int8 cache, got {q.dtype}/{ck.dtype}/{cv.dtype}"
        )
    if not supports_decode(q.shape, ck.shape, window, ck.dtype) \
            or cv.shape != ck.shape:
        raise ValueError(
            f"flash_decode kernel does not take q {tuple(q.shape)}, cache "
            f"{tuple(ck.shape)}: head dim must be one of {DECODE_HEAD_DIMS}"
        )
    _check_tma("flash_decode_attention", ck, cv)
    rows = g * (nh // nkv)
    ngroups, _ = decode_groups(rows)
    want = decode_want(b, nkv, ngroups, _sm_count(q.device), quant)
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
    _build.check(rc, "flash_decode")
    if quant:
        _count(flash_decode_attention, "launches_int8")
    else:
        _count(flash_decode_attention)
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_int8 = 0


def reset_launches() -> None:
    """Set every kernel launch count of this module to 0."""
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv,
               flash_decode_attention):
        fn.launches = 0
    flash_decode_attention.launches_int8 = 0
