"""Flash attention forward and KV-cache decode: CUDA kernels for Hopper.

Counterpart of ``torchgpipe_tpu/ops/flash_attention.py`` (forward and
decode only; the backward kernels come with the training slice).

* :func:`flash_attention` launches ``csrc/flash_fwd.cu``, which replaces
  both ``_fwd_kernel`` and ``_fwd_stream_kernel``: on the TPU the split
  exists because of VMEM size; on Hopper one K/V-tile loop serves every
  length.
* :func:`flash_decode_attention` launches ``csrc/flash_decode.cu``, which
  replaces ``_decode_kernel``.

Each wrapper launches its kernel for CUDA tensors and raises for what the
kernel does not take (device, dtype, contiguity, head dim).  It runs the
plain PyTorch version beside it (:func:`flash_attention_reference`,
:func:`flash_decode_reference`) only when its inputs lie on the CPU.
Each keeps a plain-integer count of kernel launches in its ``launches``
attribute; the plain version never touches it.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from torchgpipe_tpu_torch.ops import _build

_NEG = -1e30
FWD_HEAD_DIMS = (64, 128)
DECODE_HEAD_DIMS = (64, 128)
DECODE_MAX_ROWS = 16  # g * (nh // nkv) query rows per (batch, kv head)
DECODE_CHUNK = 64     # live keys per decode block (split-key grid)

# C signatures (csrc/*.cu): pointers and the stream as c_void_p.
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse, b, s, sk, h, g, d, scale, causal, window, stream
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
# q, ck, cv, out, scratch, pos0, b, g, nh, nkv, hd, max_len, window,
# chunk, nsplit, is_f32, stream
_DECODE_ARGS = [_P] * 5 + [_I] * 11 + [_P]


def _validate_window(causal: bool, window: Optional[int]) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    if window < 1:
        raise ValueError("window must be >= 1")


def _not_ported_quant() -> NotImplementedError:
    return NotImplementedError(
        "the int8 KV cache (k_scale/v_scale) variant of the decode kernel "
        "is not ported to torchgpipe_tpu_torch yet (ROADMAP.md, queue A "
        "item 3)"
    )


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


def flash_decode_reference(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of :func:`flash_decode_attention`: ``g``
    consecutive queries (positions ``pos0 .. pos0+g-1``) against the
    whole cache, masked to ``<= qpos`` (and the window band), float32.
    ``pos0`` is a scalar or ``[b]`` (one frontier per row, the serving
    pool's case).  Returns float32 ``[b, g, nh*hd]``."""
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
    """Whether ``csrc/flash_decode.cu`` takes these shapes: bfloat16 or
    float32 cache, head dim 64 or 128, ``nh`` a multiple of ``nkv``, at
    most :data:`DECODE_MAX_ROWS` query rows per kv head.  Any cache
    length."""
    b, g, nh, hd = q_shape
    nkv = k_shape[2]
    return (
        dtype in (torch.bfloat16, torch.float32)
        and hd in DECODE_HEAD_DIMS and k_shape[3] == hd
        and nkv > 0 and nh % nkv == 0
        and g * (nh // nkv) <= DECODE_MAX_ROWS
        and (window is None or window >= 1)
    )


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{what}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# --------------------------------------------------------------------- #
# forward                                                               #
# --------------------------------------------------------------------- #


def _flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    sm_scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the kernel on CUDA tensors, the plain version on
    CPU tensors.  ``lse`` is float32 ``[b*h, s]`` in scaled-score units,
    as the reference kernel's residual (kept for the training slice)."""
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda("flash_attention", q, k, v)
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
    fn = _build.function("flash_fwd", "tgt_flash_fwd_bf16", _FWD_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), b, s, sk, h, g, d,
        float(sm_scale), int(causal), 0 if window is None else int(window),
        _stream(q),
    )
    _build.check(rc, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention.  ``q: [b, s, h, d]``; ``k, v: [b, s_k, g, d]``
    with ``g`` dividing ``h`` (query head ``i`` reads kv head
    ``i // (h/g)``).  Returns ``[b, s, h, d]`` in ``q.dtype``.
    ``window`` (needs ``causal``): attend iff ``0 <= qpos - kpos <
    window``."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    return _flash_fwd(q, k, v, causal, sm_scale, window)[0]


flash_attention.launches = 0


# --------------------------------------------------------------------- #
# decode                                                                #
# --------------------------------------------------------------------- #


def flash_decode_attention(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any, *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``g`` consecutive rope'd queries ``q: [b, g, nh, hd]`` (positions
    ``pos0 .. pos0+g-1``) against the live prefix ``[0, pos0+g)`` of a
    ``[b, max_len, nkv, hd]`` cache.  ``pos0`` is a host ``int``
    (:func:`flash_decode_reference` also takes one per row).  Returns
    float32 ``[b, g, nh*hd]``."""
    if k_scale is not None or v_scale is not None:
        raise _not_ported_quant()
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    b, g, nh, hd = q.shape
    max_len, nkv = ck.shape[1], ck.shape[2]
    if nh % nkv != 0:
        raise ValueError(f"nh={nh} not divisible by nkv={nkv}")
    if isinstance(pos0, torch.Tensor):
        raise TypeError("flash_decode_attention takes pos0 as a host int")
    pos0 = int(pos0)
    if not 0 <= pos0 <= max_len - g:
        raise ValueError(f"pos0={pos0} + g={g} outside the cache ({max_len})")
    if q.device.type == "cpu":
        return flash_decode_reference(q, ck, cv, pos0, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    _check_cuda("flash_decode_attention", q, ck, cv)
    if q.dtype not in (torch.bfloat16, torch.float32) or ck.dtype != q.dtype \
            or cv.dtype != q.dtype:
        raise TypeError(
            f"flash_decode kernel takes bfloat16 or float32 q/cache of one "
            f"type, got {q.dtype}/{ck.dtype}/{cv.dtype}"
        )
    if not supports_decode(q.shape, ck.shape, window, q.dtype) \
            or cv.shape != ck.shape:
        raise ValueError(
            f"flash_decode kernel does not take q {tuple(q.shape)}, cache "
            f"{tuple(ck.shape)}: head dim must be one of {DECODE_HEAD_DIMS} "
            f"and g*nh/nkv <= {DECODE_MAX_ROWS}"
        )
    first = 0 if window is None else max(pos0 - window + 1, 0)
    nsplit = -(-(pos0 + g - first) // DECODE_CHUNK)
    rows = g * (nh // nkv)
    out = torch.empty((b, g, nh * hd), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        (b, nkv, nsplit, rows, 2 + hd), dtype=torch.float32, device=q.device
    )
    fn = _build.function("flash_decode", "tgt_flash_decode", _DECODE_ARGS)
    rc = fn(
        _ptr(q), _ptr(ck), _ptr(cv), _ptr(out), _ptr(scratch), pos0,
        b, g, nh, nkv, hd, max_len, 0 if window is None else int(window),
        DECODE_CHUNK, nsplit, int(q.dtype == torch.float32), _stream(q),
    )
    _build.check(rc, "flash_decode")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
