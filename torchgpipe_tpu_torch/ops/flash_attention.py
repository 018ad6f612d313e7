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
* :func:`flash_decode_attention` launches ``csrc/flash_decode.cu``, which
  replaces ``_decode_kernel``: a bf16 or float32 cache, or an int8 cache
  with float32 per-(position, kv head) scales (the ``quant=True``
  variant), dequantized in registers.

Each wrapper launches its kernel for CUDA tensors and raises for what the
kernel does not take (device, dtype, contiguity, head dim).  It runs the
plain PyTorch version beside it (:func:`flash_attention_reference`,
:func:`_reference_bwd`, :func:`flash_decode_reference`) only when its
inputs lie on the CPU.  Each keeps a plain-integer count of kernel
launches in its ``launches`` attribute; the decode wrapper keeps one
count per variant, ``launches`` for a bf16/float32 cache and
``launches_int8`` for an int8 cache, and adds one to exactly one of them
a launch.  The plain versions never touch them.  :func:`reset_launches`
sets every count to 0.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from torchgpipe_tpu_torch.ops import _build

_NEG = -1e30
FWD_HEAD_DIMS = (64, 128)
DECODE_HEAD_DIMS = (64, 128)
DECODE_CHUNK = 64     # live keys per decode block (split-key grid) ...
DECODE_BLOCKS = 1024  # ... grown in steps of 64 keys past this many blocks
# Element-type codes of csrc/flash_decode.cu.
_DECODE_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

# C signatures (csrc/*.cu): pointers and the stream as c_void_p.
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse, b, s, sk, h, g, d, scale, causal, window, stream
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dq, b, s, sk, h, g, d, scale, causal, window,
# stream
_BWD_DQ_ARGS = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
# q, k, v, dout, lse, delta, dk, dv, b, s, sk, h, g, d, scale, causal,
# window, stream
_BWD_DKV_ARGS = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
# q, ck, cv, k_scale, v_scale, out, scratch, pos0, b, g, nh, nkv, hd,
# max_len, window, chunk, nsplit, q_type, kv_type, stream
_DECODE_ARGS = [_P] * 7 + [_I] * 12 + [_P]


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
    as the reference kernel's residual."""
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


# --------------------------------------------------------------------- #
# backward                                                              #
# --------------------------------------------------------------------- #


def _check_bwd(what: str, q, k, v, do, lse, delta) -> None:
    _check_cuda(what, q, k, v, do, lse, delta)
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
    fn = _build.function("flash_bwd", "tgt_flash_bwd_dq_bf16", _BWD_DQ_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
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
    fn = _build.function("flash_bwd", "tgt_flash_bwd_dkv_bf16", _BWD_DKV_ARGS)
    rc = fn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), b, s, sk, h, g, d, float(sm_scale), int(causal),
        0 if window is None else int(window), _stream(q),
    )
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
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
        if q.device.type == "cpu":
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
    ``[b, max_len, nkv, hd]`` cache.  ``pos0`` is a host ``int``
    (:func:`flash_decode_reference` also takes one per row).  With
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
    if isinstance(pos0, torch.Tensor):
        raise TypeError("flash_decode_attention takes pos0 as a host int")
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
    first = 0 if window is None else max(pos0 - window + 1, 0)
    live = pos0 + g - first
    n64 = -(-live // DECODE_CHUNK)                      # 64-key chunks
    chunk = DECODE_CHUNK * -(-n64 // max(1, DECODE_BLOCKS // (b * nkv)))
    nsplit = -(-live // chunk)
    rows = g * (nh // nkv)
    out = torch.empty((b, g, nh * hd), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        (b, nkv, nsplit, rows, 2 + hd), dtype=torch.float32, device=q.device
    )
    ks_p, vs_p = (_ptr(k_scale), _ptr(v_scale)) if quant else (None, None)
    fn = _build.function("flash_decode", "tgt_flash_decode", _DECODE_ARGS)
    rc = fn(
        _ptr(q), _ptr(ck), _ptr(cv), ks_p, vs_p, _ptr(out), _ptr(scratch),
        pos0, b, g, nh, nkv, hd, max_len, 0 if window is None else int(window),
        chunk, nsplit,
        _DECODE_TYPES[q.dtype], _DECODE_TYPES[ck.dtype], _stream(q),
    )
    _build.check(rc, "flash_decode")
    if quant:
        flash_decode_attention.launches_int8 += 1
    else:
        flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_int8 = 0


def reset_launches() -> None:
    """Set every kernel launch count of this module to 0."""
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv,
               flash_decode_attention):
        fn.launches = 0
    flash_decode_attention.launches_int8 = 0
