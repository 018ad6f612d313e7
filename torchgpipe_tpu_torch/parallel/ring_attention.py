"""Ring attention: exact attention over sequence shards on a ring of ranks.

Counterpart of ``torchgpipe_tpu/parallel/ring_attention.py`` (Liu et al.,
"Ring Attention with Blockwise Transformers", arXiv:2310.01889).  The
sequence is sharded over an ``sp`` mesh axis: each rank holds ``[b,
s/sp, h, d]`` of Q and ``[b, s/sp, g, d]`` of K and V.  K/V blocks rotate
``sp - 1`` times around the ring (step 0 is the rank's own, diagonal
block), and each step's block is consumed in sub-blocks of at most
``kv_block_size`` keys.

Where the reference runs an online-softmax recurrence over dense score
tiles, the port runs each tile through the attention kernels: a tile's
forward returns its output and its log-sum-exp (LSE), and the tiles of a
query row merge exactly by LSE in float32 (``lse = logaddexp(lse_a,
lse_b)``, ``o = sum_j o_j exp(lse_j - lse)``).  The diagonal block is
causal, an earlier rank's block is attended whole, and a later rank's
block lies wholly after the queries (probabilities exactly 0 in the
reference) and is skipped.  The backward is exact per tile: the dQ and
dK/dV kernels take the merged LSE and ``delta = rowsum(dO * O)``, K/V
rotate again, and each block's dK/dV (float32) travel around the ring
with it until they reach the block's owner.

On the card each tile runs the kernels :func:`~torchgpipe_tpu_torch.ops.
flash_attention.attention_route` picks for its shape (``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` in bfloat16 and float16; a shape no
kernel takes raises); on the CPU the same orchestration calls the plain
per-tile versions (``_reference_fwd``, ``_reference_grads``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from torchgpipe_tpu_torch import checkpoint as _ckpt
from torchgpipe_tpu_torch.ops import flash_attention as _fa
from torchgpipe_tpu_torch.parallel.axes import BoundAxis, axis_bound, require_axis

__all__ = ["attention", "axis_bound", "full_attention", "partition_rules",
           "ring_attention"]

_NEG = -1e30   # the reference's mask value: keeps a row with no key finite


def partition_rules(sp_axis: str, pp_axis: str = "pp") -> Any:
    """The ring's param layout as a rule table of the analysis layer
    (ROADMAP.md queue A item 5.6); the ring shards activations, never
    parameters."""
    from torchgpipe_tpu_torch.models.transformer import not_ported

    raise not_ported("parallel.ring_attention.partition_rules "
                     "(analysis.partition_rules)", "5.6")


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None, seg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain dense attention, the reference's oracle: ``q [b, s, h, d]``,
    ``k, v [b, s, g, d]`` (``g`` divides ``h``; query head ``i`` reads kv
    head ``i // (h/g)``), causal optionally banded to ``window``, ``seg``
    (``[b, s]`` segment ids) keeping each position to its own segment.
    Scores and softmax in float32, masked with -1e30 (a row with no key
    softens to uniform and stays finite); returns ``q.dtype``."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    sm_scale = d ** -0.5 if sm_scale is None else sm_scale
    _fa._validate_window(causal, window)
    qg = q.reshape(b, sq, g, h // g, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * sm_scale
    mask = None
    if causal:
        diff = torch.arange(sq, device=q.device)[:, None] - \
            torch.arange(sk, device=q.device)[None, :]
        mask = diff >= 0
        if window is not None:
            mask = mask & (diff < window)
        mask = mask[None]
    if seg is not None:
        sm = seg[:, :, None] == seg[:, None, :]
        mask = sm if mask is None else mask & sm
    if mask is not None:
        s = torch.where(mask[:, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------- #
# one tile: the kernels of its route                                    #
# --------------------------------------------------------------------- #

TileFwd = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def tile_fns(q: torch.Tensor, k: torch.Tensor) -> Tuple[TileFwd, Callable]:
    """``(fwd, bwd)`` of the tiles of these operands: ``fwd(q, k, v,
    causal, scale) -> (o, lse)``, ``bwd(q, k, v, do, lse, delta, causal,
    scale) -> (dq, dk, dv)``, through the kernels of
    :func:`~torchgpipe_tpu_torch.ops.flash_attention.attention_route` on the
    card and the plain versions on the CPU."""
    if q.device.type in _fa._PLAIN_DEVICES:
        def plain_bwd(q, k, v, do, lse, delta, causal, scale):
            return _fa._reference_grads(q, k, v, do, lse, delta, causal, scale, None)

        return (lambda q, k, v, causal, scale:
                _fa._reference_fwd(q, k, v, causal, scale, None)), plain_bwd
    route = _fa.attention_route(tuple(q.shape), tuple(k.shape), q.dtype)
    if route.kind == "none":
        _fa._no_kernel(q, tuple(k.shape), "ring_attention")
    fwd_of = {"kernel": _fa._flash_fwd, "pad": _fa._flash_fwd,
              "f32": _fa._flash_fwd_tf32, "simt": _fa._flash_fwd_f32,
              "wide": _fa._flash_fwd_wide}[route.kind]
    dq_of, dkv_of = {
        "kernel": (_fa.flash_bwd_dq, _fa.flash_bwd_dkv),
        "pad": (_fa.flash_bwd_dq, _fa.flash_bwd_dkv),
        "f32": (_fa.flash_bwd_dq_tf32, _fa.flash_bwd_dkv_tf32),
        "simt": (_fa.flash_bwd_dq_f32, _fa.flash_bwd_dkv_f32),
        "wide": (_fa.flash_bwd_dq_wide, _fa.flash_bwd_dkv_wide),
    }[route.kind]
    d = q.shape[-1]
    pad = (0, route.head_dim - d) if route.kind == "pad" else None

    def fwd(q, k, v, causal, scale):
        if pad:
            o, lse = fwd_of(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), causal,
                            scale, None)
            return o[..., :d], lse
        return fwd_of(q, k, v, causal, scale, None)

    def bwd(q, k, v, do, lse, delta, causal, scale):
        if pad:
            q, k, v, do = (F.pad(t, pad) for t in (q, k, v, do))
        kw = dict(causal=causal, sm_scale=scale, window=None)
        if route.kind == "f32":
            kw["split"] = _fa.tf32_bwd_split(q, k, v, do)
        dq = dq_of(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_of(q, k, v, do, lse, delta, **kw)
        if pad:
            return dq[..., :d], dk[..., :d], dv[..., :d]
        return dq, dk, dv

    return fwd, bwd


def _n_sub(s: int, kv_block_size: int) -> int:
    """The reference's split of a shard into sub-blocks: the smallest
    count with sub-blocks of at most ``kv_block_size`` that divides ``s``."""
    n = 1
    if s > kv_block_size:
        n = -(-s // kv_block_size)
        while s % n != 0:
            n += 1
    return n


def ring_tiles(rank: int, src: int, s: int, n_sub: int, causal: bool
               ) -> List[Tuple[int, int, int, int, bool]]:
    """The tiles of the K/V block that originated on ring position ``src``,
    seen by ``rank``'s queries: ``(q0, q1, k0, k1, causal)`` ranges of the
    local shard of ``s`` positions, the keys in ``n_sub`` sub-blocks.  A
    later rank's block under ``causal`` has none; the diagonal block's
    sub-block ``j`` is a causal tile on its own queries and a whole tile
    on the queries after them; any other block is whole."""
    if causal and src > rank:
        return []
    sub = s // n_sub
    out = []
    for j in range(n_sub):
        k0, k1 = j * sub, (j + 1) * sub
        if causal and src == rank:
            out.append((k0, k1, k0, k1, True))
            if k1 < s:
                out.append((k1, s, k0, k1, False))
        else:
            out.append((0, s, k0, k1, False))
    return out


def _lse_rows(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[b*h, s]`` to ``[b, s, h, 1]``, to scale ``[b, s, h, d]`` rows."""
    return lse.reshape(b, h, -1).permute(0, 2, 1)[..., None]


def merge_block(o: torch.Tensor, lse: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, tiles: List[Tuple[int, int, int, int, bool]],
                fwd: TileFwd, scale: float) -> None:
    """Merge one K/V block's ``tiles`` (:func:`ring_tiles`) into the
    float32 accumulators ``o [b, s, h, d]`` and ``lse [b*h, s]`` (the
    latter -inf where nothing merged yet), in place: per query row
    ``lse = logaddexp(lse, lse_t)``, ``o = o exp(lse_old - lse) + o_t
    exp(lse_t - lse)``."""
    b, _, h, _ = q.shape
    for q0, q1, k0, k1, c in tiles:
        o_t, lse_t = fwd(q[:, q0:q1].contiguous(), k[:, k0:k1].contiguous(),
                         v[:, k0:k1].contiguous(), c, scale)
        old = lse[:, q0:q1]
        new = torch.logaddexp(old, lse_t)
        o[:, q0:q1] = (o[:, q0:q1] * torch.exp(_lse_rows(old - new, b, h))
                       + o_t.float() * torch.exp(_lse_rows(lse_t - new, b, h)))
        lse[:, q0:q1] = new


def block_grads(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                delta: torch.Tensor, tiles: List[Tuple[int, int, int, int, bool]],
                bwd: Callable, scale: float) -> None:
    """Add one K/V block's ``tiles``' gradients to the float32 ``dq`` (the
    queries') and ``dk``/``dv`` (the block's), in place: each tile's dQ
    and dK/dV kernels read the merged ``lse`` and ``delta = rowsum(dO *
    O)``, so its probabilities are the whole row's."""
    for q0, q1, k0, k1, c in tiles:
        dq_t, dk_t, dv_t = bwd(
            q[:, q0:q1].contiguous(), k[:, k0:k1].contiguous(), v[:, k0:k1].contiguous(),
            do[:, q0:q1].contiguous(), lse[:, q0:q1].contiguous(),
            delta[:, q0:q1].contiguous(), c, scale)
        dq[:, q0:q1] += dq_t.float()
        dk[:, k0:k1] += dk_t.float()
        dv[:, k0:k1] += dv_t.float()


def _ring_fwd(q, k, v, ax: BoundAxis, causal: bool, scale: float, n_sub: int):
    """``(out, lse)`` of the whole ring: each block's tiles through the
    flash forward kernels, merged by LSE."""
    b, s, h, d = q.shape
    fwd, _ = tile_fns(q, k)
    o = torch.zeros(b, s, h, v.shape[-1], dtype=torch.float32, device=q.device)
    lse = torch.full((b * h, s), float("-inf"), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for t in range(ax.size):
        src = (ax.index - t) % ax.size
        merge_block(o, lse, q, kv[0], kv[1],
                    ring_tiles(ax.index, src, s, n_sub, causal), fwd, scale)
        if t < ax.size - 1:
            kv = ax.shift(kv)
    return o.to(q.dtype), lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ax: BoundAxis, causal: bool, scale: float, n_sub: int):
        out, lse = _ckpt.flash_call(_ring_fwd, q, k, v, ax, causal, scale, n_sub)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ax, causal, scale, n_sub)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ax, causal, scale, n_sub = ctx.args
        _, bwd = tile_fns(q, k)
        s = q.shape[1]
        do = do.contiguous()
        delta = _fa._delta(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for t in range(ax.size):
            src = (ax.index - t) % ax.size
            block_grads(dq, dkv[0], dkv[1], q, kv[0], kv[1], do, lse, delta,
                        ring_tiles(ax.index, src, s, n_sub, causal), bwd, scale)
            if t < ax.size - 1:
                kv = ax.shift(kv)
            # The block's dK/dV go on with it; after the last step they
            # reach the block's owner.
            dkv = ax.shift(dkv)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    kv_block_size: int = 2048,
) -> torch.Tensor:
    """Exact attention over sequence shards on the ``axis_name`` ring (a
    bound axis): ``q [b, s_local, h, d]``, ``k, v [b, s_local, g, d]``, the
    local shards of equal size; returns the local output shard in
    ``q.dtype``.  Differentiable in ``q``, ``k`` and ``v``."""
    ax = require_axis(axis_name)
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    n_sub = _n_sub(q.shape[1], kv_block_size)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _RingAttention.apply(q, k, v, ax, bool(causal), float(sm_scale), n_sub)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    axis_name: Optional[str] = None, causal: bool = True,
    sm_scale: Optional[float] = None, kv_block_size: int = 2048,
    impl: str = "ring", window: Optional[int] = None,
    seg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel attention when ``axis_name`` is bound
    (``impl='ring'``, or ``'ulysses'``: :mod:`.ulysses`); otherwise the
    port's kernels through
    :func:`~torchgpipe_tpu_torch.ops.flash_attention.attention` (the plain
    version on the CPU).  ``seg`` (segment-packed batches) takes the dense
    :func:`full_attention` and does not compose with a bound axis, as in
    the reference."""
    if impl not in ("ring", "ulysses"):
        raise ValueError("attention impl must be 'ring' or 'ulysses'")
    _fa._validate_window(causal, window)
    if seg is not None:
        if axis_bound(axis_name) is not None:
            raise ValueError(
                "segment-packed attention does not compose with a bound "
                "sequence-parallel axis (ring/ulysses shards would need "
                "cross-shard segment routing); drop sp_axis for packed "
                "training"
            )
        return full_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                              window=window, seg=seg)
    if axis_bound(axis_name) is None:
        if sm_scale is not None and sm_scale != q.shape[-1] ** -0.5:
            return _fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                       window=window)
        return _fa.attention(q, k, v, causal=causal, window=window)
    if impl == "ulysses":
        from torchgpipe_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, axis_name, causal=causal, sm_scale=sm_scale,
                                 window=window)
    if window is not None:
        raise ValueError(
            "sliding-window attention does not compose with the ring sp "
            "path yet (the ring would need per-step band skipping); use "
            "sp_impl='ulysses' — its local full-sequence attention "
            "windows exactly — or drop the sp axis"
        )
    return ring_attention(q, k, v, axis_name, causal=causal, sm_scale=sm_scale,
                          kv_block_size=kv_block_size)
