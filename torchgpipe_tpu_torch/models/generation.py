"""KV-cache autoregressive generation for the Llama family.

Counterpart of ``torchgpipe_tpu/models/generation.py``: ``prefill``,
``generate`` (full or ring caches, bf16/f32 or int8 storage, multi-turn
continuation with ``cache=``, per-row frontiers with ``row_lengths=``,
``early_exit``), ``decode_slots``, ``row_frontiers``, ``beam_search`` and
``speculative_generate``.  Prefill runs one batched pass over the prompt
with ``ops.flash_attention.flash_attention`` (the ``flash_fwd`` CUDA
kernel on the card) and banks every block's K/V; each decode step runs
its tokens through the blocks, reading the live cache prefix with
``flash_decode_attention`` (the ``flash_decode`` kernel, whose int8
variant reads a :class:`QuantKVCache` as int8 bytes).  Ring caches and
per-row frontiers read the cache with the dense masked softmax, as the
reference does (it has no kernel there either).

Differences from the reference, all forced by PyTorch running eagerly:

* Caches are updated IN PLACE (the columns a step writes) instead of
  returned as new immutable buffers, and ``length`` is a host ``int``:
  the callers know every shared position on the host, so no step waits
  on the device for one.
* The reference's ``lax.scan``/``while_loop`` over decode steps are
  Python loops with the same bodies.  Where the reference's loop
  condition reads device values (``early_exit``'s "every row finished",
  speculative decoding's accepted count), the port reads them to the
  host once per step or round; each entry point says so.
* Randomness comes from an explicit ``torch.Generator``; a JAX key and a
  generator give different streams from one seed, so sampled (non
  greedy) outputs are not comparable across the two packages, only
  their distributions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from torchgpipe_tpu_torch.models.transformer import (  # noqa: F401 (re-exported)
    Device,
    TransformerConfig,
    _block_attn_out,
    _block_norm,
    _block_qkv,
    _embed,
    _mlp_out,
    not_ported,
    resolve_device,
)
from torchgpipe_tpu_torch.ops.flash_attention import (
    dequant_rows as _dequant_rows,
    flash_attention,
    flash_attention_reference,
    flash_decode_attention,
    flash_decode_reference,
)

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V buffers ``[b, max_len, kv_heads, head_dim]`` and the
    number of positions already written (a host int)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: int


@dataclasses.dataclass
class QuantKVCache:
    """int8 K/V buffers ``[b, max_len, kv_heads, head_dim]`` with float32
    per-(position, kv head) scales ``[b, kv_heads, max_len]`` (positions
    last, the decode kernel's layout): half the bytes of a bf16 cache.
    See ``generate(kv_quant=True)``."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: List[torch.Tensor]
    v_scale: List[torch.Tensor]
    length: int


Cache = Union[KVCache, QuantKVCache]


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device: Device = None,
    dtype: Optional[torch.dtype] = None,
) -> KVCache:
    """Zeroed KV cache for ``cfg.n_layers`` blocks, in ``dtype``
    (``cfg.dtype`` by default)."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        v=[torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        length=0,
    )


def init_quant_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device: Device = None,
) -> QuantKVCache:
    """Zeroed int8 KV cache (and float32 scales) for ``cfg.n_layers``
    blocks."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    sshape = (batch, cfg.kv_heads, max_len)

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=dev) for _ in range(cfg.n_layers)]

    return QuantKVCache(
        k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
        k_scale=zeros(sshape, torch.float32), v_scale=zeros(sshape, torch.float32),
        length=0,
    )


def _quant_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the trailing head dim: ``(int8
    rows, float32 scales [...])``.  The reference's arithmetic step by
    step (amax, ``max(amax, 1e-8) / 127``, divide, round half to even,
    clip to +-127), so equal float32 input gives equal bits."""
    rows = rows.float()
    scale = torch.clamp_min(rows.abs().amax(-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _buffers(cache: Cache) -> List[Tuple[torch.Tensor, ...]]:
    """Per layer, every buffer of the cache: ``(k, v)`` or ``(k, v,
    k_scale, v_scale)``.  A buffer's position axis is 1 (K/V) or 2
    (scales)."""
    if isinstance(cache, QuantKVCache):
        return list(zip(cache.k, cache.v, cache.k_scale, cache.v_scale))
    return list(zip(cache.k, cache.v))


def _bank(cache: Cache, i: int, k: torch.Tensor, v: torch.Tensor, cols: Any) -> None:
    """Write rows ``k, v: [b, n, nkv, hd]`` into layer ``i`` at positions
    ``cols`` (a slice of length ``n``), quantized for an int8 cache."""
    if isinstance(cache, QuantKVCache):
        (kq, vq), (ks, vs) = _quant_rows(torch.stack([k, v]))
        cache.k[i][:, cols] = kq
        cache.v[i][:, cols] = vq
        cache.k_scale[i][:, :, cols] = ks.transpose(1, 2)
        cache.v_scale[i][:, :, cols] = vs.transpose(1, 2)
    else:
        cache.k[i][:, cols] = k
        cache.v[i][:, cols] = v


def _scales(cache: Cache, i: int) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    if isinstance(cache, QuantKVCache):
        return cache.k_scale[i], cache.v_scale[i]
    return None, None


def _column(t: torch.Tensor, col: int) -> torch.Tensor:
    """A view of one position of a cache buffer (axis 1 of K/V, axis 2 of
    the scales)."""
    return t.select(1 if t.ndim == 4 else 2, col)


def _split_params(
    cfg: TransformerConfig, model: Sequence[Any]
) -> Tuple[Params, List[Params], Params]:
    """(embed, blocks, head) parameter dicts from the flat ``llama(cfg)``
    module (or any sequence of its layers)."""
    layers = list(model)
    if len(layers) != cfg.n_layers + 2:
        raise ValueError(
            f"expected {cfg.n_layers + 2} layers (embed, {cfg.n_layers} "
            f"blocks, head), got {len(layers)}; build the model with "
            "models.transformer.llama(cfg)"
        )
    ps = [layer.params() for layer in layers]
    for p in ps:
        if "mlp" in p or "lora" in p:
            raise not_ported("MoE / LoRA block parameters", "5")
    return ps[0], ps[1:-1], ps[-1]


def _model_device(model: Sequence[Any], device: Device) -> torch.device:
    """The device an entry point runs on, which must hold the model."""
    dev = resolve_device(device)
    held = next(iter(model)).table.device
    if held.type != dev.type or (
        dev.index is not None and held.index != dev.index
    ):
        raise ValueError(f"the model lies on {held}, but the call runs on {dev}")
    return held


def _refuse_moe(moe: Any) -> None:
    if moe is not None:
        raise not_ported("MoE feed-forward (moe=)", "5")


def _attend_ring(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos: int,
) -> torch.Tensor:
    """Decode attention of one query ``[b, 1, nh, hd]`` at position
    ``pos`` over a RING cache ``[b, W, nkv, hd]`` (slot ``j`` holds the
    newest position ``<= pos`` congruent to ``j`` mod W, in the window by
    construction), so the only mask is ``p_j >= 0`` (slots not written
    yet).  The reference's dense read (it has no kernel here).  Float32
    ``[b, 1, nh*hd]``."""
    b, _, nh, hd = q.shape
    W, nkv = ck.shape[1], ck.shape[2]
    qg = q[:, 0].reshape(b, nkv, nh // nkv, hd).float()
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, ck.float()) * (hd ** -0.5)
    j = torch.arange(W, device=q.device)
    p_j = pos - torch.remainder(pos - j, W)
    scores = scores.masked_fill(~(p_j >= 0), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, cv.float())
    return out.reshape(b, 1, nh * hd)


def _attend_chunk(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any,
    window: Optional[int], use_flash: Optional[bool] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention of ``g`` consecutive queries ``[b, g, nh, hd]``
    against the cache (int8 with ``k_scale``/``v_scale``).  A scalar
    ``pos0`` goes to :func:`flash_decode_attention` (the ``flash_decode``
    kernel on the card, which raises for what it does not take); a
    ``[b]`` ``pos0`` and ``use_flash=False`` run the reference's dense
    read (its XLA einsum in ``_attend_chunk``, which it also uses for a
    ``[b]`` ``pos0``): the masked float32 softmax over the whole cache,
    an int8 cache dequantized first.  Float32 ``[b, g, nh*hd]``."""
    per_row = isinstance(pos0, torch.Tensor) and pos0.ndim == 1
    if use_flash is None:
        use_flash = not per_row
    if use_flash:
        if per_row:
            raise ValueError("the flash decode kernel takes one scalar pos0")
        return flash_decode_attention(q, ck, cv, pos0, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    # The reference's dense path, on every device: the same math as the
    # kernel's plain version, so it is that function.
    return flash_decode_reference(q, ck, cv, pos0, window=window,
                                  k_scale=k_scale, v_scale=v_scale)


def _decode_chunk(
    cfg: TransformerConfig, block_params: List[Params], x: torch.Tensor,
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """``g`` consecutive tokens ``x: [b, g, dim]`` through all blocks,
    writing their K/V (quantized for an int8 cache) at ``cache.length``
    in place and reading the cache.  Full caches only (a ring's slot
    reuse cannot be rolled back, which speculative verification needs)."""
    g = x.shape[1]
    pos0 = cache.length
    if pos0 + g > cache.k[0].shape[1]:
        raise ValueError(
            f"cache holds {cache.k[0].shape[1]} positions; writing {g} at "
            f"{pos0} overflows it"
        )
    for i, p in enumerate(block_params):
        q, k, v = _block_qkv(cfg, p, x, pos0)
        _bank(cache, i, k, v, slice(pos0, pos0 + g))
        ks, vs = _scales(cache, i)
        attn = _attend_chunk(q, cache.k[i], cache.v[i], pos0, cfg.attn_window,
                             k_scale=ks, v_scale=vs)
        x = _block_attn_out(cfg, p, x, attn)
    cache.length = pos0 + g
    return x, cache


def _decode_step(
    cfg: TransformerConfig, block_params: List[Params], x: torch.Tensor,
    cache: Cache, ring: bool = False,
) -> Tuple[torch.Tensor, Cache]:
    """One token through all blocks: :func:`_decode_chunk` at ``g=1``,
    or, with ``ring=True``, a write at slot ``pos % W`` of the W-slot
    ring buffers and a read by :func:`_attend_ring` (an int8 ring is
    dequantized for the read, as in the reference)."""
    if not ring:
        return _decode_chunk(cfg, block_params, x, cache)
    pos = cache.length
    slot = pos % cache.k[0].shape[1]
    for i, p in enumerate(block_params):
        q, k, v = _block_qkv(cfg, p, x, pos)
        _bank(cache, i, k, v, slice(slot, slot + 1))
        rk, rv = cache.k[i], cache.v[i]
        if isinstance(cache, QuantKVCache):
            rk = _dequant_rows(rk, cache.k_scale[i])
            rv = _dequant_rows(rv, cache.v_scale[i])
        x = _block_attn_out(cfg, p, x, _attend_ring(q, rk, rv, pos))
    cache.length = pos + 1
    return x, cache


def _columns(cache: Cache, col: int) -> List[Tuple[torch.Tensor, ...]]:
    """Copies of position ``col`` of every buffer, taken before a step."""
    return [tuple(_column(t, col).clone() for t in bufs) for bufs in _buffers(cache)]


def _mask_finished_rows(
    cache: Cache, old_cols: List[Tuple[torch.Tensor, ...]],
    alive: torch.Tensor, col: int,
) -> None:
    """Rows finished before this step (``alive[i]`` false) get back their
    OLD content at position ``col`` (``old_cols``, taken before the step;
    a ring's slot ``pos % W``), scales included, so eos padding never
    enters a finished row's cache.  Only the one column the step wrote
    is merged."""
    for bufs, olds in zip(_buffers(cache), old_cols):
        for t, old in zip(bufs, olds):
            c = _column(t, col)
            a = alive.reshape(-1, *([1] * (old.ndim - 1)))
            c.copy_(torch.where(a, c, old))


def _scatter_rows(
    cache: Cache, i: int, k: torch.Tensor, v: torch.Tensor,
    lengths: torch.Tensor, n_valid: torch.Tensor,
) -> None:
    """Write row ``s``'s token ``j`` of ``k, v: [S, g, nkv, hd]`` at
    position ``lengths[s] + j`` of layer ``i`` when ``j < n_valid[s]``
    (and the position is inside the buffer); other tokens write nothing.
    One gather and one scatter per buffer, with no host read: every token
    targets position ``(lengths[s] + j) % L``, and a masked token writes
    back what that position holds.  Those targets are distinct within a
    row for ``g <= L`` (a masked token's position never wraps onto a valid
    token's), so no two writes collide and a no-op row stays
    bit-untouched.  A token ``j >= L`` lies past the buffer whatever the
    row's length, so a chunk wider than the buffer is cut to its first
    ``L`` tokens."""
    L = cache.k[i].shape[1]
    k, v = k[:, :L], v[:, :L]
    S, g = k.shape[:2]
    rows = torch.arange(S, device=k.device)[:, None]
    pos = lengths[:, None] + torch.arange(g, device=k.device)
    ok = (torch.arange(g, device=k.device) < n_valid[:, None]) & (pos < L)   # [S, g]
    at = torch.remainder(pos, L)
    if isinstance(cache, QuantKVCache):
        (kq, vq), (ks, vs) = _quant_rows(torch.stack([k, v]))
        news = (kq, vq, ks, vs)
    else:
        news = (k, v)
    for buf, new in zip(_buffers(cache)[i], news):
        if buf.ndim == 4:
            cur = buf[rows, at]                                  # [S, g, nkv, hd]
            buf[rows, at] = torch.where(ok[..., None, None], new.to(buf.dtype), cur)
        else:
            cur = buf[rows, :, at]                               # [S, g, nkv]
            buf[rows, :, at] = torch.where(ok[..., None], new, cur)


def _logits(cfg: TransformerConfig, head_p: Params, x: torch.Tensor) -> torch.Tensor:
    return (_block_norm(cfg, head_p, "scale", x) @ head_p["w"]).float()


def _filter_logits(
    logits: torch.Tensor, temperature: float, top_k: Optional[int],
    top_p: Optional[float],
) -> torch.Tensor:
    """Temperature, then top-k, then nucleus (top-p) masking, as in the
    reference (the most probable token always survives; ties at the
    cutoff are kept; ``top_p >= 1`` is a no-op)."""
    logits = logits / temperature
    neg_inf = logits.new_full((), float("-inf"))   # a fill: capturable in a CUDA graph
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        n_keep = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(srt, -1, n_keep - 1)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def _sample(
    logits: torch.Tensor, generator: Optional[torch.Generator],
    temperature: float, top_k: Optional[int], top_p: Optional[float] = None,
) -> torch.Tensor:
    """Greedy ``argmax`` (ties to the first index, as ``jnp.argmax``) at
    ``temperature == 0``; otherwise a draw from the filtered softmax."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int64)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the ``k`` largest entries of the last axis in
    descending order, equal values by ascending index (a stable sort;
    ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _attend_full(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Causal (optionally banded) full-sequence GQA attention, flattened
    to ``[b, s, nh*hd]``.  By default :func:`flash_attention` (the
    ``flash_fwd`` kernel on the card, which raises for what it does not
    take); ``use_flash=False`` forces the dense version."""
    b, s, nh, hd = q.shape
    attend = flash_attention_reference if use_flash is False else flash_attention
    out = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                 causal=True, window=window)
    return out.reshape(b, s, nh * hd)


def _total_len(s: int, max_new_tokens: int, max_len: Optional[int]) -> int:
    total = (s + max_new_tokens) if max_len is None else max_len
    if total < s + max_new_tokens:
        raise ValueError(
            f"max_len={total} cannot hold prompt ({s}) + max_new_tokens "
            f"({max_new_tokens})"
        )
    return total


def _check_decodable(cfg: TransformerConfig) -> None:
    """Causal pre-norm configs only (the reference's checks; learned
    position tables, whose length check needs the position count, are
    refused by ``check_ported``)."""
    if not cfg.causal:
        raise ValueError(
            "the KV-cache generation API is causal by construction; "
            "cfg.causal=False has no autoregressive decode"
        )
    if cfg.norm_position != "pre":
        raise ValueError("the decode paths compute pre-norm blocks")
    cfg.check_ported()


@torch.inference_mode()
def prefill(
    cfg: TransformerConfig, model: Sequence[Any], tokens: Any, max_len: int,
    *, use_flash: Optional[bool] = None, ring: bool = False,
    kv_quant: bool = False, moe: Any = None, device: Device = None,
) -> Tuple[torch.Tensor, Cache]:
    """One batched pass over the prompt ``tokens: [b, s]``: banks every
    block's K/V in a new ``max_len`` cache and returns (last-position
    float32 logits ``[b, vocab]``, cache at length ``s``).  Only the last
    position's logits are computed.  Attention runs in floating point;
    with ``kv_quant=True`` only the banked rows are quantized (int8
    :class:`QuantKVCache`).  ``ring=True`` (needs ``cfg.attn_window``)
    banks into ``[b, attn_window, ...]`` ring buffers: slot ``j`` holds
    the newest prompt position congruent to ``j`` mod W."""
    _refuse_moe(moe)
    dev = _model_device(model, device)
    tokens = torch.as_tensor(tokens, device=dev)
    embed_p, block_p, head_p = _split_params(cfg, model)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    _check_decodable(cfg)
    if ring and cfg.attn_window is None:
        raise ValueError(
            "ring caches hold exactly the attention window: set "
            "cfg.attn_window to use ring=True"
        )
    W = cfg.attn_window
    L = W if ring else max_len
    cache = (init_quant_cache if kv_quant else init_cache)(cfg, b, L, device=dev)
    if ring:
        # Never-written slots (s < W) gather row 0; _attend_ring masks them.
        j = torch.arange(W, device=dev)
        idx = ((s - 1) - torch.remainder((s - 1) - j, W)).clamp(0, s - 1)
    x = _embed(cfg, embed_p, tokens)
    for i, p in enumerate(block_p):
        q, k, v = _block_qkv(cfg, p, x, 0)
        attn = _attend_full(q, k, v, cfg.attn_window, use_flash)
        x = _block_attn_out(cfg, p, x, attn)
        if ring:
            k, v = k[:, idx], v[:, idx]
        _bank(cache, i, k, v, slice(0, k.shape[1]))
    cache.length = s
    return _logits(cfg, head_p, x[:, -1:])[:, 0], cache


def _decode_slots(
    cfg: TransformerConfig, params: Tuple[Params, List[Params], Params],
    tokens: torch.Tensor, cache: Cache, lengths: torch.Tensor,
    n_valid: torch.Tensor,
) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    embed_p, block_p, head_p = params
    x = _embed(cfg, embed_p, tokens)
    for i, p in enumerate(block_p):
        q, k, v = _block_qkv(cfg, p, x, lengths)
        _scatter_rows(cache, i, k, v, lengths, n_valid)
        ks, vs = _scales(cache, i)
        # Per-row frontiers: the reference's dense path (it forces
        # use_flash=False here; its kernel takes one pos0, as ours does).
        attn = flash_decode_reference(q, cache.k[i], cache.v[i], lengths,
                                      window=cfg.attn_window, k_scale=ks, v_scale=vs)
        x = _block_attn_out(cfg, p, x, attn)
    return _logits(cfg, head_p, x), cache, lengths + n_valid


@torch.inference_mode()
def decode_slots(
    cfg: TransformerConfig, model: Sequence[Any], tokens: Any, cache: Cache,
    lengths: Any, n_valid: Any, moe: Any = None, device: Device = None,
) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """The slot-masked decode step: ``tokens: [S, g]`` through all
    blocks, slot ``i`` at its OWN position ``lengths[i]``, its tokens
    ``j >= n_valid[i]`` masked no-ops (their K/V writes dropped, their
    outputs garbage the caller never reads; ``n_valid[i] = 0`` leaves the
    slot's cache bit-untouched).  Returns ``(logits [S, g, vocab]
    float32, cache, lengths + n_valid)``.  Full caches (bf16/f32 or
    int8), updated in place; ``cache.length`` is left as it was (the
    frontiers live in ``lengths``; the reference keeps their sum there
    only for its schema).  The attention read is the reference's dense
    one (``flash_decode_reference`` with a ``[b]`` ``pos0``): the kernel
    takes one scalar ``pos0``."""
    _refuse_moe(moe)
    dev = _model_device(model, device)
    params = _split_params(cfg, model)
    tokens = torch.as_tensor(tokens, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
    return _decode_slots(cfg, params, tokens, cache, lengths, n_valid)


def row_frontiers(
    prompt_len: int, out: torch.Tensor, eos_id: Optional[int] = None,
) -> torch.Tensor:
    """Per-row true cache frontiers after a first-turn :func:`generate`
    with ``return_state=True``: ``prompt_len`` plus the tokens the row
    wrote, up to and including its first ``eos_id``.  Feed the result to
    ``generate(..., cache=..., row_lengths=...)``; later turns return
    updated frontiers themselves."""
    b, T = out.shape
    if eos_id is None:
        return torch.full((b,), prompt_len + T, dtype=torch.int64, device=out.device)
    is_eos = out == eos_id
    first = torch.argmax(is_eos.to(torch.int8), dim=1) + 1
    n = torch.where(is_eos.any(dim=1), first, torch.full_like(first, T))
    return prompt_len + n


def _generate_rows(
    cfg: TransformerConfig, model: Sequence[Any], prompt: torch.Tensor,
    max_new_tokens: int, *, temperature: float, top_k: Optional[int],
    top_p: Optional[float], eos_id: Optional[int],
    generator: Optional[torch.Generator], cache: Cache, row_lengths: Any,
    return_state: bool,
) -> Any:
    """``generate(row_lengths=...)``: a turn continued with every row at
    its own frontier through :func:`decode_slots` (the turn's prompt
    teacher-forced, then one token a step; finished rows are true
    no-ops).  Returns ``out`` or ``(out, cache, new_row_lengths)``."""
    dev = prompt.device
    b, s = prompt.shape
    rl = torch.as_tensor(row_lengths, dtype=torch.int64, device=dev)
    if tuple(rl.shape) != (b,):
        raise ValueError(
            f"row_lengths must hold one frontier per prompt row ([{b}]), got "
            f"shape {tuple(rl.shape)}"
        )
    L = cache.k[0].shape[1]
    _check_decodable(cfg)
    deepest = int(rl.max())
    if deepest + s + max_new_tokens > L:
        raise ValueError(
            f"cache buffers hold {L} positions but the deepest row (frontier "
            f"{deepest}) + this turn ({s} prompt + {max_new_tokens} new) "
            f"reaches {deepest + s + max_new_tokens}; budget the first call's "
            "max_len for all turns"
        )
    params = _split_params(cfg, model)
    logits_g, cache, rl = _decode_slots(
        cfg, params, prompt, cache, rl, torch.full_like(rl, s)
    )
    logits = logits_g[:, -1]
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    toks = []
    for _ in range(max_new_tokens):
        tok = _sample(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(alive, tok, torch.full_like(tok, eos_id))
            # The finishing step's eos IS written; rows dead before it are
            # no-ops and their frontiers freeze.
            n_valid = alive.to(torch.int64)
            alive = alive & (tok != eos_id)
        else:
            n_valid = torch.ones_like(rl)
        logits_g, cache, rl = _decode_slots(cfg, params, tok[:, None], cache, rl,
                                            n_valid)
        logits = logits_g[:, 0]
        toks.append(tok)
    out = _stack_tokens(toks, b, dev)
    return (out, cache, rl) if return_state else out


def _stack_tokens(toks: List[torch.Tensor], b: int, dev: torch.device) -> torch.Tensor:
    if toks:
        return torch.stack(toks, dim=1)
    return torch.zeros((b, 0), dtype=torch.int64, device=dev)


@torch.inference_mode()
def generate(
    cfg: TransformerConfig, model: Sequence[Any], prompt: Any,
    max_new_tokens: int, *, temperature: float = 0.0,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    eos_id: Optional[int] = None, generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None, moe: Any = None, cache_mode: str = "full",
    kv_quant: bool = False, cache: Optional[Cache] = None,
    return_state: bool = False, early_exit: bool = False,
    row_lengths: Any = None, device: Device = None,
) -> Any:
    """Autoregressive decode: returns int64 ``[b, max_new_tokens]``.

    ``temperature=0`` is greedy; otherwise pass ``generator``.  With
    ``eos_id``, rows that emitted it keep emitting it and become masked
    no-ops whose cache stops being written.

    ``kv_quant=True`` stores K/V as int8 with per-(position, kv head)
    scales (:class:`QuantKVCache`), read by the int8 variant of the
    decode kernel: half the cache bytes of bf16.  ``cache_mode='ring'``
    (needs ``cfg.attn_window``) keeps W-slot ring caches: O(window)
    memory and reads; it composes with ``kv_quant``.

    Multi-turn: ``return_state=True`` returns ``(tokens, cache)``; pass
    the cache back with ``cache=`` and the next turn's tokens as
    ``prompt``, which are absorbed one token at a time through the
    decode path.  After an eos-ragged turn, ``row_lengths=`` (from
    :func:`row_frontiers`) continues every row at its own frontier
    through :func:`decode_slots`, and ``return_state`` then returns
    ``(tokens, cache, new_row_lengths)``.

    ``early_exit=True`` (needs ``eos_id``) stops once every row has
    finished; the columns not run hold ``eos_id``, so the tokens equal
    the fixed-length run's.  Stopping exactly there costs one
    device-to-host read of "any row alive" per step (the reference's
    ``while_loop`` condition); without ``early_exit`` the loop reads
    nothing back."""
    if cache_mode not in ("full", "ring"):
        raise ValueError(f"cache_mode must be 'full' or 'ring', got {cache_mode!r}")
    ring = cache_mode == "ring"
    if ring and cfg.attn_window is None:
        raise ValueError(
            "cache_mode='ring' holds exactly the attention window: set "
            "cfg.attn_window"
        )
    _refuse_moe(moe)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs generator=torch.Generator")
    dev = _model_device(model, device)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    if row_lengths is not None:
        if cache is None:
            raise ValueError(
                "row_lengths continues PER-ROW frontiers of an existing cache: "
                "pass cache= from the previous turn's return_state=True (a "
                "first turn has one shared frontier — no row_lengths needed)"
            )
        if ring:
            raise ValueError(
                "row_lengths continuation runs through decode_slots, which "
                "ring caches defeat (slot = pos % W aliases the per-row "
                "frontiers); use cache_mode='full'"
            )
        if early_exit:
            raise ValueError(
                "early_exit is not supported with row_lengths; the "
                "fixed-length loop already masks finished rows to no-ops"
            )
        if max_len is not None:
            raise ValueError(
                "max_len sizes a NEW cache; row_lengths continuation runs "
                "inside the existing cache buffers (budget the first call's "
                "max_len for all turns)"
            )
        return _generate_rows(
            cfg, model, prompt, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos_id, generator=generator,
            cache=cache, row_lengths=row_lengths, return_state=return_state,
        )
    if early_exit and eos_id is None:
        raise ValueError(
            "early_exit terminates when every row has emitted eos_id; set "
            "eos_id (without it no row ever finishes early)"
        )
    total = _total_len(s, max_new_tokens, max_len)
    _check_decodable(cfg)
    embed_p, block_p, head_p = _split_params(cfg, model)
    if cache is None:
        logits, cache = prefill(cfg, model, prompt, total, ring=ring,
                                kv_quant=kv_quant, device=dev)
    else:
        # Continuation: absorb this turn's tokens through the decode path.
        for t in range(s):
            x = _embed(cfg, embed_p, prompt[:, t:t + 1])
            x, cache = _decode_step(cfg, block_p, x, cache, ring)
            logits = _logits(cfg, head_p, x)[:, 0]
    L = cache.k[0].shape[1]
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    toks = []
    for n in range(max_new_tokens):
        if early_exit and n and not bool(alive.any()):
            break
        tok = _sample(logits, generator, temperature, top_k, top_p)
        col = cache.length % L
        if eos_id is not None:
            tok = torch.where(alive, tok, torch.full_like(tok, eos_id))
            was_alive = alive
            alive = alive & (tok != eos_id)
            old_cols = _columns(cache, col)
        x = _embed(cfg, embed_p, tok[:, None])
        x, cache = _decode_step(cfg, block_p, x, cache, ring)
        if eos_id is not None:
            _mask_finished_rows(cache, old_cols, was_alive, col)
        logits = _logits(cfg, head_p, x)[:, 0]
        toks.append(tok)
    out = _stack_tokens(toks, b, dev)
    if out.shape[1] < max_new_tokens:
        pad = torch.full((b, max_new_tokens - out.shape[1]), eos_id,
                         dtype=torch.int64, device=dev)
        out = torch.cat([out, pad], dim=1)
    return (out, cache) if return_state else out


@torch.inference_mode()
def beam_search(
    cfg: TransformerConfig, model: Sequence[Any], prompt: Any,
    max_new_tokens: int, *, num_beams: int = 4, eos_id: Optional[int] = None,
    max_len: Optional[int] = None, moe: Any = None, device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic beam decode: ``(tokens [b, max_new_tokens], log-probs
    [b])`` of each prompt's best beam.

    Beams flatten into the batch (prompt ``i``'s beams are rows ``i*k ..
    i*k+k-1``, decoded like :func:`generate`'s batch over full caches in
    ``cfg.dtype``), and every step reorders the caches by parent beam
    with one ``index_select`` per layer.  With ``eos_id``, finished beams
    freeze (they append ``eos_id`` at no further log-prob) and every
    finished hypothesis is banked in a per-prompt pool, so a completed
    sequence survives later eviction.  Candidates are ranked as
    ``lax.top_k`` ranks them (ties to the lower index), so
    ``num_beams=1`` is greedy :func:`generate`.  The reference also
    decodes the last step's tokens, whose logits nothing reads; the port
    skips that decode."""
    _refuse_moe(moe)
    dev = _model_device(model, device)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    k = num_beams
    if k < 1:
        raise ValueError(f"num_beams must be >= 1, got {k}")
    total = _total_len(s, max_new_tokens, max_len)
    _check_decodable(cfg)
    embed_p, block_p, head_p = _split_params(cfg, model)
    logits0, cache = prefill(cfg, model, prompt, total, device=dev)
    vocab = logits0.shape[-1]
    T = max_new_tokens

    seed_lp, seed_tok = _top_k(torch.log_softmax(logits0, dim=-1), k)   # [b, k]
    cache = KVCache(k=[a.repeat_interleave(k, dim=0) for a in cache.k],
                    v=[a.repeat_interleave(k, dim=0) for a in cache.v],
                    length=cache.length)

    def flat_decode(tok: torch.Tensor) -> torch.Tensor:
        x = _embed(cfg, embed_p, tok.reshape(b * k, 1))
        x, _ = _decode_step(cfg, block_p, x, cache)
        return _logits(cfg, head_p, x)[:, 0]                            # [b*k, V]

    logits = flat_decode(seed_tok)
    beam_lp = seed_lp
    alive = (seed_tok != eos_id) if eos_id is not None else torch.ones(
        (b, k), dtype=torch.bool, device=dev)
    hist = torch.zeros((b, k, T), dtype=torch.int64, device=dev)
    hist[..., 0] = seed_tok
    ar = torch.arange(b, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    fin_lp = torch.full((b,), float("-inf"), device=dev)
    fin_hist = torch.zeros((b, T), dtype=torch.int64, device=dev)

    def bank_finished(newly: torch.Tensor, lp: torch.Tensor) -> None:
        nonlocal fin_lp, fin_hist
        cand = torch.where(newly, lp, neg_inf)
        j = torch.argmax(cand, dim=-1)
        cand_lp = cand[ar, j]
        better = cand_lp > fin_lp
        fin_lp = torch.where(better, cand_lp, fin_lp)
        fin_hist = torch.where(better[:, None], hist[ar, j], fin_hist)

    if eos_id is not None:
        bank_finished(seed_tok == eos_id, seed_lp)
        only_eos = torch.full((vocab,), float("-inf"), device=dev)
        only_eos[eos_id] = 0.0
    for t in range(1, T):
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, vocab)
        if eos_id is not None:
            logp = torch.where(alive[..., None], logp, only_eos)
        cand = beam_lp[..., None] + logp
        beam_lp, flat_idx = _top_k(cand.reshape(b, k * vocab), k)
        parent = flat_idx // vocab
        tok = flat_idx % vocab
        rows = (ar[:, None] * k + parent).reshape(b * k)
        hist = hist.reshape(b * k, T)[rows].reshape(b, k, T)
        hist[..., t] = tok
        cache.k = [a.index_select(0, rows) for a in cache.k]
        cache.v = [a.index_select(0, rows) for a in cache.v]
        if eos_id is not None:
            alive = alive.reshape(b * k)[rows].reshape(b, k)
            newly = alive & (tok == eos_id)
            alive = alive & (tok != eos_id)
            bank_finished(newly, beam_lp)
        if t < T - 1:
            logits = flat_decode(tok)
    best = torch.argmax(beam_lp, dim=-1)
    best_lp = beam_lp[ar, best]
    out = hist[ar, best]
    use_fin = fin_lp > best_lp
    out = torch.where(use_fin[:, None], fin_hist, out)
    if eos_id is not None:
        # Everything after the first eos is eos (banked histories carry
        # zeros there).
        seen = torch.cumsum((out == eos_id).to(torch.int64), dim=1) > 0
        prev = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                          seen[:, :-1]], dim=1)
        out = torch.where(prev, torch.full_like(out, eos_id), out)
    return out, torch.where(use_fin, fin_lp, best_lp)


class SpecStats(NamedTuple):
    """Per-row speculative-decoding accounting (host counts, int64
    ``[b]``): ``rounds`` draft-verify cycles ran, ``drafted`` tokens were
    proposed in them, ``accepted`` passed the target's test.  Emitted
    tokens = ``rounds + accepted``."""

    rounds: torch.Tensor
    drafted: torch.Tensor
    accepted: torch.Tensor


def _row_cache(cache: KVCache, i: int) -> KVCache:
    """Row ``i`` of a batched cache as a ``b=1`` cache of views (leading
    dim slices of contiguous buffers: contiguous, no copy)."""
    return KVCache(k=[a[i:i + 1] for a in cache.k], v=[a[i:i + 1] for a in cache.v],
                   length=cache.length)


@torch.inference_mode()
def speculative_generate(
    cfg: TransformerConfig, model: Sequence[Any],
    draft_cfg: TransformerConfig, draft_model: Sequence[Any], prompt: Any,
    max_new_tokens: int, *, gamma: int = 4, temperature: float = 0.0,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    eos_id: Optional[int] = None, generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None, moe: Any = None, draft_moe: Any = None,
    return_stats: bool = False, device: Device = None,
) -> Any:
    """Speculative decoding: the ``draft`` model proposes ``gamma``
    tokens a round, the target judges them in ONE chunked pass
    (:func:`_decode_chunk` at ``gamma + 1`` queries), and the accepted
    prefix plus one target token land at once.  Drafts are accepted with
    probability ``min(1, p/q)`` and rejections resample the normalized
    residual ``(p-q)+``, so the output is distributed as target-only
    sampling; at ``temperature=0`` it equals greedy :func:`generate`
    token for token (up to near-ties that the chunked read's summation
    order resolves either way).  The models must share ``vocab``.

    Both models prefill batched; the rounds then run row by row (the
    reference's ``vmap`` over a ``while_loop``) on ``b=1`` views of the
    batched caches, whose buffers are padded to ``total + gamma + 1``
    positions so a round's writes past the accepted frontier fit.  A
    rejection only moves the host frontier back.  Each round reads its
    accepted count to the host once.  Returns ``[b, max_new_tokens]`` or,
    with ``return_stats``, ``(tokens, SpecStats)``."""
    _refuse_moe(moe)
    _refuse_moe(draft_moe)
    dev = _model_device(model, device)
    _model_device(draft_model, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    T, g = int(max_new_tokens), int(gamma)
    if g < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            "speculative decoding needs a shared tokenizer: target vocab "
            f"{cfg.vocab} != draft vocab {draft_cfg.vocab}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs generator=torch.Generator")
    total = _total_len(s, T, max_len)
    _check_decodable(cfg)
    _check_decodable(draft_cfg)
    L = total + g + 1
    embed_p, block_p, head_p = _split_params(cfg, model)
    d_embed_p, d_block_p, d_head_p = _split_params(draft_cfg, draft_model)
    greedy = temperature == 0.0

    def filtered(logits: torch.Tensor) -> torch.Tensor:
        return logits if greedy else _filter_logits(logits, temperature, top_k, top_p)

    def draw(probs: torch.Tensor) -> torch.Tensor:
        return torch.multinomial(probs, 1, generator=generator)[0]

    t_logits0, tcache0 = prefill(cfg, model, prompt, L, device=dev)
    _, dcache0 = prefill(draft_cfg, draft_model, prompt, L, device=dev)
    tok0 = _sample(t_logits0, generator, temperature, top_k, top_p)     # [b]
    out = torch.zeros((b, T), dtype=torch.int64, device=dev)
    out[:, 0] = tok0
    stats = torch.zeros((3, b), dtype=torch.int64)
    for i in range(b):
        tc, dc = _row_cache(tcache0, i), _row_cache(dcache0, i)
        tok = tok0[i:i + 1]                                             # [1]
        alive = tok0[i] != eos_id if eos_id is not None else None
        n = 1
        while n < T:
            # Draft: gamma proposals, plus one feed that banks the last.
            cur, drafts, q_logits = tok, [], []
            for _ in range(g + 1):
                x = _embed(draft_cfg, d_embed_p, cur[:, None])
                x, _ = _decode_step(draft_cfg, d_block_p, x, dc)
                ql = filtered(_logits(draft_cfg, d_head_p, x)[0, 0])
                nxt = torch.argmax(ql) if greedy else draw(torch.softmax(ql, -1))
                drafts.append(nxt)
                q_logits.append(ql)
                cur = nxt.reshape(1)
            drafts = torch.stack(drafts)[:g]                            # [g]
            # Verify: one chunk over [tok, d_1 .. d_g].
            frontier = tc.length
            x = _embed(cfg, embed_p, torch.cat([tok, drafts])[None])
            x, _ = _decode_chunk(cfg, block_p, x, tc)
            p_logits = filtered(_logits(cfg, head_p, x)[0])             # [g+1, V]
            if greedy:
                t_argmax = torch.argmax(p_logits, dim=-1)
                accs = drafts == t_argmax[:g]
            else:
                p_probs = torch.softmax(p_logits, dim=-1)
                q_probs = torch.softmax(torch.stack(q_logits), dim=-1)
                u = torch.rand(g, generator=generator, device=dev)
                at = drafts[:, None]
                accs = u * q_probs[:g].gather(1, at)[:, 0] < p_probs[:g].gather(1, at)[:, 0]
            n_acc = int(torch.cumprod(accs.to(torch.int64), 0).sum())   # host read
            if greedy:
                last = t_argmax[n_acc]
            elif n_acc == g:
                last = draw(p_probs[g])
            else:
                # Correction: the normalized residual (p - q)+, or p where
                # it vanishes numerically.
                resid = torch.clamp_min(p_probs[n_acc] - q_probs[n_acc], 0.0)
                rsum = resid.sum()
                last = draw(torch.where(rsum > 1e-9, resid / rsum, p_probs[n_acc]))
            emitted = torch.cat([drafts[:n_acc], last.reshape(1)])      # [n_acc+1]
            if eos_id is not None:
                # Freeze on eos inside the round, as generate does.
                effs = []
                for t_ in emitted:
                    t_ = torch.where(alive, t_, torch.full_like(t_, eos_id))
                    alive = alive & (t_ != eos_id)
                    effs.append(t_)
                emitted = torch.stack(effs)
            m = min(n_acc + 1, T - n)
            out[i, n:n + m] = emitted[:m]
            # Roll both caches back to the accepted frontier.
            tc.length = dc.length = frontier + 1 + n_acc
            stats[:, i] += torch.tensor([1, g, n_acc])
            n += 1 + n_acc
            tok = emitted[n_acc:]
    if return_stats:
        return out, SpecStats(rounds=stats[0], drafted=stats[1], accepted=stats[2])
    return out
