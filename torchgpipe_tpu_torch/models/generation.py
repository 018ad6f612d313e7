"""KV-cache autoregressive generation for the Llama family.

Counterpart of ``torchgpipe_tpu/models/generation.py`` (the full-cache
path of ``generate``).  Prefill runs one batched pass over the prompt
with ``ops.flash_attention.flash_attention`` (the ``flash_fwd`` CUDA
kernel on the card) and banks every block's K/V; each decode step runs
one token through the blocks, reading the live cache prefix with
``flash_decode_attention`` (the ``flash_decode`` kernel).

Differences from the reference, all forced by PyTorch running eagerly:

* The cache is updated IN PLACE (one column per decode step) instead of
  returned as new immutable buffers, and ``KVCache.length`` is a host
  ``int``: ``generate`` knows every position on the host, so no step
  waits on the device.
* The reference's ``lax.scan`` over decode steps is a Python loop; it
  samples, then decodes, exactly as the scan body does, with no
  per-step device-to-host sync.
* Randomness comes from an explicit ``torch.Generator``; a JAX key and a
  generator give different streams from one seed, so sampled (non
  greedy) outputs are not comparable across the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

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


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device: Device = None,
) -> KVCache:
    """Zeroed ``cfg.dtype`` KV cache for ``cfg.n_layers`` blocks."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    dt = cfg.dtype
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        v=[torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        length=0,
    )


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


def _attend_chunk(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos0: Any,
    window: Optional[int], use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Causal attention of ``g`` consecutive queries ``[b, g, nh, hd]``
    against the cache.  A scalar ``pos0`` goes to
    :func:`flash_decode_attention` (the ``flash_decode`` kernel on the
    card, which raises for what it does not take); a ``[b]`` ``pos0``
    (one frontier per row, the serving pool's case) and
    ``use_flash=False`` run the dense masked softmax.  Float32
    ``[b, g, nh*hd]``."""
    per_row = isinstance(pos0, torch.Tensor) and pos0.ndim == 1
    if use_flash is None:
        use_flash = not per_row
    if use_flash:
        if per_row:
            raise ValueError("the flash decode kernel takes one scalar pos0")
        return flash_decode_attention(q, ck, cv, pos0, window=window)
    return flash_decode_reference(q, ck, cv, pos0, window=window)


def _decode_chunk(
    cfg: TransformerConfig, block_params: List[Params], x: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """``g`` consecutive tokens ``x: [b, g, dim]`` through all blocks,
    writing their K/V at ``cache.length`` in place and reading the
    cache."""
    g = x.shape[1]
    pos0 = cache.length
    if pos0 + g > cache.k[0].shape[1]:
        raise ValueError(
            f"cache holds {cache.k[0].shape[1]} positions; writing {g} at "
            f"{pos0} overflows it"
        )
    for p, ck, cv in zip(block_params, cache.k, cache.v):
        q, k, v = _block_qkv(cfg, p, x, pos0)
        ck[:, pos0:pos0 + g] = k
        cv[:, pos0:pos0 + g] = v
        attn = _attend_chunk(q, ck, cv, pos0, cfg.attn_window)
        x = _block_attn_out(cfg, p, x, attn)
    cache.length = pos0 + g
    return x, cache


def _decode_step(
    cfg: TransformerConfig, block_params: List[Params], x: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One token through all blocks: :func:`_decode_chunk` at ``g=1``
    (ring caches, the reference's other branch, are not ported)."""
    return _decode_chunk(cfg, block_params, x, cache)


def _mask_finished_rows(
    cache: KVCache, old_cols: List[Tuple[torch.Tensor, torch.Tensor]],
    alive: torch.Tensor, pos: int,
) -> None:
    """Rows finished before this step (``alive[i]`` false) get back their
    OLD cache column at ``pos`` (``old_cols``, taken before the step), so
    eos padding never enters a finished row's K/V.  Only the one column
    the step wrote is merged."""
    a = alive[:, None, None]
    for ck, cv, (ok, ov) in zip(cache.k, cache.v, old_cols):
        ck[:, pos] = torch.where(a, ck[:, pos], ok)
        cv[:, pos] = torch.where(a, cv[:, pos], ov)


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
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
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
) -> Tuple[torch.Tensor, KVCache]:
    """One batched pass over the prompt ``tokens: [b, s]``: banks every
    block's K/V in a new ``max_len`` cache and returns (last-position
    float32 logits ``[b, vocab]``, cache at length ``s``).  Only the last
    position's logits are computed."""
    if ring:
        raise not_ported("ring KV caches (ring=True)", "3")
    if kv_quant:
        raise not_ported("the int8 KV cache (kv_quant=True)", "3")
    if moe is not None:
        raise not_ported("MoE feed-forward (moe=)", "5")
    dev = _model_device(model, device)
    tokens = torch.as_tensor(tokens, device=dev)
    embed_p, block_p, head_p = _split_params(cfg, model)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    _check_decodable(cfg)
    cache = init_cache(cfg, b, max_len, device=dev)
    x = _embed(cfg, embed_p, tokens)
    for p, ck, cv in zip(block_p, cache.k, cache.v):
        q, k, v = _block_qkv(cfg, p, x, 0)
        attn = _attend_full(q, k, v, cfg.attn_window, use_flash)
        x = _block_attn_out(cfg, p, x, attn)
        ck[:, :s] = k
        cv[:, :s] = v
    cache.length = s
    return _logits(cfg, head_p, x[:, -1:])[:, 0], cache


@torch.inference_mode()
def generate(
    cfg: TransformerConfig, model: Sequence[Any], prompt: Any,
    max_new_tokens: int, *, temperature: float = 0.0,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    eos_id: Optional[int] = None, generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None, moe: Any = None, cache_mode: str = "full",
    kv_quant: bool = False, cache: Optional[KVCache] = None,
    return_state: bool = False, early_exit: bool = False,
    row_lengths: Any = None, device: Device = None,
) -> Any:
    """Autoregressive decode: returns int64 ``[b, max_new_tokens]``.

    ``temperature=0`` is greedy; otherwise pass ``generator``.  With
    ``eos_id``, rows that emitted it keep emitting it and become masked
    no-ops whose cache stops being written.  ``return_state=True``
    returns ``(tokens, cache)``."""
    if cache_mode not in ("full", "ring"):
        raise ValueError(f"cache_mode must be 'full' or 'ring', got {cache_mode!r}")
    if cache_mode == "ring":
        raise not_ported("ring KV caches (cache_mode='ring')", "3")
    for flag, what in (
        (kv_quant, "the int8 KV cache (kv_quant=True)"),
        (row_lengths is not None, "per-row continuation (row_lengths=)"),
        (early_exit, "early exit (early_exit=True)"),
        (cache is not None, "multi-turn continuation (cache=)"),
    ):
        if flag:
            raise not_ported(what, "3")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs generator=torch.Generator")
    dev = _model_device(model, device)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    total = _total_len(s, max_new_tokens, max_len)
    _check_decodable(cfg)
    embed_p, block_p, head_p = _split_params(cfg, model)
    logits, cache = prefill(cfg, model, prompt, total, moe=moe, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    toks = []
    for _ in range(max_new_tokens):
        tok = _sample(logits, generator, temperature, top_k, top_p)
        pos = cache.length
        if eos_id is not None:
            tok = torch.where(alive, tok, torch.full_like(tok, eos_id))
            was_alive = alive
            alive = alive & (tok != eos_id)
            old_cols = [(ck[:, pos].clone(), cv[:, pos].clone())
                        for ck, cv in zip(cache.k, cache.v)]
        x = _embed(cfg, embed_p, tok[:, None])
        x, cache = _decode_step(cfg, block_p, x, cache)
        if eos_id is not None:
            _mask_finished_rows(cache, old_cols, was_alive, pos)
        logits = _logits(cfg, head_p, x)[:, 0]
        toks.append(tok)
    out = torch.stack(toks, dim=1) if toks else torch.zeros(
        (b, 0), dtype=torch.int64, device=dev
    )
    return (out, cache) if return_state else out
