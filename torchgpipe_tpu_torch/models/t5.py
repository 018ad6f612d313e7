"""T5 encoder-decoder as one flat sequential layer list.

Counterpart of ``torchgpipe_tpu/models/t5.py`` (``T5Config``,
``_rel_bucket``, ``_rel_bias``, ``_attend``, ``t5_embed``,
``t5_enc_block``, ``t5_enc_final``, ``t5_dec_block``, ``t5_final``,
``t5_layers``, ``t5_encode``, ``t5_generate``, ``t5_shift_right``)::

    [embed, enc_block x Ne, enc_final, dec_block x Nd, final]

The activation between layers is the reference's tuple carrier:
``(enc_ids, dec_ids)`` in, ``(h_enc, h_dec)`` after ``embed`` (both
streams through the one shared table), ``(h_enc, h_dec, ebias)`` through
the encoder blocks, ``(h_enc, h_dec)`` after ``enc_final``, ``(h_enc,
h_dec, dbias)`` through the decoder blocks, ``[b, sd, vocab]`` logits
after ``final``.  Only the model input is split into micro-batches; the
batch-1 bias carriers (``[1, heads, s, s]``, computed by the first block
of each stack from its bucket table ``rel``) cross stage cuts whole.

T5 specifics, as in the reference: relative-position buckets (log-spaced
far bins, bidirectional in the encoder, causal in the decoder), no
1/sqrt(d) score scaling, RMS norms without bias, ``relu`` (v1.0) or
gated feed-forward (v1.1), and for a tied config (v1.0) the ``dim^-1/2``
rescale before ``final``'s own head ``w``.  Attention is dense: the
flash kernels have no operand for an additive bias, and the reference
never calls its kernel here either.

Bucket ids come from the reference's float32 formula evaluated once per
``(query length, key length, direction)`` on the host, then cached on
each device: one implementation of ``log`` decides every bucket edge,
whatever device runs the model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.models.generation import _model_device, _sample
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    _act_fn,
    _init,
    _Layer,
    _normal,
    _param,
    _rms,
    resolve_device,
)

__all__ = ["T5Config", "t5_encode", "t5_generate", "t5_layers", "t5_shift_right"]

_NEG = -1e9   # additive mask; the softmax runs in float32


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Architecture of a T5-family encoder-decoder (field for field the
    reference's; ``dtype`` is a ``torch.dtype``).  Defaults are t5-small
    (v1.0)."""

    vocab: int = 32128
    dim: int = 512
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    n_heads: int = 8
    head_dim: Optional[int] = None
    mlp_hidden: int = 2048
    act: str = "relu"
    gated_mlp: bool = False
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    tie_word_embeddings: bool = True
    decoder_start_id: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def inner(self) -> int:
        return self.n_heads * self.hd

    @property
    def logit_scale(self) -> Optional[float]:
        return self.dim ** -0.5 if self.tie_word_embeddings else None


def _rel_bucket(rel: torch.Tensor, *, bidirectional: bool, buckets: int,
                max_dist: int) -> torch.Tensor:
    """T5's relative position (``key - query``, int32) to bucket id,
    step by step the reference's: float32 ``log`` of the distance over
    ``max_exact``, over ``log(max_dist / max_exact)``, times the far
    buckets, truncated to an integer."""
    out = torch.zeros_like(rel)
    if bidirectional:
        buckets //= 2
        out = out + (rel > 0).to(rel.dtype) * buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp_max(rel, 0)
    max_exact = buckets // 2
    is_small = rel < max_exact
    rel_f = torch.clamp_min(rel, 1).float()
    denom = torch.log(torch.tensor(max_dist / max_exact, dtype=torch.float32))
    large = max_exact + (
        torch.log(rel_f / max_exact) / denom * (buckets - max_exact)
    ).to(rel.dtype)
    large = torch.clamp_max(large, buckets - 1)
    return out + torch.where(is_small, rel, large)


@functools.lru_cache(maxsize=32)
def _bucket_ids(qlen: int, klen: int, bidirectional: bool, buckets: int,
                max_dist: int, device: torch.device) -> torch.Tensor:
    """``[qlen, klen]`` bucket ids (key ``j`` for query ``i``), computed
    on the host and kept on ``device``."""
    rel = (torch.arange(klen, dtype=torch.int32)[None, :]
           - torch.arange(qlen, dtype=torch.int32)[:, None])
    ids = _rel_bucket(rel, bidirectional=bidirectional, buckets=buckets,
                      max_dist=max_dist)
    return ids.to(torch.int64).to(device)


def _rel_bias(cfg: T5Config, table: torch.Tensor, qlen: int, klen: int, *,
              bidirectional: bool, causal_mask: bool) -> torch.Tensor:
    """``[1, heads, qlen, klen]`` float32 additive score bias (and the
    causal mask)."""
    ids = _bucket_ids(qlen, klen, bidirectional, cfg.rel_buckets,
                      cfg.rel_max_distance, table.device)
    bias = F.embedding(ids, table).permute(2, 0, 1)[None].float()
    if causal_mask:
        ahead = (torch.arange(klen, device=table.device)[None, :]
                 > torch.arange(qlen, device=table.device)[:, None])
        bias = bias + torch.where(ahead, _NEG, 0.0)[None, None]
    return bias


def _attend(cfg: T5Config, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Unscaled dot-product attention over ``[b, s, inner]`` projections:
    scores in the projections' dtype, then float32 (+ bias, softmax),
    the weights cast back for ``P V``."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    nh, hd = cfg.n_heads, cfg.hd
    q = q.reshape(b, sq, nh, hd)
    k = k.reshape(b, sk, nh, hd)
    v = v.reshape(b, sk, nh, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, sq, nh * hd)


class _Attn(_Layer):
    """``wq wk wv wo`` of one attention (T5's init folds the missing
    score scale into ``wq``)."""

    def __init__(self, cfg: T5Config, dev: torch.device):
        super().__init__()
        d, inner = cfg.dim, cfg.inner
        self.cfg = cfg
        for name, shape in (("wq", (d, inner)), ("wk", (d, inner)), ("wv", (d, inner)),
                            ("wo", (inner, d))):
            setattr(self, name, _param(shape, cfg.dtype, dev))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        d, inner, hd = self.cfg.dim, self.cfg.inner, self.cfg.hd
        stds = {"wq": (d * hd) ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5, "wo": inner ** -0.5}
        for name, t in self._parameters.items():
            t.copy_(_normal(gen, t.shape, stds[name], t.dtype, t.device))


class _FF(_Layer):
    """``wi wo`` (v1.0) or ``wi0 wi1 wo`` (gated, v1.1)."""

    def __init__(self, cfg: T5Config, dev: torch.device):
        super().__init__()
        d, dff = cfg.dim, cfg.mlp_hidden
        self.cfg = cfg
        names = ("wi0", "wi1") if cfg.gated_mlp else ("wi",)
        for name in names:
            setattr(self, name, _param((d, dff), cfg.dtype, dev))
        self.wo = _param((dff, d), cfg.dtype, dev)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, t in self._parameters.items():
            t.copy_(_normal(gen, t.shape, t.shape[0] ** -0.5, t.dtype, t.device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        act = _act_fn(self.cfg.act)
        if self.cfg.gated_mlp:
            return (act(h @ self.wi0) * (h @ self.wi1)) @ self.wo
        return act(h @ self.wi) @ self.wo


class _T5Layer(_Layer):
    """A T5 layer: its own leaves plus the ``attn``/``xattn``/``ff``
    children, as the reference's nested param dict."""

    def params(self) -> dict:
        p = dict(self._parameters)
        for name, child in self._modules.items():
            p[name] = child.params()
        return p

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Norms 1, ``table``/``rel`` ~ N(0, 1) (T5's init), then the
        children's projections."""
        for name, t in self._parameters.items():
            if name in ("table", "rel"):
                t.copy_(_normal(gen, t.shape, 1.0, t.dtype, t.device))
            elif name == "w":
                t.copy_(_normal(gen, t.shape, t.shape[0] ** -0.5, t.dtype, t.device))
            else:
                t.fill_(1.0)
        for child in self._modules.values():
            child.reset_parameters(gen)


def _self_attn(cfg: T5Config, layer: Any, x: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    h = _rms(x, layer.ln1, cfg.norm_eps)
    at = layer.attn
    return x + _attend(cfg, h @ at.wq, h @ at.wk, h @ at.wv, bias) @ at.wo


class T5Embed(_T5Layer):
    """``(enc_ids, dec_ids) -> (h_enc, h_dec)`` through the shared
    ``table`` (no output scaling)."""

    def __init__(self, cfg: T5Config, *, device: Device = None):
        super().__init__()
        self.cfg = cfg
        self.table = _param((cfg.vocab, cfg.dim), cfg.dtype, resolve_device(device))

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        enc_ids, dec_ids = x
        return F.embedding(enc_ids, self.table), F.embedding(dec_ids, self.table)


class T5EncBlock(_T5Layer):
    """Pre-norm self-attention with the bucket bias, then the
    feed-forward.  The first block owns the encoder's ``rel`` table and
    appends ``ebias`` to the carrier."""

    def __init__(self, cfg: T5Config, *, first: bool, device: Device = None):
        super().__init__()
        self.cfg, self.first = cfg, first
        dev = resolve_device(device)
        self.ln1 = _param((cfg.dim,), torch.float32, dev)
        self.ln2 = _param((cfg.dim,), torch.float32, dev)
        if first:
            self.rel = _param((cfg.rel_buckets, cfg.n_heads), cfg.dtype, dev)
        self.attn = _Attn(cfg, dev)
        self.ff = _FF(cfg, dev)

    def forward(self, x: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        if self.first:
            h_enc, h_dec = x
            se = h_enc.shape[1]
            ebias = _rel_bias(cfg, self.rel, se, se, bidirectional=True,
                              causal_mask=False)
        else:
            h_enc, h_dec, ebias = x
        h_enc = _self_attn(cfg, self, h_enc, ebias)
        h_enc = h_enc + self.ff(_rms(h_enc, self.ln2, cfg.norm_eps))
        return h_enc, h_dec, ebias


class T5EncFinal(_T5Layer):
    """The encoder's final norm ``ln``; drops ``ebias``."""

    def __init__(self, cfg: T5Config, *, device: Device = None):
        super().__init__()
        self.cfg = cfg
        self.ln = _param((cfg.dim,), torch.float32, resolve_device(device))

    def forward(self, x: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        h_enc, h_dec, _ = x
        return _rms(h_enc, self.ln, self.cfg.norm_eps), h_dec


class T5DecBlock(_T5Layer):
    """Causal self-attention with the bucket bias, cross-attention over
    the encoder output (no bias), then the feed-forward.  The first
    block owns the decoder's ``rel`` table and appends ``dbias``."""

    def __init__(self, cfg: T5Config, *, first: bool, device: Device = None):
        super().__init__()
        self.cfg, self.first = cfg, first
        dev = resolve_device(device)
        for name in ("ln1", "ln2", "ln3"):
            setattr(self, name, _param((cfg.dim,), torch.float32, dev))
        if first:
            self.rel = _param((cfg.rel_buckets, cfg.n_heads), cfg.dtype, dev)
        self.attn = _Attn(cfg, dev)
        self.xattn = _Attn(cfg, dev)
        self.ff = _FF(cfg, dev)

    def forward(self, x: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        if self.first:
            h_enc, h_dec = x
            sd = h_dec.shape[1]
            dbias = _rel_bias(cfg, self.rel, sd, sd, bidirectional=False,
                              causal_mask=True)
        else:
            h_enc, h_dec, dbias = x
        h_dec = _self_attn(cfg, self, h_dec, dbias)
        h = _rms(h_dec, self.ln2, cfg.norm_eps)
        xa = self.xattn
        h_dec = h_dec + _attend(cfg, h @ xa.wq, h_enc @ xa.wk, h_enc @ xa.wv, None) @ xa.wo
        h_dec = h_dec + self.ff(_rms(h_dec, self.ln3, cfg.norm_eps))
        return h_enc, h_dec, dbias


class T5Final(_T5Layer):
    """The decoder's final norm ``ln`` and the head ``w`` (the
    ``dim^-1/2`` rescale first when the config is tied)."""

    def __init__(self, cfg: T5Config, *, device: Device = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.ln = _param((cfg.dim,), torch.float32, dev)
        self.w = _param((cfg.dim, cfg.vocab), cfg.dtype, dev)

    def head(self, h_dec: torch.Tensor) -> torch.Tensor:
        h = _rms(h_dec, self.ln, self.cfg.norm_eps)
        if self.cfg.logit_scale is not None:
            h = h * self.cfg.logit_scale
        return h @ self.w

    def forward(self, x: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return self.head(x[1])


def t5_layers(cfg: T5Config, *, device: Device = None,
              generator: Optional[torch.Generator] = None) -> List[nn.Module]:
    """The encoder-decoder as a flat layer list (``n_enc_layers +
    n_dec_layers + 3`` layers, cut anywhere), on ``device`` (``cuda``
    unless named), drawn from ``generator`` (seeded 0 when omitted).
    Input ``(enc_ids [b, se], dec_ids [b, sd])`` int; output ``[b, sd,
    vocab]`` logits."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    layers: List[nn.Module] = [T5Embed(cfg, device=dev)]
    layers += [T5EncBlock(cfg, first=i == 0, device=dev) for i in range(cfg.n_enc_layers)]
    layers.append(T5EncFinal(cfg, device=dev))
    layers += [T5DecBlock(cfg, first=i == 0, device=dev) for i in range(cfg.n_dec_layers)]
    layers.append(T5Final(cfg, device=dev))
    return [_init(layer, generator) for layer in layers]


# --------------------------------------------------------------------- #
# inference: the encoder once, then a KV-cached decoder loop            #
# --------------------------------------------------------------------- #


def _split(cfg: T5Config, model: Sequence[Any]) -> Tuple:
    layers = list(model)
    ne, nd = cfg.n_enc_layers, cfg.n_dec_layers
    if len(layers) != ne + nd + 3:
        raise ValueError(
            f"expected {ne + nd + 3} layers (embed, {ne} encoder blocks, "
            f"enc_final, {nd} decoder blocks, final), got {len(layers)}; "
            "build the model with models.t5.t5_layers(cfg)"
        )
    return layers[0], layers[1:1 + ne], layers[1 + ne], layers[2 + ne:2 + ne + nd], \
        layers[-1]


def _encode(cfg: T5Config, model: Sequence[Any], enc_ids: torch.Tensor) -> torch.Tensor:
    embed, enc, enc_final, _, _ = _split(cfg, model)
    h = F.embedding(enc_ids, embed.table)
    se = h.shape[1]
    ebias = _rel_bias(cfg, enc[0].rel, se, se, bidirectional=True, causal_mask=False)
    for blk in enc:
        h = _self_attn(cfg, blk, h, ebias)
        h = h + blk.ff(_rms(h, blk.ln2, cfg.norm_eps))
    return _rms(h, enc_final.ln, cfg.norm_eps)


@torch.inference_mode()
def t5_encode(cfg: T5Config, model: Sequence[Any], enc_ids: Any, *,
              device: Device = None) -> torch.Tensor:
    """Encoder-only forward: ``[b, se]`` ids -> ``[b, se, dim]``."""
    dev = _model_device(model, device)
    return _encode(cfg, model, torch.as_tensor(enc_ids, device=dev))


@torch.inference_mode()
def t5_generate(
    cfg: T5Config, model: Sequence[Any], enc_ids: Any, max_new_tokens: int, *,
    temperature: float = 0.0, top_k: Optional[int] = None,
    top_p: Optional[float] = None, eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None, device: Device = None,
) -> torch.Tensor:
    """Seq2seq decode: the encoder once, each decoder layer's cross K/V
    once from its output, then one token a step through a self-attention
    cache.  Returns int64 ``[b, max_new_tokens]``; with ``eos_id``,
    finished rows keep emitting it.  ``temperature=0`` is greedy;
    otherwise pass ``generator`` (the filters of ``models.generation``).
    The reference's ``lax.scan`` over steps is a Python loop over the
    same body; every step's bias row is the reference's (its queries at
    position ``i`` over all ``max_new_tokens`` key slots, later slots
    masked)."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling needs generator=torch.Generator")
    dev = _model_device(model, device)
    enc_ids = torch.as_tensor(enc_ids, device=dev)
    embed, _, _, dec, final = _split(cfg, model)
    h_enc = _encode(cfg, model, enc_ids)
    b, total = enc_ids.shape[0], int(max_new_tokens)
    cross = [(h_enc @ blk.xattn.wk, h_enc @ blk.xattn.wv) for blk in dec]
    cdt = embed.table.dtype
    ks = [torch.zeros((b, total, cfg.inner), dtype=cdt, device=dev) for _ in dec]
    vs = [torch.zeros_like(t) for t in ks]
    tok = torch.full((b,), cfg.decoder_start_id, dtype=torch.int64, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    # Row i is step i's bias: query i over all the key slots.
    biases = _rel_bias(cfg, dec[0].rel, total, total, bidirectional=False,
                       causal_mask=True)
    out = []
    for i in range(total):
        x = F.embedding(tok, embed.table)[:, None, :]
        bias = biases[:, :, i:i + 1]
        for li, blk in enumerate(dec):
            h = _rms(x, blk.ln1, cfg.norm_eps)
            at = blk.attn
            ks[li][:, i:i + 1] = (h @ at.wk).to(cdt)
            vs[li][:, i:i + 1] = (h @ at.wv).to(cdt)
            x = x + _attend(cfg, h @ at.wq, ks[li], vs[li], bias) @ at.wo
            h = _rms(x, blk.ln2, cfg.norm_eps)
            ck, cv = cross[li]
            x = x + _attend(cfg, h @ blk.xattn.wq, ck, cv, None) @ blk.xattn.wo
            x = x + blk.ff(_rms(x, blk.ln3, cfg.norm_eps))
        logits = final.head(x)[:, 0]
        nxt = _sample(logits.float() if temperature > 0.0 else logits, generator,
                      temperature, top_k, top_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    if not out:
        return torch.zeros((b, 0), dtype=torch.int64, device=dev)
    return torch.stack(out, dim=1)


def t5_shift_right(cfg: T5Config, labels: torch.Tensor) -> torch.Tensor:
    """Teacher forcing's decoder input: ``decoder_start_id`` prepended,
    the last label dropped (HF ``_shift_right``)."""
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_id, dtype=labels.dtype,
                       device=labels.device)
    return torch.cat([start, labels[:, :-1]], dim=1)
