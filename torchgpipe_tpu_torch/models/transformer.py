"""Llama-style transformer as ``nn.Module``s over the JAX parameter schema.

Counterpart of ``torchgpipe_tpu/models/transformer.py``.  Parameter names
are the JAX keys (``table``; ``ln1 wq wk wv wo ln2 w_gate w_up w_down``;
``scale w``) and weight layouts stay ``[in, out]`` (``x @ w``), so a
checkpoint converts leaf by leaf (``convert.params_from_jax``).  Norm
scales are float32 parameters, as ``jnp.ones`` makes them in the
reference; projection weights take ``cfg.dtype``.

:func:`llama` returns an ``nn.Sequential`` of ``[embed, block_0 ..
block_{n-1}, head]``, the flat per-layer list the JAX engines and
``models.generation`` consume.  The per-block prologue/epilogue helpers
(:func:`_block_qkv`, :func:`_block_attn_out`, :func:`_mlp_out`) live here
so the block's own forward and every generation path share one body;
``models.generation`` re-exports them under the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.ops.flash_attention import flash_attention

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  With no card and no ``device=``, raise: the port
    never drops to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature this port does not have yet,
    naming the ROADMAP.md queue item that will bring it."""
    return NotImplementedError(
        f"{what} is not ported to torchgpipe_tpu_torch yet "
        f"(ROADMAP.md, queue A item {item})"
    )


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field-for-field copy of the reference config (``dtype`` is a
    ``torch.dtype``).  Knobs the port does not serve yet are kept so a
    reference config transcribes unchanged; :meth:`check_ported` raises
    on them."""

    vocab: int = 32000
    dim: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: Optional[int] = None
    mlp_ratio: float = 4.0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    sp_axis: Optional[str] = None
    sp_impl: str = "ring"
    attn_window: Optional[int] = None
    tp_axis: Optional[str] = None
    attn_bias: bool = False
    qk_norm: bool = False
    n_head_dim: Optional[int] = None
    act: str = "silu"
    norm: str = "rms"
    pos_emb: str = "rope"
    max_pos: Optional[int] = None
    pos_emb_offset: int = 0
    mlp_impl: str = "gated"
    attn_out_bias: bool = False
    parallel_residual: bool = False
    causal: bool = True
    norm_position: str = "pre"
    embed_layernorm: bool = False
    rope_pct: float = 1.0
    embed_scale: Optional[float] = None
    lora_rank: Optional[int] = None
    lora_alpha: float = 16.0
    tie_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.n_head_dim or self.dim // self.n_heads

    @property
    def mlp_hidden(self) -> int:
        if self.mlp_impl == "classic":
            return int(round(self.mlp_ratio * self.dim))
        h = int(2 * self.mlp_ratio * self.dim / 3)
        return max(128, ((h + 127) // 128) * 128)

    def validate_arch(self) -> None:
        """The reference's checks on knob values (``validate_arch``)."""
        if self.norm not in ("rms", "layernorm"):
            raise ValueError(f"norm={self.norm!r}: expected 'rms' or 'layernorm'")
        if self.pos_emb not in ("rope", "learned"):
            raise ValueError(f"pos_emb={self.pos_emb!r}: expected 'rope' or 'learned'")
        if self.mlp_impl not in ("gated", "classic"):
            raise ValueError(
                f"mlp_impl={self.mlp_impl!r}: expected 'gated' or 'classic'"
            )
        if self.norm_position not in ("pre", "post"):
            raise ValueError(
                f"norm_position={self.norm_position!r}: expected 'pre' or 'post'"
            )
        if not 0.0 < self.rope_pct <= 1.0:
            raise ValueError(f"rope_pct={self.rope_pct} must be in (0, 1]")
        if self.rope_pct < 1.0 and int(self.head_dim * self.rope_pct) % 2:
            raise ValueError(
                f"rope_pct={self.rope_pct} rotates "
                f"{int(self.head_dim * self.rope_pct)} of {self.head_dim} "
                "head dims; the rotated count must be even (half-split rotary)"
            )
        _act_fn(self.act)

    def check_ported(self) -> None:
        """Raise on knobs whose reference feature is not ported yet."""
        self.validate_arch()
        if self.tp_axis is not None or self.sp_axis is not None:
            raise not_ported("tensor/sequence parallelism (tp_axis, sp_axis)", "5")
        if self.lora_rank:
            raise not_ported("LoRA adapters (lora_rank)", "2")
        if self.tie_embeddings:
            raise not_ported("tied embeddings (tie_embeddings)", "5")
        if self.pos_emb != "rope":
            raise not_ported("learned position tables (pos_emb='learned')", "5")
        if self.norm_position != "pre" or self.embed_layernorm:
            raise not_ported("post-norm / embedding-LayerNorm encoders", "5")


def _normal(
    gen: torch.Generator, shape: Tuple[int, ...], std: float,
    dtype: torch.dtype, device: torch.device,
) -> torch.Tensor:
    """``std * N(0, 1)`` drawn in float32 then cast, as the reference's
    ``_normal`` does."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def _norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float,
    bias: Optional[torch.Tensor] = None, centered: bool = False,
) -> torch.Tensor:
    """Trailing-dim RMS (or, ``centered``, Layer) norm.  Cast order as in
    the reference: variance in float32, then ``x * rsqrt(var + eps)`` in
    ``x.dtype``, then ``* scale`` cast to ``x.dtype``."""
    xf = x.float()
    if centered:
        xf = xf - xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True)
    y = xf.to(x.dtype) if centered else x
    y = y * torch.rsqrt(var + eps).to(x.dtype)
    y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return _norm(x, scale, eps)


def _block_norm(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], key: str,
    x: torch.Tensor,
) -> torch.Tensor:
    """The configured norm at param ``key`` (``ln1``/``ln2``/head
    ``scale``), with its LayerNorm bias when present."""
    bkey = "bias" if key == "scale" else key + "b"
    return _norm(
        x, p[key], cfg.norm_eps, bias=p.get(bkey),
        centered=cfg.norm == "layernorm",
    )


def _act_fn(act: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if act == "silu":
        return F.silu
    if act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if act == "gelu":
        return F.gelu
    if act == "relu":
        return F.relu
    raise ValueError(
        f"unknown act {act!r}: expected 'silu', 'gelu_tanh', 'gelu', or 'relu'"
    )


def _rope(x: torch.Tensor, theta: float, pos_offset: Any = 0) -> torch.Tensor:
    """Half-split rotary embedding over the trailing head dim of
    ``x: [b, s, heads, head_dim]``.  ``pos_offset`` is a scalar (shared
    base position), ``[b]`` (one base per row) or ``[b, s]`` (absolute
    per-token positions).  Frequencies and angles in float32."""
    b, s, h, d = x.shape
    half = d // 2
    dev = x.device
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    )
    steps = torch.arange(s, dtype=torch.float32, device=dev)
    if isinstance(pos_offset, (int, float)):
        # No host-to-device copy of the offset: a captured CUDA graph
        # (GPipe(fused=True)) may not make one.
        positions = (steps + pos_offset)[None]
    else:
        off = torch.as_tensor(pos_offset, dtype=torch.float32, device=dev)
        positions = off if off.ndim == 2 else off.reshape(-1, 1) + steps
    ang = positions[..., None] * freqs          # [B', s, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _maybe_rope(
    cfg: TransformerConfig, x: torch.Tensor, pos_offset: Any
) -> torch.Tensor:
    """Full, partial (``rope_pct < 1``) or no rotary, per the config."""
    if cfg.pos_emb != "rope":
        return x
    if cfg.rope_pct >= 1.0:
        return _rope(x, cfg.rope_theta, pos_offset)
    rot = int(x.shape[-1] * cfg.rope_pct)
    return torch.cat(
        [_rope(x[..., :rot], cfg.rope_theta, pos_offset), x[..., rot:]], dim=-1
    )


# --------------------------------------------------------------------- #
# shared per-block body (training forward, prefill and decode)          #
# --------------------------------------------------------------------- #


def _embed(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], tokens: torch.Tensor
) -> torch.Tensor:
    """Token lookup with the optional ``embed_scale`` (learned position
    tables, which would need the position, are refused by
    ``TransformerConfig.check_ported``).  ``F.embedding``'s backward
    sums each row's gradients in a fixed order on the card (advanced
    indexing's adds with atomics, in any order), so a training step
    repeats bit for bit."""
    x = F.embedding(tokens, p["table"])
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    return x


def _block_qkv(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor,
    pos: Any,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln1, q/k/v projections (+ Qwen2 biases), head reshape, Qwen3
    per-head q/k RMSNorm, rotary at ``pos``.  ``x: [b, g, dim]``."""
    b, g, _ = x.shape
    hd = cfg.head_dim
    h = _block_norm(cfg, p, "ln1", x)
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, g, -1, hd)
    k = k.reshape(b, g, -1, hd)
    v = v.reshape(b, g, -1, hd)
    if "qn" in p:
        q = _rms(q, p["qn"], cfg.norm_eps)
        k = _rms(k, p["kn"], cfg.norm_eps)
    return _maybe_rope(cfg, q, pos), _maybe_rope(cfg, k, pos), v


def _mlp_out(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], h: torch.Tensor
) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or classic (fc -> act -> proj) feed-forward."""
    if "w_fc" in p:
        hid = _act_fn(cfg.act)(h @ p["w_fc"] + p["b_fc"])
        return hid @ p["w_proj"] + p["b_proj"]
    gate = _act_fn(cfg.act)(h @ p["w_gate"])
    return (gate * (h @ p["w_up"])) @ p["w_down"]


def _block_attn_out(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """wo projection (+ bias), attention residual, ln2 (parallel or
    sequential residual), MLP residual.  ``attn: [b, g, nh*hd]``."""
    attn = attn.to(x.dtype)
    o = attn @ p["wo"]
    if "bo" in p:
        o = o + p["bo"]
    h = _block_norm(cfg, p, "ln2", x if cfg.parallel_residual else x + o)
    return x + o + _mlp_out(cfg, p, h)


# --------------------------------------------------------------------- #
# modules                                                               #
# --------------------------------------------------------------------- #


def _param(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device):
    """A trainable parameter (generation runs under ``inference_mode``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class _Layer(nn.Module):
    """A layer whose parameters are its own direct attributes, named by
    the reference's param keys; :meth:`params` is that dict."""

    def params(self) -> dict:
        return dict(self._parameters)


class TokenEmbedding(_Layer):
    """Token lookup ``table[tokens]`` with optional ``embed_scale``."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.table = _param((cfg.vocab, cfg.dim), cfg.dtype, resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.table.copy_(
            _normal(gen, self.table.shape, 0.02, self.cfg.dtype, self.table.device)
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _embed(self.cfg, self.params(), tokens)


class TransformerBlock(_Layer):
    """One pre-norm block: ``x + attn(norm(x))``; ``x + mlp(norm(x))``.
    Attention goes through ``ops.flash_attention`` (the CUDA kernel on
    the card, its plain version on the CPU)."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = resolve_device(device)
        dim, hd, dt = cfg.dim, cfg.head_dim, cfg.dtype
        nh, nkv, hidden = cfg.n_heads, cfg.kv_heads, cfg.mlp_hidden
        f32 = torch.float32
        shapes = {
            "ln1": ((dim,), f32),
            "wq": ((dim, nh * hd), dt),
            "wk": ((dim, nkv * hd), dt),
            "wv": ((dim, nkv * hd), dt),
            "wo": ((nh * hd, dim), dt),
            "ln2": ((dim,), f32),
        }
        if cfg.norm == "layernorm":
            shapes.update(ln1b=((dim,), f32), ln2b=((dim,), f32))
        if cfg.attn_out_bias:
            shapes["bo"] = ((dim,), dt)
        if cfg.attn_bias:
            shapes.update(
                bq=((nh * hd,), dt), bk=((nkv * hd,), dt), bv=((nkv * hd,), dt)
            )
        if cfg.qk_norm:
            shapes.update(qn=((hd,), f32), kn=((hd,), f32))
        if cfg.mlp_impl == "classic":
            shapes.update(
                w_fc=((dim, hidden), dt), b_fc=((hidden,), dt),
                w_proj=((hidden, dim), dt), b_proj=((dim,), dt),
            )
        else:
            shapes.update(
                w_gate=((dim, hidden), dt), w_up=((dim, hidden), dt),
                w_down=((hidden, dim), dt),
            )
        for name, (shape, dtype) in shapes.items():
            setattr(self, name, _param(shape, dtype, dev))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Same distributions as the reference init: N(0, dim^-1/2)
        projections (``w_down``/``w_proj``: hidden^-1/2), unit norm
        scales, zero biases."""
        cfg = self.cfg
        std, hstd = cfg.dim ** -0.5, cfg.mlp_hidden ** -0.5
        for name, t in self._parameters.items():
            if name in ("ln1", "ln2", "qn", "kn"):
                t.fill_(1.0)
            elif t.ndim == 1:
                t.zero_()
            else:
                s = hstd if name in ("w_down", "w_proj") else std
                t.copy_(_normal(gen, t.shape, s, t.dtype, t.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        b, s, _ = x.shape
        q, k, v = _block_qkv(cfg, p, x, 0)
        attn = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=cfg.causal, window=cfg.attn_window,
        )
        return _block_attn_out(cfg, p, x, attn.reshape(b, s, -1))


class LMHead(_Layer):
    """Final norm + vocabulary projection (float32 logits are the
    generation path's job; the forward returns ``x.dtype``)."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = resolve_device(device)
        self.scale = _param((cfg.dim,), torch.float32, dev)
        if cfg.norm == "layernorm":
            self.bias = _param((cfg.dim,), torch.float32, dev)
        self.w = _param((cfg.dim, cfg.vocab), cfg.dtype, dev)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        if "bias" in self._parameters:
            self.bias.zero_()
        self.w.copy_(
            _normal(gen, self.w.shape, self.cfg.dim ** -0.5, self.w.dtype,
                    self.w.device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params()
        return _block_norm(self.cfg, p, "scale", x) @ p["w"]


class Llama(nn.Sequential):
    """``[embed, block_0 .. block_{n-1}, head]``, the reference's flat
    ``llama(cfg)`` layer list as one ``nn.Sequential``."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None):
        dev = resolve_device(device)
        super().__init__(
            TokenEmbedding(cfg, device=dev),
            *[TransformerBlock(cfg, device=dev) for _ in range(cfg.n_layers)],
            LMHead(cfg, device=dev),
        )
        self.cfg = cfg

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in self:
            layer.reset_parameters(gen)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy at aligned positions, as the reference's
    ``cross_entropy``: float32 log-softmax over ``logits [b, s, v]``, int
    ``labels [b, s]``.  For a causal-LM objective pass pre-shifted arrays
    (logits of ``tokens[:, :-1]``, ``labels = tokens[:, 1:]``); this
    function does not shift."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -ll.mean()


def token_embedding(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> TokenEmbedding:
    return _init(TokenEmbedding(cfg, device=device), generator)


def transformer_block(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None, mlp: Any = None,
) -> TransformerBlock:
    if mlp is not None:
        raise not_ported("custom / MoE feed-forward blocks (mlp=)", "5")
    return _init(TransformerBlock(cfg, device=device), generator)


def lm_head(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> LMHead:
    return _init(LMHead(cfg, device=device), generator)


def llama(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> Llama:
    """The flat Llama as an ``nn.Sequential`` on ``device`` (``cuda``
    unless named), initialised from ``generator`` (a fresh one seeded 0
    on that device when omitted)."""
    return _init(Llama(cfg, device=device), generator)


def _init(layer: nn.Module, gen: Optional[torch.Generator]) -> Any:
    if gen is None:
        dev = next(layer.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(0)
    layer.reset_parameters(gen)
    return layer
