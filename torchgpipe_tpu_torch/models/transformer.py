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

LoRA (``cfg.lora_rank``): each block holds adapters ``A``/``B`` on
q/k/v/o in a ``lora`` submodule (``B`` zero, so a fresh model computes
the base model), applied in that shared body.  Sequence packing: the
embedding takes the packer's dict ``{"tokens", "segment_ids",
"positions"}`` and emits the tuple ``(hidden, segment_ids, positions)``,
which every block carries (rotary at the per-token positions, attention
masked to segment ∧ causal through :func:`segment_attention`, the
reference's dense path: its flash kernel has no segment mask) until the
head takes the hidden plane.  :func:`chunked_lm_loss` is the parametric
loss that owns the final norm and head of ``llama(cfg, head=False)``.

The GPT-2/BERT knobs: learned positions (``pos`` rows added at the
embedding, at each token's position), the embedding LayerNorm
(``eln``/``elnb``), post-norm blocks (LayerNorm of each residual sum)
and tied embeddings (:func:`llama_tied`: the head holds the embedding's
``table``; :func:`llama` refuses the tie, as the reference's does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.models.quant import QuantWeight, dequantize_weight, refuse_quantized
from torchgpipe_tpu_torch.ops.flash_attention import _validate_window, attention
from torchgpipe_tpu_torch.ops.losses import chunked_softmax_xent

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
        if self.pos_emb == "learned" and not self.max_pos:
            raise ValueError(
                "pos_emb='learned' needs max_pos (the position table "
                "size — HF GPT2Config.n_positions)"
            )
        if self.norm_position not in ("pre", "post"):
            raise ValueError(
                f"norm_position={self.norm_position!r}: expected 'pre' or 'post'"
            )
        if self.norm_position == "post" and self.parallel_residual:
            raise ValueError(
                "norm_position='post' and parallel_residual do not "
                "compose (no published family; the parallel form is "
                "defined on pre-norm branches)"
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


def _lora_delta(
    cfg: TransformerConfig, lo: Mapping[str, torch.Tensor], x: torch.Tensor,
    a: str, b: str,
) -> torch.Tensor:
    """One adapter's contribution ``(x @ A) @ B * alpha / rank``, shared
    by the training block and the generation prefill/decode paths."""
    return ((x @ lo[a]) @ lo[b]) * (cfg.lora_alpha / cfg.lora_rank)


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
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
    pos0: Any = 0,
) -> torch.Tensor:
    """Token lookup with the optional ``embed_scale``, the learned
    position rows (``p["pos"]``, GPT-2 class) and the embedding LayerNorm
    (``eln``/``elnb``, BERT class).  Position row of token ``j`` is
    ``pos_emb_offset + pos0 + j`` for a host int ``pos0`` (decode passes
    the cache length), ``pos_emb_offset + pos0[i] + j`` for a ``[b]``
    tensor (one frontier per row, the slot decode), and
    ``pos_emb_offset + pos0[i, j]`` for a ``[b, s]`` tensor (a packed
    batch's within-document positions).  ``F.embedding``'s backward
    sums each row's gradients in a fixed order on the card (advanced
    indexing's adds with atomics, in any order), so a training step
    repeats bit for bit."""
    x = F.embedding(tokens, p["table"])
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    if "pos" in p:
        s, off = tokens.shape[-1], cfg.pos_emb_offset
        if isinstance(pos0, int):
            # No host-to-device copy: a captured CUDA graph may not make one.
            idx = torch.arange(off + pos0, off + pos0 + s, device=x.device)
        elif pos0.ndim == 1:
            idx = off + pos0[:, None] + torch.arange(s, device=x.device)
        else:
            idx = off + pos0
        # Rows past the table clamp to its last, as the reference's gather
        # does; every entry point checks the bound first (only speculative
        # decoding's rolled-back rows past the decode's end reach it).
        x = x + F.embedding(idx.clamp_max(cfg.max_pos - 1), p["pos"]).to(x.dtype)
    if "eln" in p:
        x = _norm(x, p["eln"], cfg.norm_eps, bias=p["elnb"], centered=True)
    return x


def _w(cfg: TransformerConfig, p: Mapping[str, Any], key: str) -> torch.Tensor:
    """Weight read-site accessor (the reference's ``_w``): a plain
    tensor passes through; a weight-only int8 leaf (``models.quant``)
    dequantizes to ``cfg.dtype`` here, so every path that reads weights
    through the shared body below takes quantized weights.  (A decode
    step asks this of every weight: the plain case is one type check.)"""
    v = p[key]
    return dequantize_weight(v, cfg.dtype) if isinstance(v, dict) else v


def _block_qkv(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor,
    pos: Any,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln1 (pre-norm only), q/k/v projections (+ Qwen2 biases), head
    reshape, Qwen3 per-head q/k RMSNorm, rotary at ``pos``.
    ``x: [b, g, dim]``."""
    b, g, _ = x.shape
    hd = cfg.head_dim
    # Post-norm (BERT class): the attention branch reads x raw; ln1
    # normalizes the residual sum in _block_attn_out instead.
    h = x if cfg.norm_position == "post" else _block_norm(cfg, p, "ln1", x)
    q, k, v = h @ _w(cfg, p, "wq"), h @ _w(cfg, p, "wk"), h @ _w(cfg, p, "wv")
    if "lora" in p:
        lo = p["lora"]
        q = q + _lora_delta(cfg, lo, h, "qa", "qb")
        k = k + _lora_delta(cfg, lo, h, "ka", "kb")
        v = v + _lora_delta(cfg, lo, h, "va", "vb")
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, g, -1, hd)
    k = k.reshape(b, g, -1, hd)
    v = v.reshape(b, g, -1, hd)
    if "qn" in p:
        q = _rms(q, p["qn"], cfg.norm_eps)
        k = _rms(k, p["kn"], cfg.norm_eps)
    return _maybe_rope(cfg, q, pos), _maybe_rope(cfg, k, pos), v


MlpFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _mlp_out(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], h: torch.Tensor,
    mlp: Optional[MlpFn] = None,
) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or classic (fc -> act -> proj) feed-forward,
    or, for a block whose params carry ``"mlp"`` (a custom feed-forward,
    the MoE family), ``mlp(p["mlp"], h)``."""
    if "mlp" in p:
        if mlp is None:
            raise ValueError(
                "these block params carry an 'mlp' feed-forward (MoE "
                "family); pass moe=MoEConfig(...) matching the training "
                "configuration to prefill()/generate()"
            )
        return mlp(p["mlp"], h).to(h.dtype)
    if "w_fc" in p:
        hid = _act_fn(cfg.act)(h @ _w(cfg, p, "w_fc") + p["b_fc"])
        return hid @ _w(cfg, p, "w_proj") + p["b_proj"]
    gate = _act_fn(cfg.act)(h @ _w(cfg, p, "w_gate"))
    return (gate * (h @ _w(cfg, p, "w_up"))) @ _w(cfg, p, "w_down")


def _block_attn_out(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor,
    attn: torch.Tensor, mlp: Optional[MlpFn] = None,
) -> torch.Tensor:
    """wo projection (+ bias), attention residual, ln2 (parallel or
    sequential residual), MLP residual (``mlp`` for a block with an
    ``"mlp"`` feed-forward); post-norm: ``ln1(x + o)``, then ``ln2`` of
    the MLP's residual sum.  ``attn: [b, g, nh*hd]``."""
    attn = attn.to(x.dtype)
    o = attn @ _w(cfg, p, "wo")
    if "lora" in p:
        o = o + _lora_delta(cfg, p["lora"], attn, "oa", "ob")
    if "bo" in p:
        o = o + p["bo"]
    if cfg.norm_position == "post":
        x = _block_norm(cfg, p, "ln1", x + o)
        return _block_norm(cfg, p, "ln2", x + _mlp_out(cfg, p, x, mlp))
    h = _block_norm(cfg, p, "ln2", x if cfg.parallel_residual else x + o)
    return x + o + _mlp_out(cfg, p, h, mlp)


# --------------------------------------------------------------------- #
# sequence packing                                                      #
# --------------------------------------------------------------------- #


def _is_packed_batch(x: Any) -> bool:
    """A raw packed input batch (the packer's dict)."""
    return isinstance(x, dict) and "tokens" in x and "segment_ids" in x


def _is_packed_act(x: Any) -> bool:
    """A packed activation between layers: ``(hidden, seg, pos)``."""
    return isinstance(x, tuple) and len(x) == 3


def _refuse_packed_sp(cfg: TransformerConfig, what: str) -> None:
    """The reference's refusal of a packed batch under a sequence-parallel
    axis (``sp_axis`` is not ported: a config that names one is refused
    at construction, so this guards a config swapped in afterwards)."""
    if cfg.sp_axis is not None:
        raise ValueError(
            f"{what} do not compose with a bound sequence-parallel axis; "
            "drop cfg.sp_axis for packed training"
        )


def segment_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense attention with the sequence-packing mask, the reference's
    ``full_attention(..., seg=)``: position ``i`` attends ``j`` only when
    ``seg[i] == seg[j]`` (and ``j <= i`` when causal, within ``window``).
    ``q: [b, s, h, d]``, ``k, v: [b, s, g, d]``, ``seg: [b, s]`` int.
    Scores and softmax in float32, masked with -1e30 (a row with no
    allowed key softens to uniform and stays finite), the weights cast to
    ``v``'s dtype for ``P V``; returns ``q.dtype``.  No flash kernel: the
    reference's packed path is dense too."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    sm_scale = d ** -0.5 if sm_scale is None else sm_scale
    _validate_window(causal, window)
    qg = q.reshape(b, sq, g, h // g, d).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * sm_scale
    mask = seg[:, :, None] == seg[:, None, :]                  # [b, sq, sk]
    if causal:
        diff = torch.arange(sq, device=q.device)[:, None] - \
            torch.arange(sk, device=q.device)[None, :]
        band = diff >= 0
        if window is not None:
            band = band & (diff < window)
        mask = mask & band
    scores = torch.where(mask[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------- #
# modules                                                               #
# --------------------------------------------------------------------- #


def _param(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device):
    """A trainable parameter (generation runs under ``inference_mode``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class _Layer(nn.Module):
    """A layer whose parameters are its own direct attributes, named by
    the reference's param keys; :meth:`params` is that dict (a weight
    that ``models.quant`` stored int8 shows as its ``{"q8", "sc"}``
    leaf)."""

    def params(self) -> dict:
        p = dict(self._parameters)
        for name, m in self._modules.items():
            if isinstance(m, QuantWeight):
                p[name] = m.leaf()
        return p


class LoRA(_Layer):
    """A block's adapters: ``A`` (``qa``/``ka``/``va``/``oa``) and ``B``
    (``qb``/``kb``/``vb``/``ob``) factors on the q/k/v/o projections, in
    ``cfg.dtype``, the reference's ``"lora"`` subdict."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        r, dim, hd, dt = cfg.lora_rank, cfg.dim, cfg.head_dim, cfg.dtype
        nh, nkv = cfg.n_heads, cfg.kv_heads
        shapes = {"qa": (dim, r), "qb": (r, nh * hd), "ka": (dim, r),
                  "kb": (r, nkv * hd), "va": (dim, r), "vb": (r, nkv * hd),
                  "oa": (nh * hd, r), "ob": (r, dim)}
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, dt, device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, std: float) -> None:
        """``A ~ N(0, std)``, ``B = 0``: the delta starts at zero."""
        for name, t in self._parameters.items():
            if name.endswith("a"):
                t.copy_(_normal(gen, t.shape, std, t.dtype, t.device))
            else:
                t.zero_()


class TokenEmbedding(_Layer):
    """Token lookup ``table[tokens]`` with optional ``embed_scale``, the
    learned position table ``pos`` (``pos_emb='learned'``) and the
    embedding LayerNorm ``eln``/``elnb`` (``embed_layernorm``)."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = resolve_device(device)
        self.table = _param((cfg.vocab, cfg.dim), cfg.dtype, dev)
        if cfg.pos_emb == "learned":
            self.pos = _param((cfg.max_pos, cfg.dim), cfg.dtype, dev)
        if cfg.embed_layernorm:
            self.eln = _param((cfg.dim,), torch.float32, dev)
            self.elnb = _param((cfg.dim,), torch.float32, dev)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """``N(0, 0.02)`` tables (token, then position), unit ``eln``,
        zero ``elnb``, as the reference draws them."""
        for name in ("table", "pos"):
            if name in self._parameters:
                t = self._parameters[name]
                t.copy_(_normal(gen, t.shape, 0.02, t.dtype, t.device))
        if "eln" in self._parameters:
            self.eln.fill_(1.0)
            self.elnb.zero_()

    def _check_len(self, s: int, packed: bool) -> None:
        """The reference's guard: a gather past the learned table would
        read clamped rows under jit (here, fail on the card)."""
        cfg = self.cfg
        if "pos" not in self._parameters or s + cfg.pos_emb_offset <= cfg.max_pos:
            return
        if packed:
            raise ValueError(
                f"packed block length {s} + pos_emb_offset "
                f"{cfg.pos_emb_offset} exceeds the learned position "
                f"table (max_pos={cfg.max_pos} rows): a document "
                "filling its block would read clamped rows — pack "
                "with block_len <= max_pos - pos_emb_offset"
            )
        raise ValueError(
            f"sequence length {s} + pos_emb_offset "
            f"{cfg.pos_emb_offset} exceeds the learned position "
            f"table (max_pos={cfg.max_pos} rows)"
        )

    def forward(self, tokens: Any) -> Any:
        """Token ids ``[b, s]`` to ``[b, s, dim]``; a packed batch dict to
        the packed activation ``(hidden, segment_ids, positions)``."""
        if not _is_packed_batch(tokens):
            self._check_len(tokens.shape[-1], False)
            return _embed(self.cfg, self.params(), tokens)
        seg, pos = tokens["segment_ids"], tokens.get("positions")
        if pos is None:
            raise ValueError(
                "packed batch is missing 'positions' (per-token "
                "within-document positions); build batches with "
                "utils.data.pack_documents/packed_batches"
            )
        _refuse_packed_sp(self.cfg, "packed batches")
        ids = tokens["tokens"]
        self._check_len(ids.shape[-1], True)
        return _embed(self.cfg, self.params(), ids, pos), seg, pos


class TransformerBlock(_Layer):
    """One pre-norm block: ``x + attn(norm(x))``; ``x + mlp(norm(x))``.
    Attention goes through ``ops.flash_attention.attention`` (on the
    card: the CUDA kernel, the kernel at a zero-padded head dim, or the
    float32 kernel, as ``attention_route`` routes it; the plain version
    on the CPU).

    ``mlp`` (an ``nn.Module`` mapping the normalised hidden states
    ``[b, s, dim]`` to ``[b, s, dim]``, such as ``models.moe.moe_mlp``)
    replaces the dense feed-forward: the block holds it as ``self.mlp``,
    its params under the ``"mlp"`` key, and it must be stateless (no
    buffers), as in the reference."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None,
                 mlp: Optional[nn.Module] = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = resolve_device(device)
        if mlp is not None and list(mlp.buffers()):
            raise ValueError(
                f"transformer_block mlp {getattr(mlp, 'name', type(mlp).__name__)!r} "
                "must be stateless"
            )
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
        if mlp is not None:
            pass
        elif cfg.mlp_impl == "classic":
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
        if cfg.lora_rank:
            self.lora = LoRA(cfg, dev)
        if mlp is not None:
            self.mlp = mlp

    def params(self) -> dict:
        """The reference's param dict: the block's own leaves, the
        adapters under ``"lora"``, a custom feed-forward's under
        ``"mlp"``."""
        p = super().params()
        if "lora" in self._modules:
            p["lora"] = self.lora.params()
        if "mlp" in self._modules:
            m = self.mlp
            p["mlp"] = m.params() if hasattr(m, "params") else dict(m.named_parameters())
        return p

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Same distributions as the reference init: N(0, dim^-1/2)
        projections (``w_down``/``w_proj``: hidden^-1/2), unit norm
        scales, zero biases; adapters ``A ~ N(0, dim^-1/2)``, ``B = 0``."""
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
        if "lora" in self._modules:
            self.lora.reset_parameters(gen, std)
        if "mlp" in self._modules and hasattr(self.mlp, "reset_parameters"):
            self.mlp.reset_parameters(gen)

    def forward(self, x: Any) -> Any:
        """``[b, s, dim]``, or the packed ``(hidden, seg, pos)`` (rotary
        at ``pos``, attention through :func:`segment_attention`)."""
        refuse_quantized(self, "this transformer block")
        cfg, p = self.cfg, self.params()
        packed = _is_packed_act(x)
        if packed:
            _refuse_packed_sp(cfg, "packed batches (segment_ids)")
            x, seg, pos = x
        b, s, _ = x.shape
        q, k, v = _block_qkv(cfg, p, x, pos if packed else 0)
        if packed:
            attn = segment_attention(q, k, v, seg, causal=cfg.causal,
                                     window=cfg.attn_window)
        else:
            attn = attention(q, k, v, causal=cfg.causal, window=cfg.attn_window)
        mlp = None if "mlp" not in self._modules else (lambda _, h: self.mlp(h))
        out = _block_attn_out(cfg, p, x, attn.reshape(b, s, -1), mlp)
        return (out, seg, pos) if packed else out


def _head_w(cfg: TransformerConfig, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The head projection ``[dim, vocab]``: the layer's own ``w``, or,
    under ``cfg.tie_embeddings``, the embedding table transposed (a tied
    head holds it as ``table``; generation splices it in)."""
    if "w" in p:
        return _w(cfg, p, "w")
    if cfg.tie_embeddings and "table" in p:
        return p["table"].T
    if cfg.tie_embeddings:
        raise ValueError(
            "tie_embeddings=True but the head received neither 'w' nor "
            "the spliced embedding 'table' — build the model with "
            "models.transformer.llama_tied(cfg), or give the head the "
            "embedding's parameter: lm_head(cfg, table=embed.table)"
        )
    raise ValueError(
        f"head params are missing 'w' (got keys {sorted(p)}) — was "
        "the checkpoint built for a different head configuration?"
    )


class LMHead(_Layer):
    """Final norm + vocabulary projection (float32 logits are the
    generation path's job; the forward returns ``x.dtype``).  A tied
    config (``tie_embeddings``) has no ``w``: given ``table`` (the
    embedding's parameter), the head registers that same parameter and
    projects with its transpose, so its param dict is the reference's
    spliced tied head ``{scale, [bias,] table}``."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None,
                 table: Optional[nn.Parameter] = None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = resolve_device(device)
        self.scale = _param((cfg.dim,), torch.float32, dev)
        if cfg.norm == "layernorm":
            self.bias = _param((cfg.dim,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.w = _param((cfg.dim, cfg.vocab), cfg.dtype, dev)
        elif table is not None:
            self.table = table

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Unit scale, zero bias, ``w ~ N(0, dim^-1/2)``; a tied head's
        table is the embedding's, drawn there."""
        self.scale.fill_(1.0)
        if "bias" in self._parameters:
            self.bias.zero_()
        if "w" in self._parameters:
            self.w.copy_(
                _normal(gen, self.w.shape, self.cfg.dim ** -0.5, self.w.dtype,
                        self.w.device)
            )

    def forward(self, x: Any) -> torch.Tensor:
        refuse_quantized(self, "this head")
        if _is_packed_act(x):
            x = x[0]   # logits come from the hidden plane
        p = self.params()
        return _block_norm(self.cfg, p, "scale", x) @ _head_w(self.cfg, p)


class ChunkedLMLoss(LMHead):
    """The final norm, the vocabulary projection and the cross-entropy
    as one parametric loss layer (the reference's ``chunked_lm_loss``):
    ``loss(y, labels)`` runs ``ops.losses.chunked_softmax_xent`` over
    vocabulary chunks of ``chunk`` columns, so no ``[tokens, vocab]``
    logit matrix exists in either direction.  Its parameters are
    :class:`LMHead`'s (``scale``, ``bias`` for a LayerNorm config, ``w``),
    so the two heads are checkpoint-interchangeable.  ``y`` may be a
    packed activation, ``labels`` ``[b, s]`` int or the packed target
    dict ``{"labels", "weights"}``.  Train it with
    ``GPipe.value_and_grad_with_loss_params``."""

    def __init__(self, cfg: TransformerConfig, *, chunk: int = 8192,
                 device: Device = None):
        super().__init__(cfg, device=device)
        self.chunk = chunk

    def row_loss(self, y: Any, labels: Any) -> torch.Tensor:
        """``[b]`` per-row losses: each row's token mean, or its
        weighted mean over the real tokens of a packed target."""
        if _is_packed_act(y):
            y = y[0]
        weights = None
        if isinstance(labels, dict):
            labels, weights = labels["labels"], labels["weights"]
        p = self.params()
        h = _block_norm(self.cfg, p, "scale", y)
        losses = chunked_softmax_xent(
            h.reshape(-1, self.cfg.dim), _head_w(self.cfg, p), labels.reshape(-1),
            self.chunk)
        losses = losses.reshape(labels.shape[0], -1)
        if weights is not None:
            w = weights.to(losses.dtype)
            return (losses * w).sum(1) / w.sum(1).clamp_min(1.0)
        return losses.mean(1)

    def forward(self, y: Any, labels: Any) -> torch.Tensor:  # type: ignore[override]
        return self.row_loss(y, labels).mean()

    def as_head(self) -> LMHead:
        """An :class:`LMHead` over this layer's own parameters (shared,
        not copied): the head of the model ``generate`` decodes with."""
        head = LMHead(self.cfg, device="meta")
        for name, p in self.params().items():
            setattr(head, name, p)
        return head


_TIE_MPMD = (
    "tie_embeddings is an SPMD-engine feature: the MPMD layer "
    "list places the embedding and the head on different stage "
    "devices with independent param trees, so the tied gradient "
    "would need a manual cross-stage reduction.  Use "
    "llama_spmd(cfg, n) + SpmdGPipe (pre params are replicated "
    "across pp lanes; the tie is spliced and gradients sum "
    "automatically), or set tie_embeddings=False here"
)


class Llama(nn.Sequential):
    """``[embed, block_0 .. block_{n-1}, head]``, the reference's flat
    ``llama(cfg)`` layer list as one ``nn.Sequential`` (no head with
    ``head=False``).  A tied config's head holds the embedding's
    ``table`` (:func:`llama_tied`; :func:`llama` refuses the tie).
    ``mlp(device)`` makes each block's custom feed-forward
    (``models.moe.llama_moe``)."""

    def __init__(self, cfg: TransformerConfig, *, head: bool = True,
                 device: Device = None,
                 mlp: Optional[Callable[[torch.device], nn.Module]] = None):
        dev = resolve_device(device)
        embed = TokenEmbedding(cfg, device=dev)
        table = embed.table if cfg.tie_embeddings else None
        super().__init__(
            embed,
            *[TransformerBlock(cfg, device=dev, mlp=None if mlp is None else mlp(dev))
              for _ in range(cfg.n_layers)],
            *([LMHead(cfg, device=dev, table=table)] if head else []),
        )
        self.cfg = cfg
        # The reference's layer names (its state-dict keys carry them).
        names = ["embed"] + [f"block{i}" for i in range(cfg.n_layers)] + ["head"]
        for layer, name in zip(self, names):
            layer.name = name

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


def _packed_token_nll(logits: Any, target: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position negative log-likelihood and its real-token weights
    for the packed/padded target ``{"labels", "weights"}``."""
    if _is_packed_act(logits):
        logits = logits[0]
    labels, weights = target["labels"], target["weights"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -ll, weights.float()


def packed_cross_entropy(logits: Any, target: Any) -> torch.Tensor:
    """Cross-entropy weighted by real tokens: ``sum(w nll) / sum(w)``
    over this call, for the ``{"labels", "weights"}`` target of
    ``utils.data`` (pad and document-final positions weigh 0).  For a
    loss summed over micro-batches use :func:`packed_cross_entropy_sum`."""
    nll, w = _packed_token_nll(logits, target)
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def packed_cross_entropy_sum(logits: Any, target: Any) -> torch.Tensor:
    """``sum(w nll)`` over the call: decomposes exactly over any split
    of the batch (pair with ``loss_reduction='sum'``)."""
    nll, w = _packed_token_nll(logits, target)
    return (nll * w).sum()


def per_document_losses(
    logits: Any, target: Any, segment_ids: torch.Tensor, n_docs: int
) -> torch.Tensor:
    """Token-mean loss per packed document: entry ``r * n_docs + d - 1``
    of the ``[b * n_docs]`` result is row ``r`` segment ``d``'s mean nll
    over its real positions (0 where the segment is absent)."""
    nll, w = _packed_token_nll(logits, target)
    out = []
    for d in range(1, n_docs + 1):
        m = (segment_ids == d).float() * w
        out.append((nll * m).sum(1) / m.sum(1).clamp_min(1.0))
    return torch.stack(out, dim=1).reshape(nll.shape[0] * n_docs)


def token_embedding(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> TokenEmbedding:
    return _init(TokenEmbedding(cfg, device=device), generator)


def transformer_block(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None, mlp: Optional[nn.Module] = None,
) -> TransformerBlock:
    """One block, initialised from ``generator``; ``mlp`` replaces the
    dense feed-forward (see :class:`TransformerBlock`) and is drawn after
    the block's own weights when it has ``reset_parameters``."""
    return _init(TransformerBlock(cfg, device=device, mlp=mlp), generator)


def lm_head(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
    table: Optional[nn.Parameter] = None,
) -> LMHead:
    return _init(LMHead(cfg, device=device, table=table), generator)


def llama(
    cfg: TransformerConfig, *, head: bool = True, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> Llama:
    """The flat Llama as an ``nn.Sequential`` on ``device`` (``cuda``
    unless named), initialised from ``generator`` (a fresh one seeded 0
    on that device when omitted).  ``head=False`` leaves out the head:
    pair it with :func:`chunked_lm_loss` through
    ``GPipe.value_and_grad_with_loss_params``.  A tied config is
    refused with the reference's text: use :func:`llama_tied`."""
    if cfg.tie_embeddings:
        raise ValueError(_TIE_MPMD)
    return _init(Llama(cfg, head=head, device=device), generator)


def llama_tied(
    cfg: TransformerConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> Llama:
    """The flat model of a tied config (``tie_embeddings=True``, the
    GPT-2 class): :func:`llama`'s layers, the head holding the
    embedding's ``table`` parameter itself (one tensor, registered in
    both layers; ``parameters()`` lists it once).  For generation and
    the unpipelined forward; ``GPipe`` refuses a parameter held by two
    of its stages, as the reference's MPMD engine refuses the tie."""
    if not cfg.tie_embeddings:
        raise ValueError("llama_tied needs cfg.tie_embeddings=True; use llama(cfg)")
    return _init(Llama(cfg, device=device), generator)


def chunked_lm_loss(
    cfg: TransformerConfig, *, chunk: int = 8192, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> ChunkedLMLoss:
    """The parametric big-vocabulary loss layer (:class:`ChunkedLMLoss`),
    its parameters drawn as :func:`lm_head`'s."""
    return _init(ChunkedLMLoss(cfg, chunk=chunk, device=device), generator)


def _init(layer: nn.Module, gen: Optional[torch.Generator]) -> Any:
    """Draw ``layer``'s parameters from ``gen`` (a fresh one seeded 0 on
    the layer's device when None; a layer on ``meta`` holds no values)."""
    dev = next(layer.parameters()).device
    if dev.type == "meta":
        return layer
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    layer.reset_parameters(gen)
    return layer
