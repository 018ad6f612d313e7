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

from torchgpipe_tpu_torch.checkpoint import checkpoint_name
from torchgpipe_tpu_torch.models.quant import QuantWeight, dequantize_weight, refuse_quantized
from torchgpipe_tpu_torch.ops.flash_attention import _validate_window, attention
from torchgpipe_tpu_torch.ops.losses import chunked_softmax_xent
from torchgpipe_tpu_torch.parallel.axes import BoundAxis, axis_bound
from torchgpipe_tpu_torch.parallel.ring_attention import attention as sp_attention
from torchgpipe_tpu_torch.parallel.tensor import (
    all_gather_value,
    pmax_stop,
    psum_grad,
    psum_value,
)

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
    ``torch.dtype``).  ``tp_axis`` and ``sp_axis`` name the mesh axes the
    layers collect over inside ``spmd.SpmdGPipe`` (``parallel.axis_bound``);
    elsewhere the layers compute the unsharded math."""

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
        """The reference's checks of the knobs (every knob is ported)."""
        self.validate_arch()


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


def _local_vocab_ids(
    ids: torch.Tensor, ax: BoundAxis, v_loc: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global token ids on this lane's vocab shard: ``(idx, in_range)``,
    ``idx`` clipped into ``[0, v_loc)`` and ``in_range`` marking the ids
    the lane owns.  Shared by the vocab-parallel lookup and
    cross-entropy's target-logit gather."""
    local = ids - ax.index * v_loc
    in_range = (local >= 0) & (local < v_loc)
    return local.clamp(0, v_loc - 1), in_range


def _embed(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
    pos0: Any = 0, tp: Optional[BoundAxis] = None,
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
    repeats bit for bit.  Under a bound ``tp`` axis the table is this
    lane's vocab shard: tokens it does not own contribute zero rows, and
    the lanes' rows sum (Megatron's parallel embedding)."""
    if tp is not None:
        idx, in_range = _local_vocab_ids(tokens, tp, p["table"].shape[0])
        rows = torch.where(in_range[..., None], F.embedding(idx, p["table"]), 0)
        x = psum_value(rows, tp.name)
    else:
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
    pos: Any, tp: Optional[BoundAxis] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln1 (pre-norm only), q/k/v projections (+ Qwen2 biases), head
    reshape, Qwen3 per-head q/k RMSNorm, rotary at ``pos``.
    ``x: [b, g, dim]``.  Under a bound ``tp`` axis the projections are
    this lane's heads (head counts come from the weights' shapes) and the
    region's entry sums the input's gradient over the lanes."""
    b, g, _ = x.shape
    hd = cfg.head_dim
    # Post-norm (BERT class): the attention branch reads x raw; ln1
    # normalizes the residual sum in _block_attn_out instead.
    h = x if cfg.norm_position == "post" else _block_norm(cfg, p, "ln1", x)
    if tp is not None:
        h = psum_grad(h, tp.name)
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
    mlp: Optional[MlpFn] = None, tp: Optional[BoundAxis] = None,
) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or classic (fc -> act -> proj) feed-forward,
    or, for a block whose params carry ``"mlp"`` (a custom feed-forward,
    the MoE family), ``mlp(p["mlp"], h)``.  Under a bound ``tp`` axis the
    dense forms are a tensor-parallel region over this lane's hidden
    units, the output bias added once after the lanes' sum."""
    if "mlp" in p:
        if mlp is None:
            raise ValueError(
                "these block params carry an 'mlp' feed-forward (MoE "
                "family); pass moe=MoEConfig(...) matching the training "
                "configuration to prefill()/generate()"
            )
        return mlp(p["mlp"], h).to(h.dtype)
    if tp is not None:
        h = psum_grad(h, tp.name)
    if "w_fc" in p:
        # Named save point (checkpoint.NAMED_SAVE_POINTS), as below.
        hid = checkpoint_name(_act_fn(cfg.act)(h @ _w(cfg, p, "w_fc") + p["b_fc"]),
                              "mlp_hidden")
        out = hid @ _w(cfg, p, "w_proj")
        if tp is not None:
            out = psum_value(out, tp.name)
        return out + p["b_proj"]
    gate = _act_fn(cfg.act)(h @ _w(cfg, p, "w_gate"))
    # Named save point: keeping the [b, s, hidden] activation lets the
    # recompute skip the product that makes it.
    hid = checkpoint_name(gate * (h @ _w(cfg, p, "w_up")), "mlp_hidden")
    out = hid @ _w(cfg, p, "w_down")
    return psum_value(out, tp.name) if tp is not None else out


def _block_attn_out(
    cfg: TransformerConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor,
    attn: torch.Tensor, mlp: Optional[MlpFn] = None,
    tp: Optional[BoundAxis] = None,
) -> torch.Tensor:
    """wo projection (+ bias), attention residual, ln2 (parallel or
    sequential residual), MLP residual (``mlp`` for a block with an
    ``"mlp"`` feed-forward); post-norm: ``ln1(x + o)``, then ``ln2`` of
    the MLP's residual sum.  ``attn: [b, g, nh*hd]``.  Under a bound
    ``tp`` axis ``wo`` is row-parallel: the lanes' partial outputs sum at
    the region's exit, and ``bo`` is added once after it."""
    attn = attn.to(x.dtype)
    o = attn @ _w(cfg, p, "wo")
    if "lora" in p:
        o = o + _lora_delta(cfg, p["lora"], attn, "oa", "ob")
    if tp is not None:
        o = psum_value(o, tp.name)
    if "bo" in p:
        o = o + p["bo"]
    # Named save point: a remat policy such as checkpoint.policies.
    # save_attn_out keeps (or offloads) this [b, s, dim] tensor a block.
    o = checkpoint_name(o, "attn_out")
    if cfg.norm_position == "post":
        x = _block_norm(cfg, p, "ln1", x + o)
        return _block_norm(cfg, p, "ln2", x + _mlp_out(cfg, p, x, mlp, tp))
    h = _block_norm(cfg, p, "ln2", x if cfg.parallel_residual else x + o)
    return x + o + _mlp_out(cfg, p, h, mlp, tp)


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
    """The reference's refusal of a packed batch under a bound
    sequence-parallel axis."""
    if axis_bound(cfg.sp_axis) is not None:
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


def _vocab_meta(cfg: TransformerConfig, table_spec: dict) -> dict:
    """The vocab-parallel embedding's and head's ``meta``: their tp axis,
    the param sharding (under a tp axis) and the vocab divisibility check."""
    tp = cfg.tp_axis

    def validate_mesh(mesh: Any) -> None:
        if tp is None or tp not in mesh.axis_names:
            return
        size = mesh.shape[tp]
        if cfg.vocab % size != 0:
            raise ValueError(
                f"vocab={cfg.vocab} is not divisible by the tp mesh axis "
                f"size {size}; the vocab-parallel embedding/head shard the "
                "vocabulary dimension across tp lanes"
            )

    meta = {"tp_axis": tp, "validate_mesh": validate_mesh}
    if tp is not None:
        meta["param_specs"] = table_spec
    return meta


def _block_meta(cfg: TransformerConfig, mlp: Optional[nn.Module]) -> dict:
    """The block's ``meta``, the reference's: the sp/tp axes it collects
    over, ``validate_mesh`` (tp must divide the head and hidden counts;
    the ring refuses a window; Ulysses needs the local head counts
    divisible by sp) and, when anything is sharded, ``param_specs``:
    column-parallel projections over tp on their output dim, row-parallel
    ones on their input dim, per-hidden biases with their hidden dim."""
    from torchgpipe_tpu_torch.spmd import P

    tp, nh, nkv, hidden = cfg.tp_axis, cfg.n_heads, cfg.kv_heads, cfg.mlp_hidden
    mlp_meta = getattr(mlp, "meta", None)
    mlp_meta = mlp_meta if isinstance(mlp_meta, dict) else {}

    def validate_mesh(mesh: Any) -> None:
        if tp is not None and tp in mesh.axis_names:
            size = mesh.shape[tp]
            checks = [("n_heads", nh), ("kv_heads", nkv)]
            if mlp is None:
                checks.append(("mlp_hidden", hidden))
            for what, count in checks:
                if count % size != 0:
                    raise ValueError(
                        f"{what}={count} is not divisible by the tp mesh "
                        f"axis size {size}; tensor parallelism shards whole "
                        "heads / hidden units across lanes"
                    )
        sp_on = cfg.sp_axis is not None and cfg.sp_axis in mesh.axis_names
        if cfg.attn_window is not None and cfg.sp_impl == "ring" and sp_on:
            raise ValueError(
                "attn_window does not compose with sp_impl='ring' (the "
                "ring would need per-step band skipping); use "
                "sp_impl='ulysses' — its local full-sequence attention "
                "windows exactly — or drop the sp axis"
            )
        if cfg.sp_impl == "ulysses" and sp_on:
            sp_size = mesh.shape[cfg.sp_axis]
            tp_size = mesh.shape[tp] if tp is not None and tp in mesh.axis_names else 1
            for what, count in (("n_heads", nh), ("kv_heads", nkv)):
                if (count // tp_size) % sp_size != 0:
                    raise ValueError(
                        f"sp_impl='ulysses' shards attention heads: local "
                        f"{what} ({count}//tp={count // tp_size}) must be "
                        f"divisible by the {cfg.sp_axis!r} axis size "
                        f"({sp_size}); use sp_impl='ring' for this head "
                        "count"
                    )
        if "validate_mesh" in mlp_meta:
            mlp_meta["validate_mesh"](mesh)

    mlp_specs = mlp_meta.get("param_specs")
    specs: Optional[dict] = None
    if tp is not None or mlp_specs is not None:
        col, row = (P(), P()) if tp is None else (P(None, tp), P(tp, None))
        specs = {"ln1": P(), "wq": col, "wk": col, "wv": col, "wo": row, "ln2": P()}
        if cfg.norm == "layernorm":
            specs.update(ln1b=P(), ln2b=P())
        if cfg.attn_out_bias:
            specs["bo"] = P()          # per-dim, added after the lanes' sum
        if cfg.attn_bias:
            bias = P() if tp is None else P(tp)
            specs.update(bq=bias, bk=bias, bv=bias)
        if cfg.qk_norm:
            specs.update(qn=P(), kn=P())
        if cfg.lora_rank:
            specs["lora"] = {"qa": P(), "qb": P(None, tp), "ka": P(), "kb": P(None, tp),
                             "va": P(), "vb": P(None, tp),
                             "oa": P(tp, None) if tp is not None else P(), "ob": P()}
        if mlp is None and cfg.mlp_impl == "classic":
            specs.update(w_fc=P(None, tp), b_fc=P() if tp is None else P(tp),
                         w_proj=P(tp, None), b_proj=P())
        elif mlp is None:
            specs.update(w_gate=P(None, tp), w_up=P(None, tp), w_down=P(tp, None))
        else:
            specs["mlp"] = mlp_specs if mlp_specs is not None else P()
    meta = {"kind": "transformer_block", "sp_axis": cfg.sp_axis, "tp_axis": tp,
            "validate_mesh": validate_mesh, "param_specs": specs}
    for key in ("ep_axis", "moe", "balance_weight"):
        if key in mlp_meta:
            meta[key] = mlp_meta[key]
    return meta


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
    embedding LayerNorm ``eln``/``elnb`` (``embed_layernorm``).  Under a
    bound ``cfg.tp_axis`` the table is vocab-parallel (each lane holds
    ``vocab/tp`` rows); under a bound ``cfg.sp_axis`` a shard reads the
    position rows of its global positions."""

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
        from torchgpipe_tpu_torch.spmd import P

        spec = {"table": P(cfg.tp_axis)}
        if cfg.pos_emb == "learned":
            spec["pos"] = P()
        if cfg.embed_layernorm:
            spec.update(eln=P(), elnb=P())
        self.meta = _vocab_meta(cfg, spec)

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
        tp = axis_bound(self.cfg.tp_axis)
        if not _is_packed_batch(tokens):
            sp = axis_bound(self.cfg.sp_axis)
            if sp is None:
                self._check_len(tokens.shape[-1], False)
            pos0 = 0 if sp is None else sp.index * tokens.shape[-1]
            return _embed(self.cfg, self.params(), tokens, pos0, tp)
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
        return _embed(self.cfg, self.params(), ids, pos, tp), seg, pos


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
        self.meta = _block_meta(cfg, mlp)

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
        at ``pos``, attention through :func:`segment_attention`).  Under a
        bound ``cfg.sp_axis`` (inside ``SpmdGPipe``) ``x`` is this lane's
        sequence shard: rotary at its global positions, attention by
        ``cfg.sp_impl`` (the ring or Ulysses); under a bound
        ``cfg.tp_axis`` the weights are this lane's heads and hidden units
        (Megatron regions, ``parallel.tensor``)."""
        refuse_quantized(self, "this transformer block")
        cfg, p = self.cfg, self.params()
        packed = _is_packed_act(x)
        if packed:
            _refuse_packed_sp(cfg, "packed batches (segment_ids)")
            x, seg, pos = x
        b, s, _ = x.shape
        sp, tp = axis_bound(cfg.sp_axis), axis_bound(cfg.tp_axis)
        if not packed:
            pos = 0 if sp is None else sp.index * s
        q, k, v = _block_qkv(cfg, p, x, pos, tp)
        if packed:
            attn = segment_attention(q, k, v, seg, causal=cfg.causal,
                                     window=cfg.attn_window)
        elif sp is not None:
            attn = sp_attention(q, k, v, axis_name=cfg.sp_axis, causal=cfg.causal,
                                impl=cfg.sp_impl, window=cfg.attn_window)
        else:
            attn = attention(q, k, v, causal=cfg.causal, window=cfg.attn_window)
        mlp = None if "mlp" not in self._modules else (lambda _, h: self.mlp(h))
        out = _block_attn_out(cfg, p, x, attn.reshape(b, s, -1), mlp, tp)
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
    spliced tied head ``{scale, [bias,] table}``.

    Under a bound ``cfg.tp_axis`` the projection is vocab-parallel (the
    Megatron column-parallel output layer): with ``gather_logits`` the
    lanes' logit shards are gathered into full ``[.., vocab]`` logits, so
    any loss works; without, each lane keeps its ``[.., vocab/tp]`` shard
    for :func:`vocab_parallel_cross_entropy` (1/tp of the logits' memory),
    and ``SpmdGPipe.apply`` gathers them (``meta['out_gather']``)."""

    def __init__(self, cfg: TransformerConfig, *, device: Device = None,
                 table: Optional[nn.Parameter] = None, gather_logits: bool = True):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.gather_logits = gather_logits
        dev = resolve_device(device)
        self.scale = _param((cfg.dim,), torch.float32, dev)
        if cfg.norm == "layernorm":
            self.bias = _param((cfg.dim,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.w = _param((cfg.dim, cfg.vocab), cfg.dtype, dev)
        elif table is not None:
            self.table = table
        from torchgpipe_tpu_torch.spmd import P

        spec = {"scale": P(), "bias": P()} if cfg.norm == "layernorm" else {"scale": P()}
        if not cfg.tie_embeddings:
            spec["w"] = P(None, cfg.tp_axis)
        self.meta = _vocab_meta(cfg, spec)
        if cfg.tp_axis is not None and not gather_logits:
            self.meta["out_gather"] = (cfg.tp_axis, -1)

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
        h = _block_norm(self.cfg, p, "scale", x)
        tp = axis_bound(self.cfg.tp_axis)
        if tp is None:
            # Named save point: the [tokens, vocab] logits.
            return checkpoint_name(h @ _head_w(self.cfg, p), "ce_logits")
        logits = psum_grad(h, tp.name) @ _head_w(self.cfg, p)      # [.., vocab/tp]
        logits = all_gather_value(logits, tp.name, -1) if self.gather_logits else logits
        return checkpoint_name(logits, "ce_logits")


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
        if cfg.tie_embeddings and cfg.tp_axis is not None:
            raise ValueError(
                "chunked_lm_loss cannot tie to a vocab-parallel embedding: "
                "the tp-sharded table would hand this loss a [vocab/tp, dim] "
                "local shard while the labels index the GLOBAL vocabulary — "
                "the loss would silently normalize over 1/tp of the "
                "vocabulary.  Use vocab_parallel_cross_entropy with "
                "lm_head(gather_logits=False) for tp models, or untie"
            )
        super().__init__(cfg, device=device)
        self.chunk = chunk
        # Local head weights only, as the reference's: no vocab sharding.
        self.meta = {}

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


# The reference's refusal, word for word; its advice holds in the port:
# llama_spmd below with torchgpipe_tpu_torch.spmd.SpmdGPipe.
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


def vocab_parallel_cross_entropy(axis: Optional[str]) -> Callable:
    """Cross-entropy over vocab-sharded logits (``LMHead(gather_logits=
    False)``), the reference's: the full-vocabulary log-sum-exp and the
    target logit are assembled with tp collectives, so no lane holds full
    logits (Megatron's parallel cross-entropy).  Returns ``loss_fn(
    local_logits, labels)``; with ``axis`` unbound it is
    :func:`cross_entropy`."""

    def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ax = axis_bound(axis)
        if ax is None:
            return cross_entropy(logits, labels)
        logits = logits.float()
        # The max's gradient contribution cancels: a constant shift.
        m = pmax_stop(logits.amax(-1), axis)
        se = psum_value(torch.exp(logits - m[..., None]).sum(-1), axis)
        z = torch.log(se) + m
        idx, in_range = _local_vocab_ids(labels.long(), ax, logits.shape[-1])
        tl = logits.gather(-1, idx[..., None])[..., 0]
        tl = psum_value(torch.where(in_range, tl, 0.0), axis)
        return (z - tl).mean()

    return loss


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
    table: Optional[nn.Parameter] = None, gather_logits: bool = True,
) -> LMHead:
    return _init(LMHead(cfg, device=device, table=table, gather_logits=gather_logits),
                 generator)


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


def llama_spmd(
    cfg: TransformerConfig, n_stages: int, *, gather_logits: bool = True,
    device: Device = None,
) -> Tuple[nn.Sequential, TokenEmbedding, LMHead]:
    """``(block, pre, post)`` for ``torchgpipe_tpu_torch.spmd.SpmdGPipe``:
    each stage runs ``n_layers // n_stages`` blocks (an ``nn.Sequential``
    named ``stage``), ``pre`` is the embedding and ``post`` the head, on
    ``device`` (``cuda`` unless named).  The layers are templates: the
    engine draws and holds the parameters (``SpmdGPipe.init``).  Under
    ``tie_embeddings`` the head holds the embedding's ``table`` and names
    it in ``tie_pre``: the engine splices the embedding's into the head,
    so the tied gradient sums into the embedding's.  Under
    ``cfg.tp_axis`` the embedding and the head are vocab-parallel; pass
    ``gather_logits=False`` (with ``loss_fn=vocab_parallel_cross_entropy(
    cfg.tp_axis)``) to keep the logits vocab-sharded through the loss,
    1/tp of the logits' memory."""
    if cfg.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide evenly into {n_stages} stages"
        )
    dev = resolve_device(device)
    per = cfg.n_layers // n_stages
    block = nn.Sequential(*[TransformerBlock(cfg, device=dev) for _ in range(per)])
    block.name = "stage"
    for i, layer in enumerate(block):
        layer.name = f"b{i}"
    return (block, *spmd_ends(cfg, gather_logits, dev))


def spmd_ends(cfg: TransformerConfig, gather_logits: bool,
              device: torch.device) -> Tuple[TokenEmbedding, LMHead]:
    """The SPMD models' ``pre`` (the embedding, ``embed``) and ``post``
    (the head, ``head``; under ``tie_embeddings`` holding the
    embedding's ``table`` and naming it in ``tie_pre``)."""
    pre = TokenEmbedding(cfg, device=device)
    pre.name = "embed"
    post = LMHead(cfg, device=device, table=pre.table if cfg.tie_embeddings else None,
                  gather_logits=gather_logits)
    post.name = "head"
    if cfg.tie_embeddings:
        post.tie_pre = ("table",)
    return pre, post


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
