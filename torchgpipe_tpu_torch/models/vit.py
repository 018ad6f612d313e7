"""Sequential Vision Transformer (ViT) for the pipeline.

Counterpart of ``torchgpipe_tpu/models/vit.py`` (``vit_config``,
``patch_embed``, ``vit_head``, ``vit``): ``[patchify, block x depth,
head]`` as one ``nn.Sequential`` that ``GPipe`` cuts at any block.  No
CLS token: the head mean-pools the patch tokens (the GAP variant).  The
blocks are :class:`~torchgpipe_tpu_torch.models.transformer.TransformerBlock`
with ``causal=False``: on the card their attention runs the
``flash_fwd``/``flash_bwd_*`` kernels without a causal mask (the
kernels take bf16 only, so a float32 ViT is refused on the card; the
reference's dense path at these shapes computes the same function).

Images are NCHW at the API, as every image model of the port (the
reference is NHWC); a patch flattens in the reference's order (row in
the patch, column, channel), so the projection ``w [P*P*C, dim]`` is the
reference's leaf unchanged.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from torchgpipe_tpu_torch.models.transformer import (
    Device,
    TransformerBlock,
    TransformerConfig,
    _block_norm,
    _init,
    _Layer,
    _normal,
    _param,
    resolve_device,
)

__all__ = ["PatchEmbed", "ViTHead", "patch_embed", "vit", "vit_config", "vit_head"]


def vit_config(
    *, image_size: int = 224, patch_size: int = 16, dim: int = 384,
    depth: int = 12, n_heads: int = 6, mlp_ratio: float = 4.0,
    dtype: torch.dtype = torch.float32,
) -> TransformerConfig:
    """The ViT block configuration: LayerNorm, bidirectional attention,
    classic GeLU MLP, q/k/v and output biases, learned positions over
    the patch grid.  ``vocab`` is unused and set to 1."""
    if image_size % patch_size:
        raise ValueError(
            f"image_size={image_size} is not divisible by "
            f"patch_size={patch_size}"
        )
    n_patches = (image_size // patch_size) ** 2
    return TransformerConfig(
        vocab=1, dim=dim, n_layers=depth, n_heads=n_heads, n_kv_heads=n_heads,
        mlp_ratio=mlp_ratio, norm="layernorm", pos_emb="learned",
        max_pos=n_patches, mlp_impl="classic", act="gelu_tanh", attn_bias=True,
        attn_out_bias=True, causal=False, dtype=dtype,
    )


class PatchEmbed(_Layer):
    """``[b, C, H, W] -> [b, N, dim]``: non-overlapping P x P patches
    flattened and projected by one product (``w``, ``b``), plus the
    learned position table ``pos`` (row = patch index in raster order)."""

    def __init__(self, cfg: TransformerConfig, patch_size: int, *,
                 in_channels: int = 3, device: Device = None):
        super().__init__()
        self.cfg, self.patch_size = cfg, patch_size
        dev = resolve_device(device)
        fan_in = patch_size * patch_size * in_channels
        self.w = _param((fan_in, cfg.dim), cfg.dtype, dev)
        self.b = _param((cfg.dim,), cfg.dtype, dev)
        self.pos = _param((cfg.max_pos, cfg.dim), cfg.dtype, dev)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """``w ~ N(0, fan_in^-1/2)``, zero ``b``, ``pos ~ N(0, 0.02)``."""
        self.w.copy_(_normal(gen, self.w.shape, self.w.shape[0] ** -0.5,
                             self.w.dtype, self.w.device))
        self.b.zero_()
        self.pos.copy_(_normal(gen, self.pos.shape, 0.02, self.pos.dtype,
                               self.pos.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
                   .reshape(b, gh * gw, p * p * c))
        out = patches.to(self.cfg.dtype) @ self.w + self.b
        return out + self.pos[None, :gh * gw]


class ViTHead(_Layer):
    """Final LayerNorm (``scale``, ``bias``) -> mean over the patches ->
    linear classifier (``w``, ``b``)."""

    def __init__(self, cfg: TransformerConfig, num_classes: int, *,
                 device: Device = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.scale = _param((cfg.dim,), torch.float32, dev)
        self.bias = _param((cfg.dim,), torch.float32, dev)
        self.w = _param((cfg.dim, num_classes), cfg.dtype, dev)
        self.b = _param((num_classes,), cfg.dtype, dev)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.w.copy_(_normal(gen, self.w.shape, self.cfg.dim ** -0.5,
                             self.w.dtype, self.w.device))
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params()
        pooled = _block_norm(self.cfg, p, "scale", x).mean(dim=1)
        return pooled @ p["w"] + p["b"]


def patch_embed(
    cfg: TransformerConfig, patch_size: int, *, in_channels: int = 3,
    device: Device = None, generator: Optional[torch.Generator] = None,
) -> PatchEmbed:
    return _init(PatchEmbed(cfg, patch_size, in_channels=in_channels, device=device),
                 generator)


def vit_head(
    cfg: TransformerConfig, num_classes: int, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> ViTHead:
    return _init(ViTHead(cfg, num_classes, device=device), generator)


def vit(
    *, image_size: int = 224, patch_size: int = 16, dim: int = 384,
    depth: int = 12, n_heads: int = 6, num_classes: int = 1000,
    mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
    device: Device = None, generator: Optional[torch.Generator] = None,
) -> nn.Sequential:
    """The flat ViT ``[patchify, block x depth, head]`` on ``device``
    (``cuda`` unless named), drawn from ``generator`` (seeded 0 when
    omitted).  Defaults are ViT-S/16; ViT-L/16 is ``dim=1024, depth=24,
    n_heads=16``.  ``list()`` it for ``GPipe``."""
    cfg = vit_config(image_size=image_size, patch_size=patch_size, dim=dim,
                     depth=depth, n_heads=n_heads, mlp_ratio=mlp_ratio, dtype=dtype)
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    kw: Any = dict(device=dev, generator=generator)
    blocks = [_init(TransformerBlock(cfg, device=dev), generator) for _ in range(depth)]
    model = nn.Sequential(patch_embed(cfg, patch_size, **kw), *blocks,
                          vit_head(cfg, num_classes, **kw))
    model.cfg = cfg
    return model
