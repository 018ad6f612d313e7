"""Ulysses sequence parallelism: an all-to-all swap of sequence and heads.

Counterpart of ``torchgpipe_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses,
Jacobs et al., arXiv:2309.14509).  With the sequence sharded over the
``sp`` axis, one all-to-all re-shards q, k and v from sequence-split to
head-split, every lane runs the port's ordinary attention over the whole
sequence on ``h/sp`` of the heads (the kernels on the card), and a last
all-to-all swaps the output back to sequence-split.  Ulysses needs both
head counts divisible by the sp size and holds the whole sequence during
attention; the ring (:mod:`.ring_attention`) holds ``s/sp``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchgpipe_tpu_torch.parallel.axes import BoundAxis, all_to_all, require_axis

__all__ = ["partition_rules", "ulysses_attention"]


def partition_rules(sp_axis: str, pp_axis: str = "pp") -> Any:
    """Ulysses' param layout as a rule table of the analysis layer
    (ROADMAP.md queue A item 5.6); it shards activations, never
    parameters."""
    from torchgpipe_tpu_torch.models.transformer import not_ported

    raise not_ported("parallel.ulysses.partition_rules (analysis.partition_rules)", "5.6")


def _swap_to_heads(x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
    """``[b, s_loc, h, d] -> [b, s, h/sp, d]``: shard heads, gather the
    sequence."""
    return all_to_all(x, ax, 2, 1)


def _swap_to_seq(x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
    """``[b, s, h/sp, d] -> [b, s_loc, h, d]``: gather heads, shard the
    sequence."""
    return all_to_all(x, ax, 1, 2)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Whole-sequence attention over a sequence-sharded batch through two
    all-to-alls: ``q [b, s_loc, h, d]``, ``k, v [b, s_loc, g, d]``, both
    ``h`` and ``g`` divisible by the axis size.  The head split is
    contiguous, so lane ``l`` holds q heads ``[l h/sp, (l+1) h/sp)`` and kv
    heads ``[l g/sp, (l+1) g/sp)``, and the GQA pairing stays lane-local.
    Differentiable in ``q``, ``k`` and ``v``."""
    ax = require_axis(axis_name)
    h, g = q.shape[2], k.shape[2]
    if h % ax.size != 0 or g % ax.size != 0:
        raise ValueError(
            f"Ulysses sequence parallelism shards attention heads: n_heads "
            f"({h}) and kv_heads ({g}) must both be divisible by the "
            f"{axis_name!r} axis size ({ax.size}); use sp_impl='ring' (ring "
            "attention shards the sequence, not heads) for this head count"
        )
    from torchgpipe_tpu_torch.parallel.ring_attention import attention

    qh = _swap_to_heads(q.contiguous(), ax)
    kh = _swap_to_heads(k.contiguous(), ax)
    vh = _swap_to_heads(v.contiguous(), ax)
    out = attention(qh, kh, vh, axis_name=None, causal=causal, sm_scale=sm_scale,
                    window=window)
    return _swap_to_seq(out.contiguous(), ax)
