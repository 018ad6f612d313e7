"""Memory-bounded losses.

Counterpart of ``torchgpipe_tpu/ops/losses.py``.
:func:`chunked_softmax_xent` is the big-vocabulary cross-entropy: the
head matmul and the softmax cross-entropy run chunk by chunk over the
vocabulary with an online log-sum-exp, so no ``[T, V]`` logit matrix
exists in the forward, and the backward recomputes each chunk's logits
and writes the weight gradient chunk by chunk, so none exists there
either.  Peak extra memory is one ``[T, chunk]`` float32 tile.  The
chunks are views of ``w`` (the reference pads the last one with
masked columns; here it is narrower): the same terms, and no padding
copy of ``w``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _xent_fwd(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss [T], lse [T])``, both float32."""
    T, V = h.shape[0], w.shape[1]
    m = torch.full((T,), -1e30, dtype=torch.float32, device=h.device)
    s = torch.zeros((T,), dtype=torch.float32, device=h.device)
    picked = torch.zeros((T,), dtype=torch.float32, device=h.device)
    for off in range(0, V, chunk):
        logits = (h @ w[:, off:off + chunk]).float()          # [T, C]
        c = logits.shape[1]
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
        in_r = (labels >= off) & (labels < off + c)
        idx = (labels - off).clamp(0, c - 1)
        got = logits.gather(1, idx[:, None].long())[:, 0]
        picked = picked + torch.where(in_r, got, 0.0)
    lse = torch.log(s) + m
    return lse - picked, lse


class _ChunkedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, chunk):
        loss, lse = _xent_fwd(h, w, labels, chunk)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        """``dlogits = softmax - onehot(label)`` per token, assembled
        chunk by chunk from recomputed logits: ``dh = sum_c (g p_c) w_c^T``
        (accumulated in float32, cast to ``h.dtype`` once) and ``dw_c =
        h^T (g p_c)``."""
        h, w, labels, lse = ctx.saved_tensors
        chunk, V = ctx.chunk, w.shape[1]
        g = g.float()
        h32 = h.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(w)
        for off in range(0, V, chunk):
            w_c = w[:, off:off + chunk]
            logits = (h @ w_c).float()
            c = logits.shape[1]
            p = torch.exp(logits - lse[:, None])
            in_r = (labels >= off) & (labels < off + c)
            idx = (labels - off).clamp(0, c - 1)
            onehot = torch.zeros_like(p).scatter_(1, idx[:, None].long(), 1.0)
            dl = (p - onehot * in_r[:, None]) * g[:, None]
            dh += dl @ w_c.float().T
            dw[:, off:off + c] = (h32.T @ dl).to(w.dtype)
        return dh.to(h.dtype), dw, None, None


def chunked_softmax_xent(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk: int = 8192
) -> torch.Tensor:
    """Per-token cross-entropy ``-log softmax(h @ w)[label]`` without a
    ``[T, V]`` logit matrix in either direction.

    ``h``: ``[T, d]`` hidden states (any float dtype; logits are taken
    to float32), ``w``: ``[d, V]`` head weights, ``labels``: ``[T]``
    int.  Returns ``[T]`` float32 losses (reduce them yourself).
    Differentiable in ``h`` and ``w``.

    Labels must lie in ``[0, V)``: an out-of-range label matches no
    chunk, so its target term stays 0 and the loss silently becomes the
    log-sum-exp.  There is no ignore index; check with
    :func:`assert_labels_in_range` in a debug run."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _ChunkedSoftmaxXent.apply(h, w, labels, int(chunk))


def assert_labels_in_range(labels: torch.Tensor, vocab: int) -> None:
    """Raise ``ValueError`` unless every label lies in ``[0, vocab)``,
    :func:`chunked_softmax_xent`'s contract.  The reference's check runs
    under ``checkify`` and costs nothing outside it; this one reads the
    result back to the host (a device sync), so call it in debug runs,
    and never inside a captured CUDA graph, where it raises."""
    if labels.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "assert_labels_in_range reads back to the host and cannot run "
            "inside a CUDA graph capture"
        )
    if not bool(((labels >= 0) & (labels < vocab)).all()):
        raise ValueError(
            "chunked_softmax_xent: labels must lie in [0, vocab); out-of-range "
            "labels would silently degrade the loss to logsumexp"
        )
