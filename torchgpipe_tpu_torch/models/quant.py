"""Weight-only int8 quantization for decode.

Counterpart of ``torchgpipe_tpu/models/quant.py``.  Decode reads every
weight matrix each token, so storing the projection matrices as int8
with per-output-channel symmetric scales halves the bytes of a bf16
model at rest; the products still run in the compute dtype.

* Decode only: :func:`quantize_params_int8` turns a trained
  ``llama(cfg)`` (the flat layer list ``models.generation`` takes) into
  one whose eligible matrices are :class:`QuantWeight` children (int8
  ``q8`` and float32 ``sc`` buffers).  Every generation path (prefill,
  decode, ``decode_slots`` and so the serving Engine, beam search,
  speculative decoding) reads weights through one accessor,
  :func:`dequantize_weight`.  Training keeps full-precision weights:
  the training block, the head and ``GPipe`` refuse a quantized layer
  (quantize after training, as the reference says).
* Quantized leaves: the 2-D ``QUANT_KEYS`` (``wq/wk/wv/wo``, the gated
  ``w_gate/w_up/w_down`` or classic ``w_fc/w_proj``, the untied head's
  ``w``).  The embedding table, learned positions, biases, norm scales,
  LoRA factors and a MoE block's ``"mlp"`` (its router and 3-D expert
  stacks) stay as they are; a tied head reads the embedding's table.
* Dequantize-then-GEMM: :func:`dequantize_weight` builds the full
  matrix in the compute dtype on each read (the reference's arithmetic:
  int8 to float32, times the scale, cast), so a decode step reads the
  int8 bytes and then writes and reads a full-width copy.  The reference
  leaves the fusion of that read into the product to XLA; no kernel here
  fuses it.

Error model: symmetric per-output-channel scales bound each weight's
error by half a quantization step of its channel's largest magnitude.
``torch.round`` rounds half to even as ``jnp.round`` does, so equal
float32 input gives equal ``q8`` and ``sc`` bits.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

#: 2-D weight keys eligible for int8 storage, by param schema.
QUANT_KEYS = (
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "w_fc", "w_proj",
    "w",                      # untied lm head
)


def _quant_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel (trailing dim) int8 quantization:
    ``w[:, j] ~ q8[:, j] * sc[j]``, the reference's steps in float32."""
    wf = w.detach().float()
    amax = wf.abs().amax(0)
    sc = torch.clamp_min(amax, 1e-12) / 127.0
    q8 = torch.clamp(torch.round(wf / sc[None, :]), -127, 127).to(torch.int8)
    return {"q8": q8, "sc": sc}


class QuantWeight(nn.Module):
    """One weight-only int8 matrix of a quantized layer, held under the
    weight's own key: ``q8`` (int8 ``[in, out]``) and ``sc`` (float32
    ``[out]``) buffers.  Its layer's ``params()`` shows it as the
    reference's ``{"q8", "sc"}`` leaf."""

    def __init__(self, q8: torch.Tensor, sc: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("sc", sc)

    def leaf(self) -> Dict[str, torch.Tensor]:
        return {"q8": self.q8, "sc": self.sc}


def is_quantized(v: Any) -> bool:
    """True for a ``{"q8", "sc"}`` weight-only leaf (a ``dict``, as the
    reference's: every decode step asks this of every weight, and a check
    against the ``Mapping`` ABC costs microseconds a call)."""
    return isinstance(v, dict) and set(v) == {"q8", "sc"}


def dequantize_weight(v: Any, dtype: torch.dtype) -> Any:
    """``{"q8", "sc"} -> dtype`` matrix (or the value unchanged when it
    is already a plain tensor): the single read-site accessor of the
    generation paths."""
    if is_quantized(v):
        # int8 * float32 promotes to float32 in one pass: the reference's
        # q8.astype(f32) * sc, bit for bit, without a float32 copy of q8.
        return (v["q8"] * v["sc"][None, :]).to(dtype)
    return v


def _has_quant(layer: Any) -> bool:
    if isinstance(layer, dict):
        return any(is_quantized(v) for v in layer.values())
    return isinstance(layer, nn.Module) and any(
        isinstance(m, QuantWeight) for m in layer.children())


def _quantize_layer(layer: nn.Module) -> Tuple[nn.Module, int]:
    """A shallow copy of ``layer`` whose eligible parameters are
    :class:`QuantWeight` children; its other parameters and submodules
    are the original's own tensors (shared, not copied)."""
    keys = [k for k, v in layer._parameters.items()
            if k in QUANT_KEYS and v is not None and v.ndim == 2]
    if not keys:
        return layer, 0
    new = copy.copy(layer)
    new._parameters = dict(layer._parameters)
    new._buffers = dict(layer._buffers)
    new._modules = dict(layer._modules)
    for k in keys:
        q = _quant_matrix(new._parameters.pop(k))
        new._modules[k] = QuantWeight(q["q8"], q["sc"])
    return new, len(keys)


@torch.no_grad()
def quantize_params_int8(cfg: Any, params: Sequence[Any]) -> Any:
    """The flat per-layer model (``llama(cfg)``, or any sequence of its
    layers) with every eligible projection stored int8, as an
    ``nn.Sequential`` the generation API takes; the original model is
    left as it was, and the new one shares its other tensors.  A sequence
    of param dicts (the reference's form) gives a list of dicts with
    ``{"q8", "sc"}`` leaves.

    Only the flat per-layer layout is taken; a sequence where nothing
    was eligible raises instead of returning full-precision weights
    labeled quantized."""
    del cfg  # the schema is discovered from the leaves themselves
    layers = list(params)
    out: List[Any] = []
    n_quantized = 0
    for layer in layers:
        if isinstance(layer, Mapping):
            q = {}
            for k, v in layer.items():
                if k in QUANT_KEYS and hasattr(v, "ndim") and v.ndim == 2:
                    q[k] = _quant_matrix(v)
                    n_quantized += 1
                else:
                    q[k] = v
            out.append(q)
        elif isinstance(layer, nn.Module):
            new, n = _quantize_layer(layer)
            out.append(new)
            n_quantized += n
        else:
            out.append(layer)
    if n_quantized == 0:
        if any(_has_quant(layer) for layer in layers):
            raise ValueError(
                "these params are already weight-only int8 "
                "(quantize_params_int8 applied twice?)"
            )
        raise ValueError(
            "no eligible 2-D projection weights found — "
            "quantize_params_int8 takes the FLAT per-layer list the "
            "generation API consumes (embed, blocks, head); for "
            "SpmdGPipe's stacked params, unstack first with "
            "models.generation.spmd_params_for_generation"
        )
    if all(isinstance(layer, nn.Module) for layer in out):
        return nn.Sequential(*out)
    return out


def _leaves(layer: Any) -> List[Any]:
    if isinstance(layer, Mapping):
        return list(layer.values())
    if isinstance(layer, nn.Module) and hasattr(layer, "params"):
        return list(layer.params().values())
    return []


def quantized_bytes(
    params: Sequence[Any], dtype: torch.dtype = torch.float32
) -> Tuple[int, int]:
    """(bytes of the quantized leaves with their scales, bytes those
    leaves would take in ``dtype``: pass the model's compute dtype so the
    saving matches the run it goes with)."""
    width = torch.empty((), dtype=dtype).element_size()
    qb = fb = 0
    for layer in params:
        for v in _leaves(layer):
            if is_quantized(v):
                qb += v["q8"].numel() + v["sc"].numel() * 4
                fb += v["q8"].numel() * width
    return qb, fb


def refuse_quantized(layer: nn.Module, what: str) -> None:
    """The training paths' refusal of a weight-only int8 layer."""
    if _has_quant(layer):
        raise ValueError(
            f"{what} holds weight-only int8 weights "
            "(models.quant.quantize_params_int8), which are for decode "
            "only: training and the training forward take full-precision "
            "weights — train first, then quantize"
        )


__all__ = [
    "QUANT_KEYS",
    "QuantWeight",
    "dequantize_weight",
    "is_quantized",
    "quantize_params_int8",
    "quantized_bytes",
]
