"""Load the reference's parameters into the port's modules.

The reference keeps a Llama's parameters as a flat per-layer list
``[embed, block_0 .. block_{n-1}, head]`` of dicts (what
``layers.sequential_init(llama(cfg), ...)`` and
``models.generation.mpmd_params_for_generation`` return).  Handed over as
numpy arrays, each leaf lands in the port parameter of the same name,
with the same ``[in, out]`` layout: nothing is transposed
(:func:`params_from_jax`; LoRA adapters too, a ``chunked_lm_loss``
layer's ``scale``/``w``, a MoE block's ``"mlp"`` tree (``router``,
``w_gate``/``w_up`` ``[E, dim, hidden]``, ``w_down`` ``[E, hidden, dim]``)
and weight-only int8 ``{"q8", "sc"}`` leaves, which load into
``models.quant.QuantWeight`` buffers).

A layer list of the model zoo (``models.resnet``, ``models.unet``,
``models.vgg``, ``models.amoebanet``, ``models.vit``, ``models.t5``)
loads per layer params
*and* states (:func:`layers_from_jax`): a conv kernel turns from the
reference's HWIO into OIHW; BatchNorm ``scale``/``bias`` land in
parameters, ``mean``/``var`` (and a deferred BatchNorm's ``sum``,
``ssq``, ``count``, ``tracked``) in buffers; a LayerNorm's ``scale``/
``bias`` in parameters.  A layer wrapped by the mixed-precision policy
(:mod:`torchgpipe_tpu_torch.precision`) loads into the layer it wraps.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
from torchgpipe_tpu_torch.models.amoebanet import Structured
from torchgpipe_tpu_torch.models.quant import QuantWeight, is_quantized
from torchgpipe_tpu_torch.models.resnet import Residual
from torchgpipe_tpu_torch.ops.nn import BatchNorm, Conv2d, Dense, LayerNorm
from torchgpipe_tpu_torch.precision import unwrap
from torchgpipe_tpu_torch.skip import layer_name
from torchgpipe_tpu_torch.models.transformer import (
    ChunkedLMLoss,
    Device,
    Llama,
    TransformerConfig,
    _Layer,
)


def _to_tensor(arr: Any) -> torch.Tensor:
    """numpy array -> CPU tensor.  ``np.asarray`` of a JAX bfloat16 array
    is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
    refuses, so it travels as its uint16 bit pattern."""
    arr = np.array(arr, copy=True)  # writable: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_dict(ours: Mapping[str, Any], theirs: Mapping[str, Any], what: str) -> None:
    """Copy a reference param dict into the port's of the same keys; a
    nested dict (a LoRA block's ``"lora"``, a MoE block's ``"mlp"``, an
    int8 weight's ``{"q8", "sc"}``, a T5 layer's ``"attn"``, ``"xattn"``,
    ``"ff"``) loads into the port's dict of that key."""
    for key, leaf in theirs.items():
        nested = isinstance(leaf, Mapping)
        if (nested and not isinstance(ours.get(key), Mapping)) or \
                (not nested and not hasattr(leaf, "shape")):
            raise ValueError(
                f"{what} param {key!r} ({type(leaf).__name__} where the port "
                f"holds {type(ours.get(key)).__name__}); a stacked SPMD "
                "parameter tree goes to params_from_jax whole, as the "
                "{'pre', 'blocks', 'post'} dict")
    if set(theirs) != set(ours):
        raise ValueError(
            f"{what}: reference keys {sorted(theirs)} != port keys "
            f"{sorted(ours)}; do the two configs agree?"
        )
    for key, dst in ours.items():
        if isinstance(dst, Mapping):
            _load_dict(dst, theirs[key], f"{what} {key}")
            continue
        src = _to_tensor(theirs[key])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"{what} param {key!r}: shape {tuple(src.shape)} != "
                f"{tuple(dst.shape)}"
            )
        dst.copy_(src.to(dst.dtype))


def _hold_quantized(layer: nn.Module, theirs: Mapping[str, Any]) -> None:
    """Make ``layer`` hold a :class:`QuantWeight` (empty, to be loaded)
    where the reference's dict has an int8 ``{"q8", "sc"}`` leaf."""
    for key, leaf in theirs.items():
        if is_quantized(leaf) and key in layer._parameters:
            w = layer._parameters.pop(key)
            layer._modules[key] = QuantWeight(
                torch.empty(w.shape, dtype=torch.int8, device=w.device),
                torch.empty(w.shape[-1], dtype=torch.float32, device=w.device))


@torch.no_grad()
def params_from_jax(
    cfg: TransformerConfig, params: Sequence[Mapping[str, Any]],
    device: Device = None, *, loss_params: Optional[Mapping[str, Any]] = None,
    chunk: int = 8192, moe: Any = None,
) -> Any:
    """The port's ``llama(cfg)`` holding the reference's parameters, or,
    given a reference ``SpmdGPipe``'s params dict (``{"pre", "blocks",
    "post"}``, blocks stacked ``[n_stages, ...]``), the port's SPMD tree
    (:func:`spmd_params_from_jax`).  The flat form:
    (numpy arrays, one dict per layer, LoRA adapters under a block's
    ``"lora"``; learned positions ``pos``, the embedding LayerNorm
    ``eln``/``elnb`` and the LayerNorm biases under their keys), on
    ``device`` (``cuda`` unless named).  A tied config
    (``tie_embeddings``) builds :func:`~torchgpipe_tpu_torch.models.transformer.llama_tied`;
    its head dict may carry the spliced ``table`` or not.  ``params``
    without the head (``n_layers + 1`` dicts) builds
    ``llama(cfg, head=False)``; then ``loss_params`` (the reference's
    ``chunked_lm_loss`` params, ``scale``/``w``) returns ``(model,
    loss_layer)`` with a :class:`ChunkedLMLoss` of ``chunk``.  Blocks
    whose dicts carry ``"mlp"`` (``llama_moe``) need ``moe=MoEConfig``:
    the model is then :func:`~torchgpipe_tpu_torch.models.moe.llama_moe`'s
    (the router loads as float32, whatever ``cfg.dtype``).  int8 leaves
    (the reference's ``quantize_params_int8``) give a quantized model,
    the form ``models.quant.quantize_params_int8`` returns."""
    if isinstance(params, Mapping) and "blocks" in params:
        return spmd_params_from_jax(cfg, params, device)
    params = list(params)
    head = len(params) != cfg.n_layers + 1
    mlp = None
    if any(isinstance(p, Mapping) and "mlp" in p for p in params):
        if moe is None:
            raise ValueError(
                "these block params carry an 'mlp' feed-forward (MoE "
                "family); pass moe=MoEConfig(...) matching the training "
                "configuration"
            )
        from torchgpipe_tpu_torch.models.moe import MoEMLP

        mlp = lambda dev: MoEMLP(cfg, moe, device=dev)   # noqa: E731
    model = Llama(cfg, head=head, device=device, mlp=mlp)
    if cfg.tie_embeddings and head and len(params) == len(model) \
            and "table" not in params[-1]:
        # A tied head's dict without the spliced table reads the embedding's.
        params[-1] = dict(params[-1], table=params[0]["table"])
    if len(params) != len(model):
        raise ValueError(
            f"expected {cfg.n_layers + 2} per-layer param dicts (embed, "
            f"{cfg.n_layers} blocks, head), or {cfg.n_layers + 1} without "
            f"the head, got {len(params)}"
        )
    for i, (layer, p) in enumerate(zip(model, params)):
        _hold_quantized(layer, p)
        _load_dict(layer.params(), p, f"layer {i}")
    if loss_params is None:
        return model
    loss = ChunkedLMLoss(cfg, chunk=chunk, device=device)
    _load_dict(loss.params(), loss_params, "loss layer")
    return model, loss


@torch.no_grad()
def spmd_params_from_jax(cfg: TransformerConfig, params: Mapping[str, Any],
                         device: Device = None) -> dict:
    """A reference ``SpmdGPipe``'s params of ``llama_spmd(cfg, n)`` (numpy
    leaves, ``{"pre", "blocks", "post"}``, blocks stacked ``[n_stages,
    ...]``, or ``[n_stages, virtual_stages, ...]`` from an interleaved
    pipe over ``llama_spmd(cfg, n * v)``) as the port's tree of the same layout for
    ``torchgpipe_tpu_torch.spmd.SpmdGPipe`` (its ``place`` takes it),
    on ``device`` (``cuda`` unless named).  The structure and every shape
    are checked against the port's ``llama_spmd`` (on the meta device);
    a tied head carries no ``table``, as the reference's does not."""
    from torchgpipe_tpu_torch.models.transformer import llama_spmd, resolve_device
    from torchgpipe_tpu_torch.spmd import _get, _items, module_tree

    leaves = _items(params["blocks"])
    if not leaves:
        raise ValueError("the reference's blocks tree has no leaves")
    path, leaf = leaves[0]
    lead = tuple(int(d) for d in np.shape(leaf)[:1])
    block, pre, post = llama_spmd(cfg, lead[0], device="meta")
    if np.ndim(leaf) == _get(module_tree(block), path).ndim + 2:
        # An interleaved pipe's [n_stages, virtual_stages, ...] blocks.
        lead = tuple(int(d) for d in np.shape(leaf)[:2])
        block, pre, post = llama_spmd(cfg, lead[0] * lead[1], device="meta")
    skip = tuple(getattr(post, "tie_pre", ()))
    want = {"pre": module_tree(pre), "post": module_tree(post, skip=skip),
            "blocks": module_tree(block,
                                  lambda name, p: torch.empty((*lead, *p.shape), device="meta"))}
    if set(params) != set(want):
        raise ValueError(f"reference keys {sorted(params)} != {sorted(want)}")
    dev = resolve_device(device)

    def load(ours: Any, theirs: Any, what: str) -> Any:
        if isinstance(ours, Mapping):
            if not isinstance(theirs, Mapping) or set(ours) != set(theirs):
                raise ValueError(f"{what}: reference keys {_keys(theirs)} != {_keys(ours)}")
            return {k: load(v, theirs[k], f"{what} {k}") for k, v in ours.items()}
        if isinstance(ours, tuple):
            if not isinstance(theirs, (tuple, list)) or len(theirs) != len(ours):
                raise ValueError(f"{what}: reference {type(theirs).__name__} != "
                                 f"a tuple of {len(ours)}")
            return tuple(load(v, t, f"{what}[{i}]") for i, (v, t) in
                         enumerate(zip(ours, theirs)))
        t = _to_tensor(theirs)
        if tuple(t.shape) != tuple(ours.shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(ours.shape)}")
        return t.to(device=dev, dtype=ours.dtype)

    return {k: load(want[k], params[k], k) for k in ("pre", "blocks", "post")}


def _copy(dst: torch.Tensor, src: Any, what: str, transpose=None) -> None:
    t = _to_tensor(src)
    if transpose is not None:
        t = t.permute(*transpose)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def _keys(tree: Any) -> list:
    return sorted(tree) if isinstance(tree, Mapping) else []


def _load(module: nn.Module, p: Any, s: Any, what: str) -> None:
    module = unwrap(module)
    if isinstance(module, _Layer):
        if len(s):
            raise ValueError(f"{what}: reference state {_keys(s)} for a stateless layer")
        _load_dict(module.params(), p, what)
        return
    if isinstance(module, Structured):
        if _keys(p) != sorted(module.parts):
            raise ValueError(
                f"{what}: reference children {_keys(p)} != {sorted(module.parts)}")
        for name, child in module.parts.items():
            _load(child, p[name], s[name] if len(s) else (), f"{what}.{name}")
        return
    if isinstance(module, (Conv2d, Dense)):
        want = ["b", "w"] if module.b is not None else ["w"]
        if _keys(p) != want:
            raise ValueError(f"{what}: reference params {_keys(p)} != {want}")
        _copy(module.w, p["w"], f"{what} w",
              (3, 2, 0, 1) if isinstance(module, Conv2d) else None)
        if module.b is not None:
            _copy(module.b, p["b"], f"{what} b")
        return
    if isinstance(module, LayerNorm):
        if _keys(p) != ["bias", "scale"] or len(s):
            raise ValueError(
                f"{what}: reference params {_keys(p)} / state {_keys(s)} != "
                "['bias', 'scale'] / []"
            )
        _copy(module.scale, p["scale"], f"{what} scale")
        _copy(module.bias, p["bias"], f"{what} bias")
        return
    if isinstance(module, BatchNorm):
        buffers = dict(module.named_buffers())
        if _keys(p) != ["bias", "scale"] or _keys(s) != sorted(buffers):
            raise ValueError(
                f"{what}: reference params {_keys(p)} / state {_keys(s)} != "
                f"['bias', 'scale'] / {sorted(buffers)}; deferred_batch_norm "
                "on one side only?"
            )
        _copy(module.scale, p["scale"], f"{what} scale")
        _copy(module.bias, p["bias"], f"{what} bias")
        for key, buf in buffers.items():
            _copy(buf, s[key], f"{what} {key}")
        if isinstance(module, DeferredBatchNorm):
            module._tracked = int(module.tracked)
        return
    if isinstance(module, Residual) and module.down is not None:
        _load(module.down, p, s, what)
        return
    if isinstance(module, nn.Sequential):
        if len(p) != len(module):
            raise ValueError(f"{what}: {len(p)} reference children != {len(module)}")
        state = s if len(s) else ((),) * len(module)
        for k, (child, pc, sc) in enumerate(zip(module, p, state)):
            _load(child, pc, sc, f"{what}[{k}]")
        return
    if list(module.parameters()) or list(module.buffers()) or len(p) or len(s):
        raise ValueError(
            f"{what}: cannot load reference params {type(p).__name__} into "
            f"{type(module).__name__}"
        )


@torch.no_grad()
def layers_from_jax(
    layers: Sequence[nn.Module], params: Sequence[Any], states: Sequence[Any]
) -> Sequence[nn.Module]:
    """Load the reference's per-layer ``params`` and ``states`` (numpy
    leaves, one entry per layer, as ``layers.sequential_init`` returns
    them) into the port's layers of the same model (``models.resnet``,
    ``models.unet``, ``models.vgg``, ``models.amoebanet`` (its cells'
    children by name), ``models.vit``, ``models.t5``; the layer list
    must be built, or
    converted to deferred BatchNorm, as the reference's was).  Returns
    ``layers``."""
    layers = list(layers)
    if not len(layers) == len(params) == len(states):
        raise ValueError(
            f"expected one reference entry per layer: {len(layers)} layers, "
            f"{len(params)} params, {len(states)} states"
        )
    for i, (layer, p, s) in enumerate(zip(layers, params, states)):
        _load(layer, p, s, f"layer {i} ({layer_name(layer)})")
    return layers
