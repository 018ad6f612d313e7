"""Helpers shared by the parity tests of torchgpipe_tpu_torch's training
modules (skip, 1F1B, BatchNorm, ResNet): the losses on both sides and
the comparisons of a port layer list's gradients and buffers with the
reference's per-layer trees."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F


def jax_mean_loss(out, tgt):
    logp = jax.nn.log_softmax(out.astype(jnp.float32))
    return -jnp.mean(logp[jnp.arange(logp.shape[0]), tgt])


def jax_sum_loss(out, tgt):
    logp = jax.nn.log_softmax(out.astype(jnp.float32))
    return -jnp.sum(logp[jnp.arange(logp.shape[0]), tgt])


def torch_mean_loss(out, tgt):
    return F.cross_entropy(out.float(), tgt)


def torch_sum_loss(out, tgt):
    return F.cross_entropy(out.float(), tgt, reduction="sum")


def nchw(x):
    """A reference NHWC numpy batch as the port's NCHW tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def flat(per_stage):
    """A reference per-stage tree (tuple of lists) as one per-layer list
    of numpy trees."""
    return [jax.tree_util.tree_map(np.asarray, leaf) for s in per_stage for leaf in s]


def _ref_leaf(tree, name):
    """The reference leaf of a port parameter or buffer name (``w``,
    ``down.1.scale`` for a residual's downsample chain)."""
    parts = name.split(".")
    if parts[0] == "down":
        tree, parts = tree[int(parts[1])], parts[2:]
    ref = np.asarray(tree[parts[0]])
    return ref.transpose(3, 2, 0, 1) if ref.ndim == 4 else ref   # HWIO -> OIHW


def assert_grads_match(layers, jgrads, rel_tol):
    """Every parameter's ``.grad`` within ``rel_tol`` of its reference
    leaf's max |value|."""
    for i, layer in enumerate(layers):
        for name, p in layer.named_parameters():
            ref = _ref_leaf(jgrads[i], name)
            np.testing.assert_allclose(
                p.grad.numpy(), ref, rtol=0, atol=rel_tol * np.abs(ref).max(),
                err_msg=f"layer {i} {name}")


def assert_buffers_match(layers, jstates, rel_tol):
    """Every buffer within ``rel_tol`` of max(its reference's max |value|,
    1); integer counters exactly."""
    for i, layer in enumerate(layers):
        for name, b in layer.named_buffers():
            ref = _ref_leaf(jstates[i], name)
            if not b.is_floating_point():
                assert int(b) == int(ref), (i, name, int(b), int(ref))
                continue
            np.testing.assert_allclose(
                b.numpy(), ref, rtol=0, atol=rel_tol * max(np.abs(ref).max(), 1.0),
                err_msg=f"layer {i} buffer {name}")


def jax_trees(layers):
    """The reference's per-layer ``(params, states)`` (numpy trees) of a
    port layer list: the inverse of ``convert.layers_from_jax``, so a
    parity test can start both sides from the port's seeded weights."""
    pairs = [ref_tree(layer) for layer in layers]
    return [p for p, _ in pairs], [s for _, s in pairs]


def per_stage(pipe, per_layer):
    """A flat per-layer list of numpy trees as a reference ``GPipe``'s
    placed per-stage tuple."""
    out, i = [], 0
    for part in pipe.partitions:
        out.append(jax.tree_util.tree_map(jnp.asarray, list(per_layer[i:i + len(part)])))
        i += len(part)
    return pipe.place(tuple(out))


def ref_tree(layer, leaf=lambda t: t.detach().numpy()):
    """``(params, states)`` of one port layer in the reference's tree
    layout, each tensor through ``leaf``: a convolution's OIHW kernel as
    HWIO, a ``Structured`` layer's children as a dict by name, an
    ``nn.Sequential`` as a tuple, a transformer-style layer (``params()``
    dicts, nested for T5) as its dict.  ``leaf=lambda t: t.grad`` (as
    numpy) gives the gradients in the layout of the reference's."""
    from torch import nn

    from torchgpipe_tpu_torch.models.amoebanet import Structured
    from torchgpipe_tpu_torch.models.resnet import Residual
    from torchgpipe_tpu_torch.models.transformer import _Layer
    from torchgpipe_tpu_torch.ops.nn import BatchNorm, Conv2d, Dense

    def nested(d):
        return {k: nested(v) if isinstance(v, dict) else leaf(v) for k, v in d.items()}

    if isinstance(layer, _Layer):
        return nested(layer.params()), ()
    if isinstance(layer, (Conv2d, Dense)):
        p = {"w": leaf(layer.w)}
        if isinstance(layer, Conv2d):   # OIHW -> HWIO (an array, or a shape tuple)
            w = p["w"]
            p["w"] = tuple(w[i] for i in (2, 3, 1, 0)) if isinstance(w, tuple) else \
                w.transpose(2, 3, 1, 0)
        if layer.b is not None:
            p["b"] = leaf(layer.b)
        return p, ()
    if isinstance(layer, BatchNorm):
        return ({"scale": leaf(layer.scale), "bias": leaf(layer.bias)},
                {k: b if b.is_meta else b.detach().numpy().copy()
                 for k, b in layer.named_buffers()})
    if isinstance(layer, Structured):
        pairs = {k: ref_tree(c, leaf) for k, c in layer.parts.items()}
        return {k: p for k, (p, _) in pairs.items()}, {k: s for k, (_, s) in pairs.items()}
    if isinstance(layer, Residual) and layer.down is not None:
        return ref_tree(layer.down, leaf)
    if isinstance(layer, nn.Sequential):
        pairs = [ref_tree(c, leaf) for c in layer]
        return tuple(p for p, _ in pairs), tuple(s for _, s in pairs)
    assert not list(layer.parameters()), type(layer).__name__
    return (), ()


def grad_of(t):
    """A parameter's gradient as numpy (zeros where it took none)."""
    g = t.grad
    return np.zeros(tuple(t.shape), np.float32) if g is None else g.float().numpy()


def assert_trees_close(got, want, rel_tol, what, floor=0.0):
    """Same tree structure; every leaf within ``rel_tol`` of the larger
    of its reference leaf's max |value| and ``floor`` (1 for a leaf of
    all zeros with no floor)."""
    gl, gs = jax.tree_util.tree_flatten_with_path(got)
    wl, ws = jax.tree_util.tree_flatten_with_path(want)
    assert gs == ws, (what, gs, ws)
    for (path, a), (_, b) in zip(gl, wl):
        b = np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), floor) or 1.0
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=0,
                                   atol=rel_tol * scale,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
