"""torchgpipe_tpu_torch.models.vit against the JAX reference.

ViT cut to 32x32 images, patch 8 (16 patches), dim 64, 2 heads (head dim
32), depth 2, 10 classes, float32, drawn by the reference's init and
loaded into the port through ``convert.layers_from_jax``: the pipelined
forward, the loss and every gradient at two balances (the blocks'
attention without a causal mask: on the CPU the flash wrapper's plain
version and its backward), the ViT-L/16 list's length and parameter
count, and the refusals (an image size the patch does not divide;
float32 attention on the card, whose kernel takes bf16 only).

Tolerances.  One float32 network in another summation order (the patch
projection over 192 terms, attention over 16 keys, MLP over 64-256
terms, LayerNorm over 64): ~1e-7 relative per op through 2 blocks.
Logits to 1e-5 of their max, loss to 1e-5 relative, each gradient leaf
to 1e-4 of its max |value| (LayerNorm's and softmax's backward scale
the per-op error by up to ~100).  The key bias ``bk`` adds one constant
to each query's scores, which the softmax cancels: its gradient is 0 in
exact arithmetic and float32 noise (~1e-9) on both sides, so a leaf's
scale is at least 1e-3 of the largest gradient leaf's max.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import layers_from_jax
from torchgpipe_tpu_torch.models import vit as tvit
from torchgpipe_tpu_torch.ops import flash_attention as tfa
from tests.torch_parity import (
    assert_trees_close,
    flat,
    grad_of,
    jax_mean_loss,
    nchw,
    per_stage,
    ref_tree,
    torch_mean_loss,
)

# The package exports a function of the module's name: take the module.
jvit = importlib.import_module("torchgpipe_tpu.models.vit")

OUT_REL_TOL, LOSS_RTOL, GRAD_REL_TOL, ZERO_FLOOR = 1e-5, 1e-5, 1e-4, 1e-3
SMALL = dict(image_size=32, patch_size=8, dim=64, depth=2, n_heads=2, num_classes=10)
BATCH = 4


def _models():
    jl = jvit.vit(**SMALL)
    jp, js, _ = sequential_init(jl, jax.random.PRNGKey(2),
                                jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32))
    jp = [jax.tree_util.tree_map(np.asarray, p) for p in jp]
    layers = list(tvit.vit(**SMALL, device="cpu", generator=torch.Generator().manual_seed(1)))
    layers_from_jax(layers, jp, js)
    return jl, jp, js, layers


@pytest.mark.parametrize("balance", [[2, 2], [1, 2, 1]])
def test_pipelined_forward_and_gradients_match_jax(balance):
    jl, jp, js, layers = _models()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (BATCH,)).astype(np.int32)
    jpipe = JGPipe(jl, balance, chunks=2)
    jparams, jstates = per_stage(jpipe, jp), per_stage(jpipe, js)
    jout = np.asarray(jpipe.apply(jparams, jstates, jnp.asarray(x))[0])
    jloss, jgrads, _, _ = jpipe.value_and_grad(jparams, jstates, jnp.asarray(x),
                                               jnp.asarray(y), jax_mean_loss)
    pipe = GPipe(layers, balance, devices=["cpu"], chunks=2)
    out = pipe.apply(nchw(x))
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=OUT_REL_TOL * np.abs(jout).max())
    loss, _, _ = pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(), torch_mean_loss)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    got, want = [ref_tree(layer, grad_of)[0] for layer in layers], flat(jgrads)
    top = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(want))
    assert_trees_close(got, want, GRAD_REL_TOL, "grads", floor=ZERO_FLOOR * top)


def test_patchify_order_matches_jax():
    """A patch flattens as the reference's NHWC reshape does (row in the
    patch, column, channel), from the port's NCHW image."""
    jl, jp, _, layers = _models()
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref, _ = jl[0].apply(jax.tree_util.tree_map(jnp.asarray, jp[0]), (), jnp.asarray(x))
    out = layers[0](nchw(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=OUT_REL_TOL * np.abs(ref).max())


def test_vit_l16_has_the_reference_structure():
    """ViT-L/16 (Dosovitskiy et al. 2020, Table 1): 26 layers, 196
    patches, MHA at head dim 64; every layer's parameter tree and the
    parameter count equal the reference's."""
    kw = dict(image_size=224, patch_size=16, dim=1024, depth=24, n_heads=16,
              num_classes=1000)
    ours = tvit.vit(**kw, device="meta")
    cfg = ours.cfg
    assert (cfg.max_pos, cfg.head_dim, cfg.kv_heads, cfg.causal) == (196, 64, 16, False)
    ref = jvit.vit(**kw)
    jp, _, _ = jax.eval_shape(lambda: sequential_init(
        ref, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)))
    shape = lambda t: tuple(t.shape)  # noqa: E731
    assert len(ours) == len(ref) == 26
    assert [ref_tree(l, shape)[0] for l in ours] == \
        [jax.tree_util.tree_map(shape, p) for p in jp]
    n = sum(p.numel() for p in ours.parameters())
    assert n == sum(np.prod(t.shape) for t in jax.tree_util.tree_leaves(jp))


def test_refusals():
    with pytest.raises(ValueError, match="not divisible by patch_size"):
        tvit.vit_config(image_size=30, patch_size=8)
    # The card's forward kernel takes bf16 only; float32 attention there
    # is refused, never routed to the plain version.
    q = torch.zeros(1, 16, 2, 64)
    with pytest.raises(TypeError, match="flash_fwd kernel takes bfloat16 q/k/v, got "
                                        "torch.float32/torch.float32/torch.float32"):
        tfa._check_fwd_dtype(q, q, q)
    tfa._check_fwd_dtype(q.bfloat16(), q.bfloat16(), q.bfloat16())
