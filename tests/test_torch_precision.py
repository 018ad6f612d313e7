"""Mixed precision (``precision.apply_policy``, ``GPipe(compute_dtype=)``,
``DynamicLossScale``) against the JAX reference.

The same small layers and weights go through the reference's
``apply_policy`` and the port's, with bfloat16 compute over float32
masters: the output dtypes, the masters' dtypes, the norms' float32
upcast, and the outputs.  Then ``GPipe(compute_dtype=bfloat16)`` on a
tiny Llama (2 blocks, dim 128) and on a tiny ResNet with deferred batch
norm, against the reference ``GPipe(compute_dtype=jnp.bfloat16)``:
loss and every gradient, all float32.

Tolerances.  bfloat16 keeps 8 significant bits: each rounding moves a
value by up to 2^-9 of itself.  The port runs op by op and rounds after
every operation, as the reference's policy layers do when applied one
at a time (the port's ResNet forward below agrees with that within
2^-6; on these inputs it is bitwise).  The reference's ``GPipe`` runs
each stage as one XLA program, whose fusions keep chains of bfloat16
elementwise operations in float32 and round once, so the two sides
part by a bfloat16 ulp (2^-8 relative) at many places, carried forward
and back.  Measured on these models: gradients part by at most 2.1e-2
of a leaf's max |value| and 2.0e-2 in relative L2 norm (the Llama's
``ln1`` and ``wq``).  Gates: 5e-2 and 4e-2, about twice that; the loss
within 1e-2 relative; a layer's outputs within 2^-6 of max(|ref|, 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import precision as jprec
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.layers import apply_layer, named
from torchgpipe_tpu.models import resnet as jresnet
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu.skip import pop_add as jpop_add
from torchgpipe_tpu.skip import stash as jstash
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import precision as tprec
from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm, convert_deferred_batch_norm
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import resnet as tresnet
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.precision import unwrap
from torchgpipe_tpu_torch.skip import Namespace, SkipSequential
from torchgpipe_tpu_torch.skip import pop_add as tpop_add
from torchgpipe_tpu_torch.skip import stash as tstash
from tests.torch_parity import _ref_leaf, flat, jax_mean_loss, jax_trees, nchw, per_stage

OUT_TOL, LOSS_RTOL, GRAD_MAX_TOL, GRAD_L2_TOL = 2 ** -6, 1e-2, 5e-2, 4e-2


def _mlp():
    gen = torch.Generator().manual_seed(0)
    t = [tnn.dense(8, 16, device="cpu", generator=gen),
         tnn.layer_norm(16, device="cpu"), tnn.gelu(),
         tnn.dense(16, 6, device="cpu", generator=gen)]
    with torch.no_grad():
        t[1].scale.uniform_(0.5, 1.5, generator=gen)
        t[1].bias.uniform_(-0.5, 0.5, generator=gen)
    j = [jnn.dense(16), jnn.layer_norm(), jnn.gelu(), jnn.dense(6)]
    jp = [{"w": t[0].w.detach().numpy(), "b": t[0].b.detach().numpy()},
          {"scale": t[1].scale.detach().numpy(), "bias": t[1].bias.detach().numpy()},
          (), {"w": t[3].w.detach().numpy(), "b": t[3].b.detach().numpy()}]
    return t, j, jp


def _jax_forward(layers, params, x):
    for layer, p in zip(layers, params):
        x, _ = layer.apply(p, (), x)
    return x


def test_policy_dtypes_masters_and_outputs_match_jax():
    t, j, jp = _mlp()
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    jout = _jax_forward(jprec.apply_policy(j, jnp.bfloat16), jp, x)
    policy = tprec.apply_policy(t, torch.bfloat16)
    seen = {}
    policy[1].layer.register_forward_hook(
        lambda m, inp, out: seen.update(norm_in=inp[0].dtype, norm_out=out.dtype))
    out = torch.nn.Sequential(*policy)(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    # The norm computes on a float32 upcast and hands back bfloat16.
    assert seen == {"norm_in": torch.float32, "norm_out": torch.float32}
    assert [type(m).__name__ for m in policy] == [
        "ComputeIn", "NormIn32", "ComputeIn", "ComputeIn"]
    assert all(p.dtype == torch.float32 for m in policy for p in m.parameters())
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().detach().numpy(), want, rtol=0,
                               atol=OUT_TOL * max(np.abs(want).max(), 1.0))
    out.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for m in policy for p in m.parameters())
    # The wrapper keeps the layer's name; float32 changes nothing; a
    # second application wraps nothing twice.
    assert [m.name for m in policy] == [m.name for m in t]
    assert tprec.apply_policy(t, torch.float32) == t
    assert tprec.apply_policy(policy, torch.bfloat16) == policy


def test_policy_recurses_into_compound_layers_and_keeps_skips():
    layers = list(tresnet.build_resnet([1, 1, 1, 1], 10, base_width=4, device="cpu"))
    params, states = jax_trees(layers)
    policy = tprec.apply_policy(layers, torch.bfloat16)
    residual = next(m for m in policy if isinstance(m, tresnet.Residual) and m.down is not None)
    assert [type(c).__name__ for c in residual.down] == ["ComputeIn", "NormIn32"]
    stash = next(m for m in policy if getattr(m, "stash", ()))
    assert isinstance(stash, tprec.ComputeIn) and stash.stash == stash.layer.stash
    assert [getattr(m, "name", None) for m in policy] == [getattr(m, "name", None) for m in layers]
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    y = SkipSequential(*policy)(nchw(x))
    assert y.dtype == torch.bfloat16 and y.shape == (3, 10)
    # The reference's policy layers one at a time (op by op, as the port
    # runs them), from the same weights, in train mode.
    jx, skips = jnp.asarray(x), {}
    for layer, p, st in zip(jprec.apply_policy(jresnet.build_resnet(
            [1, 1, 1, 1], 10, base_width=4), jnp.bfloat16), params, states):
        jx, _ = apply_layer(layer, p, st, jx, skips, train=True)
    want = np.asarray(jx.astype(jnp.float32))
    np.testing.assert_allclose(y.float().detach().numpy(), want, rtol=0,
                               atol=OUT_TOL * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------- #
# GPipe(compute_dtype=bfloat16) against the reference                    #
# ---------------------------------------------------------------------- #

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


def _assert_grads(got, want, what):
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    assert got.dtype == torch.float32, what
    g = got.detach().numpy()
    np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_MAX_TOL * scale, err_msg=what)
    l2 = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
    assert l2 <= GRAD_L2_TOL, (what, l2)


def _lm_loss_jax(out, tokens):
    return jt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


def _lm_loss_torch(out, tokens):
    return tt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


def test_gpipe_compute_dtype_llama_matches_jax():
    tokens = np.random.default_rng(1).integers(0, KW["vocab"], (4, 16)).astype(np.int32)
    jpipe = JGPipe(jt.llama(JCFG), [2, 2], chunks=2, devices=[jax.devices()[0]],
                   compute_dtype=jnp.bfloat16)
    params, state = jpipe.init(jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct(tokens.shape, jnp.int32))
    jloss, jgrads, _, _ = jpipe.value_and_grad(params, state, tokens, tokens,
                                               _lm_loss_jax)
    flat_params = [jax.tree_util.tree_map(np.asarray, p) for s in params for p in s]
    pipe = GPipe(params_from_jax(TCFG, flat_params, device="cpu"), [2, 2],
                 devices=["cpu"], chunks=2, compute_dtype=torch.bfloat16)
    t = torch.from_numpy(tokens)
    loss, grads, _ = pipe.value_and_grad(t, t, _lm_loss_torch)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jflat = [jax.tree_util.tree_map(np.asarray, g) for s in jgrads for g in s]
    for li, (stage_layer, jg) in enumerate(zip([g for s in grads for g in s], jflat)):
        for name, g in stage_layer.items():
            _assert_grads(g, jg[name.removeprefix("layer.")], f"layer {li} {name}")
    # The float32 run of the same weights is far from both.
    f32 = GPipe(params_from_jax(TCFG, flat_params, device="cpu"), [2, 2],
                devices=["cpu"], chunks=2)
    assert abs(f32.value_and_grad(t, t, _lm_loss_torch)[0].item() - loss.item()) > 1e-4


def _conv_layers():
    """tests/test_fused.py's model without its dropout: a convolution, a
    skip across a BatchNorm and a second convolution, pooling and a
    classifier; the port's layers (seeded) and the reference's."""
    gen = torch.Generator().manual_seed(3)
    ns = Namespace()
    t = [tnn.conv2d(3, 8, (3, 3), name="c1", device="cpu", generator=gen),
         tstash("res", ns=ns), tnn.batch_norm(8, name="bn1", device="cpu"), tnn.relu(),
         tnn.conv2d(8, 8, (3, 3), name="c2", device="cpu", generator=gen),
         tpop_add("res", ns=ns), tnn.global_avg_pool(),
         tnn.dense(8, 5, name="head", device="cpu", generator=gen)]
    j = named([jnn.conv2d(8, (3, 3), name="c1"), jstash("res"), jnn.batch_norm(name="bn1"),
               jnn.relu(), jnn.conv2d(8, (3, 3), name="c2"), jpop_add("res"),
               jnn.global_avg_pool(), jnn.dense(5, name="head")])
    return t, j


def test_gpipe_compute_dtype_conv_deferred_bn_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, (12,)).astype(np.int32)
    t, j = _conv_layers()
    t = convert_deferred_batch_norm(t, 3)
    params, states = jax_trees(t)
    jpipe = JGPipe(j, [4, 4], chunks=3, deferred_batch_norm=True,
                   compute_dtype=jnp.bfloat16, devices=[jax.devices()[0]])
    jloss, jgrads, jstate, _ = jpipe.value_and_grad(
        per_stage(jpipe, params), per_stage(jpipe, states), x, y, jax_mean_loss)
    pipe = GPipe(t, [4, 4], devices=["cpu"], chunks=3, deferred_batch_norm=True,
                 compute_dtype=torch.bfloat16)
    loss, grads, _ = pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(),
                                         lambda o, t: F.cross_entropy(o.float(), t))
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for i, (layer, jg) in enumerate(zip([g for s in grads for g in s], flat(jgrads))):
        for name, g in layer.items():
            _assert_grads(g, _ref_leaf(jg, name.replace("layer.", "")), f"layer {i} {name}")
    # The deferred statistics stay float32 and were committed once: the
    # counters are back at 0 and the running statistics moved.
    bn = unwrap(pipe[2])
    assert isinstance(bn, DeferredBatchNorm) and bn.sum.dtype == torch.float32
    assert int(bn.tracked) == 0 and bn._tracked == 0
    jbn = flat(jstate)[2]
    assert int(jbn["tracked"]) == 0
    for key in ("mean", "var"):
        want = np.asarray(jbn[key])
        np.testing.assert_allclose(getattr(bn, key).numpy(), want, rtol=0,
                                   atol=OUT_TOL * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------- #
# DynamicLossScale                                                       #
# ---------------------------------------------------------------------- #


def test_dynamic_loss_scale_matches_jax():
    kw = dict(scale=2.0 ** 4, growth_interval=3, min_scale=2.0, max_scale=2.0 ** 6)
    j, t = jprec.DynamicLossScale(**kw), tprec.DynamicLossScale(**kw)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert tprec.DynamicLossScale().state_dict() == jprec.DynamicLossScale().state_dict()
    for op in "ok ok ok ok bad ok ok ok ok ok ok ok ok bad bad bad bad ok".split():
        j, t = getattr(j, op)(), getattr(t, op)()
        assert t.state_dict() == j.state_dict(), op
    assert tprec.DynamicLossScale.from_state_dict(j.state_dict()) == t
    assert jprec.DynamicLossScale.from_state_dict(t.state_dict()) == j
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.scale = 1.0
    loss = torch.tensor(0.75)
    assert t.scale_loss(loss).item() == float(j.scale_loss(jnp.float32(0.75)))
    grads = ([{"w": torch.tensor([2.0, -4.0]), "n": torch.tensor([3])}],
             [{"b": torch.tensor([1.0], dtype=torch.bfloat16)}])
    jg = jax.tree_util.tree_map(lambda g: jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if g.dtype == torch.bfloat16 else
        (jnp.int32 if not g.is_floating_point() else jnp.float32)), grads)
    out, jout = t.unscale(grads), j.unscale(jg)
    assert out[1][0]["b"].dtype == torch.bfloat16 and torch.equal(out[0][0]["n"], grads[0][0]["n"])
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, dtype=np.float32))


def test_policy_in_float64_agrees_with_float32_resnet():
    """The policy's machinery on a deep model: with float64 compute (the
    masters float32, the norms float32) a tiny ResNet's loss and
    gradients agree with plain float32 as far as float32 is itself
    accurate there.  Its BatchNorm backwards amplify each rounding (in
    bf16 the gradients part from float32 by more than their size), so
    the gate is the float32 rounding amplified: relative L2 over all
    leaves within 1e-3, loss within 1e-5 relative (measured 2.0e-5 and
    7.5e-7 here); a wrapper that dropped a cast's gradient or computed
    in the wrong dtype misses both by orders of magnitude."""
    layers = convert_deferred_batch_norm(list(tresnet.build_resnet(
        [1, 1, 1, 1], 10, base_width=4, device="cpu",
        generator=torch.Generator().manual_seed(5))), 3)
    state = [{k: v.clone() for k, v in layer.state_dict().items()} for layer in layers]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((12, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (12,)))
    runs = []
    for dtype in (None, torch.float64):
        for layer, st in zip(layers, state):
            layer.load_state_dict(st)
        pipe = GPipe(layers, [20, 30], devices=["cpu"], chunks=3, deferred_batch_norm=True,
                     compute_dtype=dtype)
        loss, _, _ = pipe.value_and_grad(x, y, lambda o, t: F.cross_entropy(o.float(), t))
        runs.append((loss.item(), [p.grad.clone() for p in pipe.parameters()]))
    (l32, g32), (l64, g64) = runs
    assert all(g.dtype == torch.float32 for g in g64)
    diff = sum((a - b).double().square().sum() for a, b in zip(g64, g32))
    norm = sum(b.double().square().sum() for b in g32)
    assert abs(l64 - l32) <= 1e-5 * abs(l32)
    assert (diff / norm).sqrt().item() <= 1e-3
