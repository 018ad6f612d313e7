"""torchgpipe_tpu_torch.models.moe and auxgrad against the JAX reference,
with ``transformer_block(mlp=)``.

Configs: the reference's ``tests/test_moe.py`` tiny float32 model
(vocab 64, dim 16, 2 blocks, 2 heads, so the expert hidden is 128), 4
experts, weights drawn by the reference's init and loaded through
``convert`` (``params_from_jax(moe=)``, ``layers_from_jax``); inputs from
numpy seeds.

Tolerances.  Both sides compute the same float32 network in another
summation order: products over 16-128 terms and a softmax over 4
experts, ~1e-7 relative per op.  A layer's output is held to 1e-5 of its
max |value| and its gradients to 1e-4 of each leaf's max (the backward
sums over up to 64 tokens and two products more).  Routing must be
IDENTICAL on both sides (an argmax over probabilities that differ by
~1e-7 flips only at a near-tie, which these seeds do not have): the
assignment helpers are compared exactly, and a flipped route would move
an output by O(1), far past the tolerance.  Through the pipelines (two
blocks, a head over 64 logits, the micro-batch sums in another grouping)
losses agree to 1e-5 relative and gradients to 1e-4 of each leaf's max
with a floor of 1e-3 of the largest leaf's (``bk``-like leaves whose
gradient is 0 in exact arithmetic), as ``tests/test_torch_arch_knobs.py``
derives.  The injected balance gradient of the probe layer is a
product of float32 constants, held to 1e-6 relative as the reference
holds it.  Greedy tokens and the Engine's streams must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.layers import Layer, sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import moe as jm
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.serving import Engine as JEngine
from torchgpipe_tpu_torch import GPipe, precision
from torchgpipe_tpu_torch.convert import layers_from_jax, params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import moe as tm
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.serving import Engine
from tests.torch_parity import assert_trees_close, grad_of, ref_tree

OUT_REL, GRAD_REL, LOSS_RTOL, ZERO_FLOOR = 1e-5, 1e-4, 1e-5, 1e-3
KW = dict(vocab=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


def _moes(**kw):
    return jm.MoEConfig(**kw), tm.MoEConfig(**kw)


def _layer(moe_kw, x_shape, seed=0):
    """A reference ``moe_mlp`` and the port's holding its weights."""
    jmoe, tmoe = _moes(**moe_kw)
    jl = jm.moe_mlp(JCFG, jmoe)
    params, _ = jl.init(jax.random.PRNGKey(seed), jax.ShapeDtypeStruct(x_shape, jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tl = tm.MoEMLP(TCFG, tmoe, device="cpu")
    layers_from_jax([tl], [params], [()])
    return jl, params, tl


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


# ---------------------------------------------------------------------- #
# the layer                                                              #
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("dispatch", ["dense", "sparse", "dropless", "auto"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_mlp_output_and_grads_match_jax(dispatch, top_k, capacity_factor):
    """Every dispatch, with and without capacity drops (0.5: real drops,
    where a wrong FCFS slot order would show), outputs and gradients of
    ``sum(y^2)`` in the params and the input."""
    x = _x((2, 16, 16), 3)
    jl, params, tl = _layer(dict(n_experts=4, top_k=top_k, dispatch=dispatch,
                                 capacity_factor=capacity_factor), x.shape)

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, (), xx)[0] ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_y = np.asarray(jl.apply(jp, (), jnp.asarray(x))[0])
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tl(xt)
    _close(y.detach().numpy(), want_y, OUT_REL, "y")
    (y ** 2).sum().backward()
    _close(xt.grad.numpy(), gx, GRAD_REL, "dx")
    assert_trees_close(ref_tree(tl, grad_of)[0], jax.tree_util.tree_map(np.asarray, gp),
                       GRAD_REL, "grads")


def test_expert_choice_matches_jax():
    x = _x((2, 8, 16), 4)
    jl, params, tl = _layer(dict(n_experts=4, router="expert_choice",
                                 capacity_factor=1.0), x.shape)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    gp = jax.grad(lambda p: jnp.sum(jl.apply(p, (), jnp.asarray(x))[0] ** 2))(jp)
    y = tl(torch.from_numpy(x))
    _close(y.detach().numpy(), jl.apply(jp, (), jnp.asarray(x))[0], OUT_REL, "y")
    (y ** 2).sum().backward()
    assert float(tl.router.grad.abs().max()) > 1e-3     # the router learns
    assert_trees_close(ref_tree(tl, grad_of)[0], jax.tree_util.tree_map(np.asarray, gp),
                       GRAD_REL, "grads")


def test_moe_capacity_drops_tokens():
    """E=1, C=1: only the first token gets a slot; every later token falls
    back to the residual (zero MLP output)."""
    _, _, tl = _layer(dict(n_experts=1, top_k=1, capacity_factor=1e-9), (1, 6, 16))
    y = tl(torch.from_numpy(_x((1, 6, 16), 1)))[0].detach()
    assert y[0].abs().max() > 0
    assert torch.equal(y[1:], torch.zeros_like(y[1:]))


def test_dropless_never_drops_under_imbalance():
    """A router biased to expert 0 at capacity factor 0.25: the sparse
    path drops, the dropless one equals the generous dense run."""
    x = torch.from_numpy(_x((2, 16, 16), 7))
    outs = {}
    for dispatch, cf in (("dropless", 0.25), ("sparse", 0.25), ("dense", 8.0)):
        _, _, tl = _layer(dict(n_experts=4, top_k=1, dispatch=dispatch,
                               capacity_factor=cf), tuple(x.shape))
        with torch.no_grad():
            tl.router[:, 0] += 10.0
        outs[dispatch] = tl(x).detach().numpy()
    _close(outs["dropless"], outs["dense"], OUT_REL, "dropless vs dense")
    assert np.abs(outs["sparse"] - outs["dense"]).max() > 1e-3


def _one_expert_probs(t=8, E=4, expert=2):
    logits = np.zeros((t, E), np.float32)
    logits[:, expert] += 10.0
    return jax.nn.softmax(jnp.asarray(logits), axis=-1)


@pytest.mark.parametrize("capacity", [2, 8])
def test_sparse_assignment_equals_jax(capacity):
    """FCFS slots under total overflow (capacity 2) and at the no-drop
    boundary (capacity == t), on the reference's own probabilities."""
    probs = _one_expert_probs()
    want = jm._sparse_assignment(probs, k=1, capacity=capacity)
    got = tm._sparse_assignment(torch.from_numpy(np.asarray(probs)), 1, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 2])
def test_dropless_assignment_equals_jax(k):
    """Counts, the expert-stable sort in k-major order (round 2's tie
    picks expert 0, sorting before round 1's expert 2) and the gates."""
    probs = _one_expert_probs()
    want = jm._dropless_assignment(probs, k=k)
    got = tm._dropless_assignment(torch.from_numpy(np.asarray(probs)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_select_breaks_ties_as_jax():
    """Exact ties go to the lower expert index in every round (what
    ``torch.topk`` does not promise)."""
    p = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                  [0.3, 0.1, 0.3, 0.3]], np.float32)
    wi, _, wg = jm._top_k_select(jnp.asarray(p), 3)
    gi, _, gg = tm._top_k_select(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_router_stats_match_jax(router):
    x = _x((2, 8, 16), 3)
    jmoe, tmoe = _moes(n_experts=4, top_k=1, router=router)
    r = _x((16, 4), 9)
    want = jm.router_stats(jnp.asarray(r), jnp.asarray(x), jmoe)
    got = tm.router_stats(torch.from_numpy(r), torch.from_numpy(x), tmoe)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_router_stats_count_selections_pre_capacity():
    dim, E = 16, 4
    router = torch.zeros(dim, E)
    router[:, 0] = 1.0
    x = torch.ones(2, 4, dim)
    tight = tm.MoEConfig(n_experts=E, top_k=1, capacity_factor=0.25)
    loose = tm.MoEConfig(n_experts=E, top_k=1, capacity_factor=8.0)
    load, importance, penalty = tm.router_stats(router, x, tight)
    assert load.tolist() == [1.0, 0.0, 0.0, 0.0]
    assert float(penalty) == pytest.approx(E * float(importance[0]))
    for a, b in zip((load, importance, penalty), tm.router_stats(router, x, loose)):
        assert torch.equal(a, b)


def test_balance_weight_injects_exact_aux_gradient():
    """``balance_weight=w`` gives the gradients of ``task + w * penalty``
    (the penalty differentiated explicitly), the loss value staying the
    task loss; and the same gradients as the reference's injection."""
    w = 0.3
    x = _x((2, 8, 16), 4)
    on = dict(n_experts=4, top_k=2, capacity_factor=8.0, balance_weight=w)
    jl, params, tl = _layer(on, x.shape)
    _, _, off = _layer(dict(on, balance_weight=0.0), x.shape)
    xt = torch.from_numpy(x)
    loss_on = (tl(xt) ** 2).sum()
    loss_on.backward()
    loss_off = (off(xt) ** 2).sum() + w * tm.router_stats(off.router, xt, off.moe)[2]
    loss_off.backward()
    assert float(loss_on) == pytest.approx(float((off(xt) ** 2).sum()), rel=1e-6)
    assert_trees_close(ref_tree(tl, grad_of)[0], ref_tree(off, grad_of)[0],
                       5e-5, "injected vs explicit")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    gp = jax.grad(lambda p: jnp.sum(jl.apply(p, (), jnp.asarray(x), train=True)[0] ** 2))(jp)
    assert_trees_close(ref_tree(tl, grad_of)[0], jax.tree_util.tree_map(np.asarray, gp),
                       GRAD_REL, "vs jax")


def test_no_injection_outside_training():
    """``train=False`` (eval mode; what generation runs) injects nothing."""
    x = torch.from_numpy(_x((2, 8, 16), 4))
    _, _, tl = _layer(dict(n_experts=4, top_k=2, balance_weight=0.5), tuple(x.shape))
    _, _, off = _layer(dict(n_experts=4, top_k=2), tuple(x.shape))
    tl.eval()
    (tl(x) ** 2).sum().backward()
    (off(x) ** 2).sum().backward()
    assert torch.equal(tl.router.grad, off.router.grad)


# ---------------------------------------------------------------------- #
# aux scale through the pipeline                                         #
# ---------------------------------------------------------------------- #


class AuxProbe(nn.Module):
    """Identity injecting aux = its scalar parameter with weight ``w``:
    d(objective)/d(p) through the pipeline must be exactly ``w`` (each of
    the m cells injects ``w / m``)."""

    def __init__(self, w):
        super().__init__()
        self.w = w
        self.p = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return tm.add_aux_grad(x, self.p, self.w) if self.training else x


def _probe_pipe(chunks, **kw):
    torch.manual_seed(0)
    layers = [nn.Linear(8, 8), AuxProbe(0.25), nn.Linear(8, 8)]
    return GPipe(layers, kw.pop("balance", [3]), devices=["cpu"], chunks=chunks, **kw)


@pytest.mark.parametrize(
    "batch,chunks,kw",
    [(8, 2, {}), (8, 4, {}), (8, 4, {"fused": True}), (6, 4, {}), (3, 4, {}),
     (8, 4, {"checkpoint": "always"}), (8, 4, {"checkpoint": "never"}),
     (8, 4, {"checkpoint": "offload"}), (6, 4, {"balance": [1, 2]}),
     (8, 4, {"schedule": "1f1b", "loss_reduction": "mean", "balance": [1, 2]}),
     (3, 4, {"schedule": "1f1b", "loss_reduction": "mean"})],
)
def test_aux_grad_scale_is_chunk_invariant(batch, chunks, kw):
    """The injection is weighted by the exact ``1/m`` of the run (a
    ragged batch has fewer micro-batches than ``chunks``) on fill-drain,
    1F1B, every checkpoint mode (the recompute inside the backward sees
    the forward's scale), 'offload' and the fused step."""
    pipe = _probe_pipe(chunks, **kw)
    g = torch.Generator().manual_seed(1)
    x, tgt = torch.randn(batch, 8, generator=g), torch.randn(batch, 8, generator=g)
    _, grads, _ = pipe.value_and_grad(x, tgt, lambda o, t: ((o - t) ** 2).mean())
    probe = [layer for part in pipe.partitions for layer in part][1]
    assert float(probe.p.grad) == pytest.approx(0.25, rel=1e-6)


def test_aux_grad_scale_in_a_megastep():
    """The fused megastep's steps inject ``w`` each (SGD lr 1: p moves by
    -w a step)."""
    pipe = _probe_pipe(4, fused=True, megastep=2)
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=1.0),
                                lambda o, t: ((o - t) ** 2).mean())
    g = torch.Generator().manual_seed(1)
    xs, ts = torch.randn(2, 8, 8, generator=g), torch.randn(2, 8, 8, generator=g)
    step(xs, ts)
    probe = [layer for part in pipe.partitions for layer in part][1]
    assert float(probe.p) == pytest.approx(-0.5, rel=1e-6)


def test_aux_scale_is_restored():
    from torchgpipe_tpu_torch import auxgrad

    assert auxgrad.current_aux_scale() == 1.0
    with auxgrad.aux_scale(0.25):
        assert auxgrad.current_aux_scale() == 0.25
    assert auxgrad.current_aux_scale() == 1.0


# ---------------------------------------------------------------------- #
# the MoE model: pipeline, generation, serving                           #
# ---------------------------------------------------------------------- #


MOE = dict(n_experts=4, top_k=2, capacity_factor=2.0, balance_weight=0.05)


@pytest.fixture(scope="module")
def moe_model():
    """Reference ``llama_moe`` params (numpy, flat per layer) of a
    dropless and a capacity config (the same weights)."""
    jmoe, _ = _moes(**MOE)
    params, _, _ = sequential_init(jm.llama_moe(JCFG, jmoe), jax.random.PRNGKey(0),
                                   jax.ShapeDtypeStruct((4, 8), jnp.int32))
    return [jax.tree_util.tree_map(np.asarray, p) for p in params]


def _ce_j(out, tok):
    return jt.cross_entropy(out[:, :-1], tok[:, 1:])


def _ce_t(out, tok):
    return tt.cross_entropy(out[:, :-1], tok[:, 1:])


@pytest.mark.parametrize(
    "batch,chunks,kw",
    [(4, 2, {"checkpoint": "except_last"}), (4, 2, {"checkpoint": "always"}),
     (4, 2, {"schedule": "1f1b", "loss_reduction": "mean", "checkpoint": "never"}),
     (3, 4, {"checkpoint": "except_last"})],
)
def test_gpipe_balance_gradients_match_jax(moe_model, batch, chunks, kw):
    """``llama_moe`` with a balance weight through ``GPipe.value_and_grad``
    on two stages against the reference's ``GPipe``: the loss and every
    gradient (the router's carry the injected penalty, weighted 1/m per
    cell, under the port's recompute and on a ragged batch, 3 rows over
    4 chunks)."""
    jmoe, tmoe = _moes(**MOE)
    flat = moe_model
    tok = np.random.default_rng(5).integers(0, 64, (batch, 8)).astype(np.int32)
    jpipe = JGPipe(jm.llama_moe(JCFG, jmoe), balance=[2, 2], chunks=chunks, **kw)
    jparams = jpipe.place((
        [jax.tree_util.tree_map(jnp.asarray, p) for p in flat[:2]],
        [jax.tree_util.tree_map(jnp.asarray, p) for p in flat[2:]]))
    jstate = jpipe.place(([(), ()], [(), ()]))
    jloss, jgrads, _, _ = jpipe.value_and_grad(jparams, jstate, jnp.asarray(tok),
                                               jnp.asarray(tok), _ce_j)
    model = params_from_jax(TCFG, flat, device="cpu", moe=tmoe)
    pipe = GPipe(list(model), [2, 2], devices=["cpu"], chunks=chunks, **kw)
    loss, _, _ = pipe.value_and_grad(torch.from_numpy(tok).long(),
                                     torch.from_numpy(tok).long(), _ce_t)
    if isinstance(loss, torch.Tensor) and loss.ndim == 0:
        assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = [jax.tree_util.tree_map(np.asarray, p) for s in jgrads for p in s]
    got = [ref_tree(layer, grad_of)[0] for layer in model]
    scale = max(np.abs(leaf).max() for t in want for leaf in jax.tree_util.tree_leaves(t))
    assert_trees_close(got, want, GRAD_REL, "grads", floor=ZERO_FLOOR * scale)
    assert float(np.abs(got[1]["mlp"]["router"]).max()) > 0


def test_llama_moe_shapes_and_router_dtype_match_jax(moe_model):
    """The port's own init has the reference's tree, the router float32
    in a bf16 model, through ``convert`` and the precision policy too."""
    _, tmoe = _moes(**MOE)
    shape = lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1])  # noqa: E731
    ours = tm.llama_moe(TCFG, tmoe, device="cpu")
    assert [ref_tree(layer, shape)[0] for layer in ours] == \
        [jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), p) for p in moe_model]
    bcfg = tt.TransformerConfig(**KW, dtype=torch.bfloat16)
    bf = params_from_jax(bcfg, moe_model, device="cpu", moe=tmoe)
    assert bf[1].mlp.router.dtype == torch.float32
    assert bf[1].mlp.w_gate.dtype == torch.bfloat16
    assert [r.dtype for r in tm.find_routers(bf)] == [torch.float32] * 2
    assert len(tm.find_routers(moe_model)) == 2
    # Under a bf16 policy the router is not cast: routing reads float32.
    wrapped = precision.apply_policy(list(ours), torch.bfloat16)[1]
    seen = {}
    orig = tm.moe_forward

    def spy(moe, p, x, train=True):
        seen["router"] = p["router"].dtype
        return orig(moe, p, x, train=train)

    tm.moe_forward = spy
    try:
        wrapped(torch.zeros(1, 4, 16, dtype=torch.bfloat16))
    finally:
        tm.moe_forward = orig
    assert seen["router"] == torch.float32


@pytest.mark.parametrize("dispatch", ["dropless", "auto"])
def test_generate_moe_equals_jax(moe_model, dispatch):
    """``prefill`` logits and greedy ``generate`` tokens (and beam search
    at one beam) of the MoE model, ``moe=`` on both sides."""
    jmoe, tmoe = _moes(**dict(MOE, dispatch=dispatch))
    prompt = np.random.default_rng(1).integers(0, 64, (3, 6)).astype(np.int32)
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in moe_model]
    model = params_from_jax(TCFG, moe_model, device="cpu", moe=tmoe)
    want_l, _ = jg.prefill(JCFG, jp, jnp.asarray(prompt), 16, moe=jmoe)
    got_l, _ = tg.prefill(TCFG, model, prompt, 16, moe=tmoe, device="cpu")
    _close(got_l.numpy(), want_l, OUT_REL, "prefill logits")
    want = np.asarray(jg.generate(JCFG, jp, jnp.asarray(prompt), 8, moe=jmoe))
    got = tg.generate(TCFG, model, prompt, 8, moe=tmoe, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    beams, _ = tg.beam_search(TCFG, model, prompt, 8, num_beams=1, moe=tmoe, device="cpu")
    np.testing.assert_array_equal(beams.numpy(), want)


def test_speculative_with_moe_draft_equals_greedy(moe_model):
    """A MoE target with itself as a MoE draft (``draft_moe=``) gives the
    greedy tokens of ``generate``, as the reference's does."""
    jmoe, tmoe = _moes(**dict(MOE, dispatch="dropless"))
    prompt = np.random.default_rng(2).integers(0, 64, (2, 5)).astype(np.int32)
    model = params_from_jax(TCFG, moe_model, device="cpu", moe=tmoe)
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in moe_model]
    want = np.asarray(jg.generate(JCFG, jp, jnp.asarray(prompt), 7, moe=jmoe))
    got = tg.speculative_generate(TCFG, model, TCFG, model, prompt, 7, gamma=2,
                                  moe=tmoe, draft_moe=tmoe, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_params_need_moe_as_jax(moe_model):
    _, tmoe = _moes(**MOE)
    model = params_from_jax(TCFG, moe_model, device="cpu", moe=tmoe)
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="pass moe=MoEConfig"):
        tg.generate(TCFG, model, prompt, 2, device="cpu")
    with pytest.raises(ValueError, match="pass moe=MoEConfig"):
        params_from_jax(TCFG, moe_model, device="cpu")


@pytest.mark.parametrize("dispatch", ["dropless", "sparse"])
def test_engine_moe_streams_equal_jax(moe_model, dispatch):
    """The serving Engine on the MoE model, ``moe=`` on both sides: a
    staggered trace of prompts of several lengths, chunked prefill and
    decode at per-slot frontiers; every stream equal, and equal program
    counts."""
    jmoe, tmoe = _moes(**dict(MOE, dispatch=dispatch))
    jp = [jax.tree_util.tree_map(jnp.asarray, p) for p in moe_model]
    model = params_from_jax(TCFG, moe_model, device="cpu", moe=tmoe)
    kw = dict(num_slots=3, max_len=32, prefill_chunk=4)
    je, te = JEngine(JCFG, jp, moe=jmoe, **kw), Engine(TCFG, model, moe=tmoe,
                                                       device="cpu", **kw)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 64, (int(rng.randint(2, 9)),)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(5)]
    jids, tids = [], []
    for i, (p, n) in enumerate(reqs):
        jids.append(je.submit(p, n))
        tids.append(te.submit(p, n))
        if i % 2:
            je.step()
            te.step()
    je.run()
    te.run()
    for a, b in zip(jids, tids):
        np.testing.assert_array_equal(te.result(b), np.asarray(je.result(a)))
    assert te.compile_stats == je.compile_stats


def test_engine_refuses_expert_choice(moe_model):
    _, tmoe = _moes(n_experts=4, router="expert_choice")
    model = params_from_jax(TCFG, moe_model, device="cpu", moe=tm.MoEConfig(n_experts=4))
    with pytest.raises(ValueError, match="token-choice routing"):
        Engine(TCFG, model, num_slots=2, max_len=16, moe=tmoe, device="cpu")


# ---------------------------------------------------------------------- #
# validation, mlp=                                                       #
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "kw",
    [dict(n_experts=2, top_k=3), dict(dispatch="ragged"), dict(router="hash"),
     dict(dispatch="dropless", ep_axis="ep"),
     dict(router="expert_choice", ep_axis="ep"),
     dict(router="expert_choice", balance_weight=0.1)],
)
def test_validation_errors_match_jax(kw):
    jmoe, tmoe = _moes(**kw)
    with pytest.raises(ValueError) as je:
        jm.moe_mlp(JCFG, jmoe)
    with pytest.raises(ValueError) as te:
        tm.MoEMLP(TCFG, tmoe, device="cpu")
    assert str(te.value) == str(je.value)


def test_ep_axis_is_not_ported_yet():
    """``MoEConfig(ep_axis=)`` is ported (it used to raise item 5.4): the
    layer declares the reference's meta, the expert leaves sharded over
    the ep axis and the router replicated; the ep-parallel step itself is
    held against the reference in tests/test_torch_spmd_moe_ep.py."""
    layer = tm.moe_mlp(TCFG, tm.MoEConfig(ep_axis="ep"), device="cpu")
    jmeta = jm.moe_mlp(JCFG, jm.MoEConfig(ep_axis="ep")).meta
    assert layer.meta["ep_axis"] == jmeta["ep_axis"] == "ep"
    assert {k: tuple(v) for k, v in layer.meta["param_specs"].items()} == \
        {k: tuple(v) for k, v in jmeta["param_specs"].items()}
    assert layer.meta["moe"] == jmeta["moe"]


def test_llama_moe_refuses_a_tie_as_jax():
    kw = dict(KW, tie_embeddings=True)
    with pytest.raises(ValueError) as je:
        jm.llama_moe(jt.TransformerConfig(**kw), jm.MoEConfig())
    with pytest.raises(ValueError) as te:
        tm.llama_moe(tt.TransformerConfig(**kw), tm.MoEConfig(), device="cpu")
    assert str(te.value) == str(je.value)


class _Gelu(nn.Module):
    """A custom stateless feed-forward, the counterpart of the Layer
    below."""

    def __init__(self):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(16, 32))
        self.w2 = nn.Parameter(torch.zeros(32, 16))

    def forward(self, h):
        return torch.nn.functional.gelu(h @ self.w1) @ self.w2


def _jax_gelu_layer():
    def init(rng, spec):
        k1, k2 = jax.random.split(rng)
        return {"w1": jax.random.normal(k1, (16, 32)) * 0.25,
                "w2": jax.random.normal(k2, (32, 16)) * 0.25}, ()

    def apply(p, state, h, *, rng=None, train=True):
        return jax.nn.gelu(h @ p["w1"], approximate=False) @ p["w2"], state

    return Layer(name="gelu_mlp", init=init, apply=apply)


def test_transformer_block_custom_mlp_matches_jax():
    """``transformer_block(mlp=)``: the layer runs on the normalised
    hidden states, its params under ``"mlp"``; forward and gradients."""
    jblock = jt.transformer_block(JCFG, mlp=_jax_gelu_layer())
    x = _x((2, 8, 16), 6)
    params, _ = jblock.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    assert set(params) == {"ln1", "wq", "wk", "wv", "wo", "ln2", "mlp"}
    block = tt.transformer_block(TCFG, device="cpu", mlp=_Gelu())
    assert ref_tree(block, lambda t: tuple(t.shape))[0] == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    layers_from_jax([block], [params], [()])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jblock.apply(jp, (), jnp.asarray(x))[0]
    gp = jax.grad(lambda p: jnp.sum(jblock.apply(p, (), jnp.asarray(x))[0] ** 2))(jp)
    y = block(torch.from_numpy(x))
    _close(y.detach().numpy(), want, OUT_REL, "y")
    (y ** 2).sum().backward()
    assert_trees_close(ref_tree(block, grad_of)[0], jax.tree_util.tree_map(np.asarray, gp),
                       GRAD_REL, "grads")


def test_transformer_block_mlp_must_be_stateless():
    stateful = nn.BatchNorm1d(16)
    with pytest.raises(ValueError, match="must be stateless"):
        tt.transformer_block(TCFG, device="cpu", mlp=stateful)


def test_moe_transformer_block_is_a_block_with_moe_mlp():
    _, tmoe = _moes(n_experts=4)
    block = tm.moe_transformer_block(TCFG, tmoe, device="cpu")
    assert isinstance(block.mlp, tm.MoEMLP)
    assert sorted(block.params()["mlp"]) == ["router", "w_down", "w_gate", "w_up"]
    assert "w_gate" not in block._parameters
    y = block(torch.zeros(1, 4, 16))
    assert y.shape == (1, 4, 16)
