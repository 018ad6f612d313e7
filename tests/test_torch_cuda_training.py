"""``GPipe(fused=True)``, the megastep and ``checkpoint='offload'`` on
the card.

Needs an NVIDIA GPU; every test skips without one.  This file imports
neither JAX nor the JAX package (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_training.py

A small bf16 Llama (vocab 256, dim 256, 2 blocks, 4 heads of 64, 2 kv
heads) at batch 4, seq 128, 2 micro-batches on 2 stages, random from a
seed, through the flash kernels.  A replayed graph runs the same
kernels on the same inputs, in the same order, as the eager step, so
losses, gradients, parameters and optimizer states must be bitwise
equal; any difference is a fault, not rounding.  Each comparison runs
an eager chain and a fused chain of steps from the same weights.
"""

import functools

import numpy as np
import pytest
import torch

from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.skip import Namespace, pop_add, stash

CFG = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                           dtype=torch.bfloat16)
OPTS = {
    "sgd": functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
    "adamw": functools.partial(torch.optim.AdamW, lr=1e-3, capturable=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (fused steps are CUDA graphs there)")
    return torch.device("cuda")


def _layers(seed=0):
    return list(tt.llama(CFG, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed)))


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab, (4, 128))).cuda()


def _loss(out, target):
    tokens, scale = target if isinstance(target, tuple) else (target, None)
    loss = tt.cross_entropy(out[:, :-1], tokens[:, 1:])
    return loss if scale is None else loss * scale


def _state(pipe, optimizers=()):
    out = [t.detach().clone() for t in pipe.parameters()]
    out += [t.clone() for t in pipe.buffers()]
    out += [v.clone() for opt in optimizers for st in opt.state.values()
            for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _load(pipe, state):
    with torch.no_grad():
        for t, s in zip(list(pipe.parameters()) + list(pipe.buffers()), state):
            t.copy_(s)


def _equal(a, b):
    return all(x.shape == y.shape and torch.equal(x.nan_to_num(), y.nan_to_num())
               and torch.equal(x.isnan(), y.isnan()) for x, y in zip(a, b)) \
        and len(a) == len(b)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", list(OPTS))
def test_fused_train_step_replays_equal_the_eager_step(cuda_device, opt):
    layers = _layers()
    fused = GPipe(layers, [2, 2], chunks=2, fused=True)
    eager = GPipe(layers, [2, 2], chunks=2)   # the same parameters
    w0 = _state(eager)
    inputs = [_tokens(1), _tokens(1), _tokens(2)]

    want = []
    estep = eager.make_train_step(OPTS[opt], _loss)
    for t in inputs:
        loss, _ = estep(t, t)
        want.append((loss.clone(), [p.grad.clone() for p in eager.parameters()],
                     _state(eager, estep.optimizers)))
    _load(fused, w0)
    fstep = fused.make_train_step(OPTS[opt], _loss)
    for i, t in enumerate(inputs):
        loss, _ = fstep(t, t)
        wl, wg, ws = want[i]
        assert torch.equal(loss, wl), (opt, i)
        assert _equal([p.grad for p in fused.parameters()], wg), (opt, i)
        assert _equal(_state(fused, fstep.optimizers), ws), (opt, i)
    # One capture (the first call is its warm-up); the new tokens of the
    # third call go through the static buffers.
    assert fused.graph_stats["captures"] == 1 and fused.graph_stats["replays"] == 2


@pytest.mark.cuda
def test_fused_value_and_grad_and_apply_replay(cuda_device):
    layers = _layers(1)
    fused = GPipe(layers, [2, 2], chunks=2, fused=True)
    eager = GPipe(layers, [2, 2], chunks=2)
    for t in (_tokens(3), _tokens(4), _tokens(3)):
        lf, gf, _ = fused.value_and_grad(t, t, _loss)
        gf = [g.clone() for s in gf for d in s for g in d.values()]
        lf = lf.clone()
        le, ge, _ = eager.value_and_grad(t, t, _loss)
        assert torch.equal(lf, le)
        assert _equal(gf, [g for s in ge for d in s for g in d.values()])
        assert torch.equal(fused.apply(t), eager.apply(t))
    assert fused.graph_stats["captures"] == 2   # value_and_grad and apply
    assert fused.graph_stats["replays"] == 4


@pytest.mark.cuda
def test_fused_megastep_skips_a_nan_step_as_single_steps_do(cuda_device):
    """Two megastep calls (K=3, AdamW capturable); the second, a replay,
    has a NaN loss scale at its inner step 1.  Against six single eager
    steps in which the test skips step 4 (snapshot and restore)."""
    k = 3
    layers = _layers(2)
    fused = GPipe(layers, [2, 2], chunks=2, fused=True, megastep=k)
    eager = GPipe(layers, [2, 2], chunks=2)
    w0 = _state(eager)
    toks = [_tokens(10 + i) for i in range(2 * k)]
    scales = [torch.tensor(1.0, device="cuda") for _ in range(2 * k)]
    scales[k + 1] = torch.tensor(float("nan"), device="cuda")

    estep = eager.make_train_step(OPTS["adamw"], _loss)
    want_losses = []
    for i in range(2 * k):
        before = _state(eager, estep.optimizers)
        loss, _ = estep(toks[i], (toks[i], scales[i]))
        want_losses.append(loss.clone())
        if i == k + 1:
            live = list(eager.parameters()) + list(eager.buffers()) + [
                v for o in estep.optimizers for st in o.state.values()
                for v in st.values() if isinstance(v, torch.Tensor)]
            with torch.no_grad():
                for t, s in zip(live, before):
                    t.copy_(s)
    want = _state(eager, estep.optimizers)

    _load(fused, w0)
    fstep = fused.make_train_step(OPTS["adamw"], _loss)
    got_losses, finite = [], []
    for c in range(2):
        xs = torch.stack(toks[c * k:(c + 1) * k])
        ss = torch.stack(scales[c * k:(c + 1) * k])
        losses, _, ok = fstep(xs, (xs, ss))
        got_losses += [x.clone() for x in losses]
        finite += ok.tolist()
    assert finite == [True] * (k + 1) + [False] + [True]
    assert _equal(got_losses, want_losses)
    assert _equal(_state(fused, fstep.optimizers), want)
    assert fused.graph_stats["captures"] == 1


@pytest.mark.cuda
def test_fused_refuses_a_host_step_count(cuda_device):
    pipe = GPipe(_layers(), [4], chunks=2, fused=True)
    with pytest.raises(ValueError, match="capturable=True"):
        pipe.make_train_step(functools.partial(torch.optim.AdamW, lr=1e-3), _loss)


@pytest.mark.cuda
def test_offload_moves_the_saved_tensors_and_equals_never(cuda_device):
    layers = _layers(3)
    t = _tokens(5)
    runs = {}
    for mode in ("never", "offload"):
        pipe = GPipe(layers, [2, 2], chunks=2, checkpoint=mode)
        loss, grads, _ = pipe.value_and_grad(t, t, _loss)
        runs[mode] = (loss.clone(), [g.clone() for s in grads for d in s for g in d.values()],
                      dict(pipe.offload_stats))
    (ln, gn, _), (lo, go, stats) = runs["never"], runs["offload"]
    assert torch.equal(ln, lo) and _equal(gn, go)
    assert stats["moved_bytes"] == stats["saved_bytes"] > 0


@pytest.mark.cuda
def test_fused_deferred_bn_conv_replays_equal_eager(cuda_device):
    """A float32 convolutional model with a skip and deferred batch norm
    (cuDNN in deterministic mode, so two eager steps agree bitwise)."""
    def layers():
        gen = torch.Generator("cuda").manual_seed(4)
        ns = Namespace()
        return [tnn.conv2d(3, 16, (3, 3), device="cuda", generator=gen),
                stash("res", ns=ns), tnn.batch_norm(16, device="cuda"), tnn.relu(),
                tnn.conv2d(16, 16, (3, 3), device="cuda", generator=gen),
                pop_add("res", ns=ns), tnn.global_avg_pool(),
                tnn.dense(16, 5, device="cuda", generator=gen)]

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator("cuda").manual_seed(5)
        xs = [torch.randn(8, 3, 16, 16, device="cuda", generator=gen) for _ in range(3)]
        y = torch.randint(0, 5, (8,), device="cuda", generator=gen)
        loss_fn = lambda o, t: torch.nn.functional.cross_entropy(o, t)  # noqa: E731
        states = []
        for fused in (True, False):
            pipe = GPipe(layers(), [4, 4], chunks=2, deferred_batch_norm=True, fused=fused)
            for x in xs:
                pipe.value_and_grad(x, y, loss_fn)
            bn = next(m for m in pipe.modules() if isinstance(m, DeferredBatchNorm))
            assert int(bn.tracked) == 0 and bn._tracked == 0
            states.append(_state(pipe))
        assert _equal(*states)
    finally:
        torch.backends.cudnn.deterministic = det
