"""torchgpipe_tpu_torch's ``make_train_step`` against the JAX reference's.

The tiny float32 Llama of tests/test_torch_gpipe.py (vocab 256, dim 128,
2 blocks) takes three steps of ``make_train_step`` on one batch through
both packages, at balances [4], [1, 2, 1] and [2, 2], with each optax
optimizer beside its ``torch.optim`` counterpart: ``sgd``, ``sgd`` with
momentum 0.9, ``adam`` and ``adamw``.  The reference updates each stage
with its own optax state (``init_opt_state``); the port steps one
``torch.optim`` optimizer per stage.

Tolerances.  The gradients already differ by summation order (~1e-6 of
each leaf's largest entry, tests/test_torch_gpipe.py), and each update
carries that into the parameters.  The losses of all three steps must
agree to 1e-5 relative.  SGD's update is ``lr * g`` (momentum: a sum of
such terms), so each parameter must move as the reference's to 1e-4 of
the leaf's largest move.  Adam's update is ``m / sqrt(v)``: ~lr whatever
the gradient's size, so it is not Lipschitz near zero: an entry whose
gradient sits at its leaf's rounding level (~1e-6 of the largest) may
move up to ~lr either way on the two sides.  Such entries carry a
vanishing share of the loss and of the leaf: per leaf, the move must
agree with the reference's to 1e-2 in relative L2 norm (measured: 6.5e-4
at worst) and 99.9% of the entries to 1e-2 of the largest move (measured:
all but 0.012%).  AdamW decays in the
other order: torch scales the weight by 1 - lr*wd before the Adam step,
optax adds -lr*wd*w to the update; equal in exact arithmetic, one
rounding (~1e-7 relative) apart, far inside that.  The reference runs
under 'never' (its checkpoint modes compute one function, and 'never'
compiles the fewest programs), the port under 'except_last'.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
BATCH, SEQ, CHUNKS, STEPS = 4, 16, 2, 3
LOSS_RTOL = 1e-5
SGD_REL_TOL = 1e-4
ADAM_L2_TOL, ADAM_ENTRY_TOL, ADAM_SHARE = 1e-2, 1e-2, 0.999

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.5),
            functools.partial(torch.optim.SGD, lr=0.5)),
    "momentum": (lambda: optax.sgd(0.5, momentum=0.9),
                 functools.partial(torch.optim.SGD, lr=0.5, momentum=0.9)),
    "adam": (lambda: optax.adam(1e-3),
             functools.partial(torch.optim.Adam, lr=1e-3)),
    "adamw": (lambda: optax.adamw(1e-3, weight_decay=0.1),
              functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=0.1)),
}


def jax_loss(out, tokens):
    return jt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


def torch_loss(out, tokens):
    return tt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


@pytest.fixture(scope="module")
def reference():
    pipe = JGPipe(jt.llama(JCFG), balance=[4])
    params, _ = pipe.init(jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32))
    flat = [jax.tree_util.tree_map(np.asarray, p) for stage in params for p in stage]
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (BATCH, SEQ))
    return flat, tokens.astype(np.int32)


_PIPES = {}


def _jax_steps(reference, balance, opt_name):
    flat, tokens = reference
    key = tuple(balance)
    if key not in _PIPES:       # one pipe per balance: its cell programs compile once
        _PIPES[key] = JGPipe(jt.llama(JCFG), balance=balance, chunks=CHUNKS,
                             checkpoint="never")
    pipe = _PIPES[key]
    params, state, i = [], [], 0
    for n in balance:
        params.append([jax.tree_util.tree_map(jnp.asarray, p) for p in flat[i:i + n]])
        state.append([()] * n)
        i += n
    params, state = pipe.place(tuple(params)), pipe.place(tuple(state))
    opt = OPTIMIZERS[opt_name][0]()
    step = pipe.make_train_step(opt, jax_loss, donate=False)
    opt_state = pipe.init_opt_state(opt, params)
    x, losses = jnp.asarray(tokens), []
    for _ in range(STEPS):
        loss, params, opt_state, state, _ = step(params, opt_state, state, x, x)
        losses.append(float(loss))
    return losses, [jax.tree_util.tree_map(np.asarray, p) for s in params for p in s]


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("balance", [[4], [1, 2, 1], [2, 2]])
def test_make_train_step_matches_optax(reference, balance, opt_name):
    flat, tokens = reference
    jlosses, jparams = _jax_steps(reference, balance, opt_name)
    model = GPipe(params_from_jax(TCFG, flat, device="cpu"), balance,
                  devices=["cpu"], chunks=CHUNKS, checkpoint="except_last")
    step = model.make_train_step(OPTIMIZERS[opt_name][1], torch_loss)
    assert len(step.optimizers) == len(balance)
    for opt, part in zip(step.optimizers, model.partitions):
        assert [id(p) for g in opt.param_groups for p in g["params"]] == \
            [id(p) for p in part.parameters()]
    t = torch.from_numpy(tokens)
    losses = []
    for _ in range(STEPS):
        loss, aux = step(t, t)
        assert aux is None
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for li, (layer, want, start) in enumerate(zip(model, jparams, flat)):
        for name, p in layer.named_parameters():
            got = p.detach().numpy() - start[name]
            moved = want[name] - start[name]
            scale = np.abs(moved).max()
            err = np.abs(got - moved)
            what = f"layer {li} {name}"
            if opt_name in ("sgd", "momentum"):
                assert err.max() <= SGD_REL_TOL * scale, (what, err.max(), scale)
            else:
                l2 = np.linalg.norm(got - moved) / np.linalg.norm(moved)
                assert l2 <= ADAM_L2_TOL, (what, l2)
                assert (err <= ADAM_ENTRY_TOL * scale).mean() >= ADAM_SHARE, what


def test_megastep_is_not_ported():
    """megastep is ported (tests/test_torch_fused.py); without fused=True
    both packages refuse it, with the same text."""
    model = GPipe([torch.nn.Linear(2, 2)], [1], devices=["cpu"])
    jmodel = JGPipe(jt.llama(JCFG)[:1], [1], devices=[jax.devices()[0]])
    with pytest.raises(ValueError) as je:
        jmodel.make_train_step(optax.sgd(0.5), None, megastep=2)
    with pytest.raises(ValueError, match=r"needs GPipe\(fused=True\)") as te:
        model.make_train_step(torch.optim.SGD, torch_loss, megastep=2)
    assert str(te.value) == str(je.value)
