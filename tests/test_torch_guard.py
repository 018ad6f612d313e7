"""torchgpipe_tpu_torch.resilience (StepGuard, GuardStats, the fault
plans' hooks) against the JAX reference.

The guard's decisions (skip, retry, give up, the loss scale's backoff
and growth, its statistics and events) must equal the JAX
``StepGuard``'s on the same scripted failures: the same exceptions
raised by stand-in steps, and a real pipeline step on both sides whose
cell ``(1, 0)`` is poisoned by ``faults.inject(nan_at=...)``.  Values
are not compared across packages here (the optimizers differ); within
the port, a skipped step must leave parameters, optimizer state and
buffers bitwise as they were, and the next clean step must equal an
unguarded step from the same state, bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.distributed.context import PeerDiedError as JPeerDiedError
from torchgpipe_tpu.layers import named
from torchgpipe_tpu.ops import dense as jdense
from torchgpipe_tpu.ops import gelu as jgelu
from torchgpipe_tpu.precision import DynamicLossScale as JLossScale
from torchgpipe_tpu.resilience import faults as jfaults
from torchgpipe_tpu.resilience.guard import GuardPolicy as JPolicy
from torchgpipe_tpu.resilience.guard import StepGuard as JStepGuard
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.distributed import PeerDiedError
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.precision import DynamicLossScale
from torchgpipe_tpu_torch.resilience import GuardPolicy, StepGuard, faults


def _decisions(guard):
    ls = guard.loss_scale
    return (guard.stats.steps, guard.stats.skipped, guard.stats.retries,
            None if ls is None else (ls.scale, ls.good_steps))


# ---------------------------------------------------------------------- #
# scripted failures through stand-in steps                               #
# ---------------------------------------------------------------------- #


def _scripted(errors, port):
    """A step raising ``errors`` in turn, then returning a finite loss in
    its package's shape."""
    left = list(errors)

    def step(*args):
        if left:
            raise left.pop(0)
        if port:
            return torch.tensor(0.5), None
        return jnp.asarray(0.5), args[0], args[1]

    return step


@pytest.mark.parametrize("case", ["two_transient", "fatal", "exhausted", "peer_died"])
def test_retry_decisions_match_jax(case):
    def errs(peer_died):
        return {
            "two_transient": [ConnectionError("flaky"), TimeoutError("slow")],
            "fatal": [ValueError("a real bug")],
            "exhausted": [ConnectionError("down")] * 5,
            "peer_died": [peer_died(1, "w1", "gone")],
        }[case]

    runs = []
    for port in (False, True):
        sleeps, events = [], []
        cls = StepGuard if port else JStepGuard
        policy = (GuardPolicy if port else JPolicy)(max_retries=3, backoff_base=0.01)
        guard = cls(_scripted(errs(PeerDiedError if port else JPeerDiedError), port),
                    policy=policy, sleep=sleeps.append,
                    on_event=lambda k, info: events.append((k, info.get("attempt"),
                                                            info.get("error"))))
        try:
            guard(None, None) if not port else guard()
            raised = None
        except Exception as err:  # noqa: BLE001 - compared below
            raised = (type(err).__name__, getattr(err, "__notes__", []))
        errors = guard.stats.registry.counter(
            "guard_errors", labels=("classification", "error")).series()
        died = guard.stats.registry.counter("guard_peer_died", labels=("rank",)).series()
        runs.append((_decisions(guard), sleeps, events, raised, errors, died))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("masks", [[[1, 1], [1, 0], [0, 0], [1, 1]]])
def test_megastep_mask_folding_matches_jax(masks):
    def run(port):
        cls, ls = (StepGuard, DynamicLossScale) if port else (JStepGuard, JLossScale)
        it = iter(masks)

        def step(*args):
            mask = next(it)
            if port:
                return torch.zeros(2), None, torch.tensor(mask, dtype=torch.bool)
            return jnp.zeros(2), args[0], args[1], jnp.asarray(mask, bool)

        step.megastep = 2
        events = []
        guard = cls(step, loss_scale=ls(scale=8.0, growth_interval=1),
                    on_event=lambda k, info: events.append((k, info["skipped"])))
        out = []
        for _ in masks:
            guard() if port else guard(None, None)
            out.append(_decisions(guard))
        return out, events

    assert run(True) == run(False)


# ---------------------------------------------------------------------- #
# a real pipeline step, poisoned at cell (1, 0) on both sides             #
# ---------------------------------------------------------------------- #


def _jax_guard():
    layers = named([jdense(12, name="fc1"), jgelu("a1"), jdense(6, name="head")])
    model = JGPipe(layers, balance=[2, 1], chunks=2)
    opt = optax.adam(1e-2)
    params, state = model.init(jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((8, 12), jnp.float32))
    step = model.make_train_step(
        opt, lambda o, t: jnp.mean((o - t) ** 2), donate=False)
    guard = JStepGuard(step, loss_scale=JLossScale(scale=1024.0, growth_interval=2),
                       extra_state_argnums=(2,))
    carry = [params, model.init_opt_state(opt, params), state]

    def call(x, y):
        loss, p, o, s, _ = guard(*carry, x, y)
        carry[:] = [p, o, s]
        return float(loss)

    return guard, call


def _torch_layers():
    gen = torch.Generator().manual_seed(0)
    return [tnn.Dense(12, 12, name="fc1", device="cpu", generator=gen),
            tnn.GELU("a1"),
            tnn.Dense(12, 6, name="head", device="cpu", generator=gen)]


def _torch_step(layers):
    pipe = GPipe(layers, [2, 1], devices=["cpu"], chunks=2)
    return pipe.make_train_step(functools.partial(torch.optim.Adam, lr=1e-2),
                                lambda o, t: ((o - t) ** 2).mean())


def _live(step):
    return list(step.pipe.parameters()) + list(step.pipe.buffers()) + \
        [v for opt in step.optimizers for st in opt.state.values()
         for v in st.values() if isinstance(v, torch.Tensor)]


def _state(step):
    return [t.detach().clone() for t in _live(step)]


def _load(step, state):
    with torch.no_grad():
        for t, s in zip(_live(step), state):
            t.copy_(s)


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_poisoned_step_decisions_match_jax_and_restore_bitwise():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((8, 12)).astype(np.float32) for _ in range(3)]
    ys = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(3)]
    plan = [(0, None), (1, (1, 0)), (2, None), (0, None)]

    jguard, jcall = _jax_guard()
    step = _torch_step(_torch_layers())
    events = []
    guard = StepGuard(step, loss_scale=DynamicLossScale(scale=1024.0, growth_interval=2),
                      on_event=lambda k, info: events.append(k))
    for k, nan_at in plan:
        ctx = lambda m: m.inject(nan_at=nan_at) if nan_at else _null()  # noqa: E731
        with ctx(jfaults):
            jloss = jcall(jnp.asarray(xs[k]), jnp.asarray(ys[k]))
        before = _state(step)
        with ctx(faults):
            loss, _ = guard(torch.from_numpy(xs[k]), torch.from_numpy(ys[k]))
        assert np.isfinite(jloss) == bool(torch.isfinite(loss))
        assert _decisions(guard) == _decisions(jguard)
        if nan_at:
            assert _equal(_state(step), before)   # skipped: bitwise as it was
    assert events == ["skip"]
    assert _decisions(guard)[:2] == (3, 1)


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def test_clean_step_after_a_skip_equals_an_unguarded_step_bitwise():
    rng = np.random.default_rng(1)
    x0, x1 = (torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
              for _ in range(2))
    y = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    step = _torch_step(_torch_layers())
    guard = StepGuard(step)
    guard(x0, y)                                   # Adam's state exists now
    saved = _state(step)
    with faults.inject(nan_at=(1, 1)):
        loss, _ = guard(x1, y)
    assert torch.isnan(loss) and guard.stats.skipped == 1
    assert _equal(_state(step), saved)
    loss, _ = guard(x1, y)
    after = _state(step)
    twin = _torch_step(_torch_layers())
    twin(x1, y)                                    # builds Adam's state
    _load(twin, saved)
    twin_loss, _ = twin(x1, y)
    assert torch.equal(loss, twin_loss)
    assert _equal(after, _state(twin))


def test_a_skipped_first_step_leaves_no_optimizer_state():
    step = _torch_step(_torch_layers())
    guard = StepGuard(step)
    before = _state(step)
    with faults.inject(nan_at=(0, 0)):
        guard(torch.ones(8, 12), torch.zeros(8, 6))
    assert all(not opt.state for opt in step.optimizers)
    assert _equal(_state(step), before)


def test_extra_state_argnums_restores_threaded_tensors():
    counter = torch.zeros(3)

    def step(x, state):
        state.add_(x)
        return torch.tensor(float("nan")) if x.sum() > 10 else torch.tensor(1.0), None

    guard = StepGuard(step, extra_state_argnums=(1,))
    guard(torch.ones(3), counter)
    assert counter.tolist() == [1.0, 1.0, 1.0] and guard.stats.steps == 1
    guard(torch.full((3,), 5.0), counter)
    assert counter.tolist() == [1.0, 1.0, 1.0] and guard.stats.skipped == 1


def test_transient_retry_restores_partial_updates():
    step = _torch_step(_torch_layers())
    calls = []

    def flaky(x, y):
        calls.append(1)
        if len(calls) == 1:
            with torch.no_grad():
                for p in step.pipe.parameters():
                    p.add_(1.0)            # a partial in-place update, then a drop
            raise ConnectionError("dropped")
        return step(x, y)

    flaky.pipe, flaky.optimizers = step.pipe, step.optimizers
    x, y = torch.ones(8, 12), torch.zeros(8, 6)
    twin = _torch_step(_torch_layers())
    want, _ = twin(x, y)
    got, _ = StepGuard(flaky, sleep=lambda s: None)(x, y)
    assert len(calls) == 2 and torch.equal(got, want)
    assert _equal(_state(step), _state(twin))


def test_fused_megastep_mask_reaches_the_guard():
    gen = torch.Generator().manual_seed(0)
    layers = [tnn.Dense(12, 6, name="fc", device="cpu", generator=gen)]
    pipe = GPipe(layers, [1], devices=["cpu"], chunks=2, fused=True, megastep=2)
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=0.1),
                                lambda o, t: ((o - t) ** 2).mean())
    xs = torch.ones(2, 8, 12)
    xs[1, 0, 0] = float("nan")
    guard = StepGuard(step, loss_scale=DynamicLossScale(scale=4.0))
    guard(xs, torch.zeros(2, 8, 6))
    assert (guard.stats.steps, guard.stats.skipped, guard.loss_scale.scale) == (1, 1, 2.0)


# ---------------------------------------------------------------------- #
# the fault plans' pure hooks against JAX's                               #
# ---------------------------------------------------------------------- #


PLANS = [
    dict(),
    dict(die_at_step=(1, 3)),
    dict(die_at_megastep=(2, 4)),
    dict(slow_at=(1, 0.25)),
    dict(slow_replica_at=(0, 0.5)),
    dict(bad_version_at=(1, 7), bad_version_delay=0.3),
    dict(preempt_at_step=5),
    dict(nan_at=(1, 0)),
]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_hooks_match_jax(plan):
    def probe(m):
        with m.inject(**plan) if plan else _null():
            token = m.plan_token()
            return (
                [m.should_die(r, s) for r in range(3) for s in range(6)],
                [m.should_die_at_megastep(r, s) for r in range(3) for s in range(6)],
                [m.cell_delay_s(s) for s in range(3)],
                [m.replica_delay_s(r) for r in range(3)],
                [m.bad_version_delay_s(r, v) for r in range(3) for v in (6, 7)],
                [m.should_preempt(s) for s in range(8)],
                token is None,
                m.active_plan() == (m.FaultPlan(**plan) if plan else None),
            )

    assert probe(faults) == probe(jfaults)


def test_poison_and_cell_corruption_match_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    ids = np.arange(4, dtype=np.int32)
    with faults.inject(nan_at=(1, 2)):
        hit = faults.corrupt_cell_input(1, 2, (torch.from_numpy(x), torch.from_numpy(ids)))
        miss = faults.corrupt_cell_input(1, 1, torch.from_numpy(x))
        spmd = faults.spmd_corrupt_cell_input(torch.tensor(1), torch.tensor(2),
                                              torch.from_numpy(x))
        spmd_miss = faults.spmd_corrupt_cell_input(torch.tensor(0), torch.tensor(2),
                                                   torch.from_numpy(x))
    with jfaults.inject(nan_at=(1, 2)):
        jhit = jfaults.corrupt_cell_input(1, 2, (jnp.asarray(x), jnp.asarray(ids)))
        jspmd = jfaults.spmd_corrupt_cell_input(jnp.asarray(1), jnp.asarray(2),
                                                jnp.asarray(x))
    np.testing.assert_array_equal(hit[0].numpy(), np.asarray(jhit[0]))
    np.testing.assert_array_equal(hit[1].numpy(), np.asarray(jhit[1]))
    np.testing.assert_array_equal(spmd.numpy(), np.asarray(jspmd))
    assert torch.equal(miss, torch.from_numpy(x)) and torch.equal(spmd_miss, torch.from_numpy(x))
    with pytest.raises(RuntimeError, match="do not nest"):
        with faults.inject(nan_at=(0, 0)), faults.inject(preempt_at_step=1):
            pass
