"""The SPMD engine's own knobs (ROADMAP A.5.4e1): ``train_step(rng=)``,
``make_train_step(megastep=K)``, ``checkpoint='offload'``, the fault hook
``faults.inject(nan_at=)`` under ``StepGuard``, and a failing cell's note.

The port's ranks are OS processes over gloo (tests/torch_spmd_rank.py):
one world of four (pp=2 x dp=2, as the reference's failure tests) and one
of a single rank.  Oracles:

* megastep: the reference's tests/test_megastep.py contract, bitwise
  within the port (K=3 AdamW steps over stacked batches with a NaN in
  batch 1 against ``StepGuard`` around 3 single steps: losses, params,
  optimizer state, the skip mask), and the reference's own megastep on
  the same params and batches for the values (float32, AdamW's update in
  another order: the SPMD parity files' rtol 1e-5 on the losses, rtol
  1e-4 / atol 1e-5 on every parameter);
* ``rng=``: the behaviour of the reference's
  ``test_interleaved_with_rng_dropout_runs`` (same key, same loss;
  another key, another loss), and the port's own invariance: the keys
  belong to (micro-batch, layer of the whole model) cells, so
  fill-drain, 1F1B, zero-bubble and an interleaved pipe over the same
  layers give the same loss (the same float32 products summed in other
  orders: rtol 1e-6), and a checkpointed fill-drain recomputes the
  masks its forward drew (gradients as 'never''s, rtol 1e-6 / atol
  1e-7);
* ``checkpoint='offload'``: the reference's own offload gate fails on
  jax 0.9.0, so the oracle is the port's ``'never'``: loss and every
  gradient bitwise;
* faults and notes: tests/test_failures.py's SPMD cases (the exception
  type kept, a note naming stage and micro-batch) and
  ``_fault_token_checked``'s refusal, word for word.
"""

import jax
import numpy as np
import pytest
import torch

import torch_spmd_parity as par
from torchgpipe_tpu_torch import spmd
from torchgpipe_tpu_torch.resilience import faults

K = 3
MLP = dict(model="mlp", pp=2, dp=2, chunks=2, batch=8, dp_axis=True)


def _batches(k, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((k, 8, par.DIM), dtype=np.float32)
    ys = rng.standard_normal((k, 8, par.DIM), dtype=np.float32)
    return xs, ys


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    import optax

    out = str(tmp_path_factory.mktemp("spmd_knobs"))
    pipe, params, _, _ = par.reference(dict(MLP, checkpoint="always"), cpu_devices)
    host = par.to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    xs, ys = _batches(K, 7)
    xs[1, 0, 0] = np.nan
    opt = optax.adamw(1e-3)
    step = pipe.make_train_step(opt, donate=False, megastep=K)
    losses, new, _, finite = step(params, pipe.place_tree(opt.init(params)), xs, ys)
    want = {"losses": np.asarray(losses), "params": jax.device_get(new),
            "finite": np.asarray(finite)}
    x1, y1 = (torch.from_numpy(a[0]) for a in _batches(1, 3))
    x2, y2 = (torch.from_numpy(a) for a in _batches(2, 4))

    def case(spec, x, y, params=host):
        return {"spec": spec, "params": params, "x": x, "tgt": y}

    four = {
        "megastep": case(dict(MLP, knob="megastep", k=K), torch.from_numpy(xs),
                         torch.from_numpy(ys)),
        "megastep_rng": case(dict(MLP, model="drop", knob="megastep_rng"), x2, y2),
        "rng": case(dict(MLP, model="drop2", knob="rng"), x1, y1),
        "offload": case(dict(model="llama", n_layers=2, pp=2, dp=2, chunks=2, batch=8,
                             dp_axis=True, knob="offload"),
                        torch.randint(0, 64, (8, 8), generator=torch.Generator().manual_seed(1)),
                        torch.randint(0, 64, (8, 8), generator=torch.Generator().manual_seed(2))),
        "guard": case(dict(MLP, knob="guard"), x1, y1),
        # Last: the failing cell leaves the world's transfers unmatched.
        "bomb_stage1": case(dict(MLP, model="bomb", knob="bomb", schedule="1f1b",
                                 checkpoint="except_last", armed_stages=[1],
                                 ends_world=True), x1, y1),
    }
    one = {f"bomb_{name}": case(dict(model="bomb", pp=1, dp=1, chunks=2, batch=8,
                                     knob="bomb", armed_stages=[0], **kw), x1, y1)
           for name, kw in (("fill_drain", {}), ("1f1b", dict(schedule="1f1b")),
                            ("apply", dict(apply=True)))}
    port = par.run_port(four, 2, 2, out)
    port.update(par.run_port(one, 1, 1, out))
    return port, want


def test_megastep_is_k_guarded_steps_bitwise(results):
    """On every rank: the K=3 megastep's losses, parameters and AdamW
    state bitwise what StepGuard around 3 single steps leaves (step 1,
    whose batch holds a NaN, skipped: finite [T, F, T]); a guard wrapping
    the megastep folds its mask into its statistics."""
    port, _ = results
    got = port["megastep"]
    assert bool(got["bitwise"].all())
    assert got["finite"].tolist() == [True, False, True]
    assert got["guard_stats"].tolist() == [2, 1, 2, 1]


def test_megastep_matches_the_references(results):
    """The same K=3 megastep against the reference's (optax AdamW, its
    in-scan skip): the losses, the skip mask and every parameter."""
    port, want = results
    got = port["megastep"]
    assert got["finite"].numpy().tolist() == want["finite"].tolist()
    losses = got["losses"].numpy()
    assert np.isnan(losses[1]) and np.isnan(want["losses"][1])
    np.testing.assert_allclose(losses[[0, 2]], want["losses"][[0, 2]], rtol=par.LOSS_RTOL)
    par.assert_trees_close(got["params"], want["params"])


def test_megastep_rng_folds_per_step(results):
    """Inner step k of a keyed megastep is the single step keyed
    ``fold_in(rng, k)``, bitwise; another key moves the parameters."""
    got = results[0]["megastep_rng"]
    assert bool(got["bitwise"].all()) and bool(got["other_key_differs"].all())


def test_rng_keys_belong_to_cells_not_schedules(results):
    """Same key, same loss under fill-drain ('always' and 'never'), 1F1B,
    zero-bubble and an interleaved pipe over the same layers, and on a
    repeat; another key, another loss; a checkpointed cell recomputes the
    masks its forward drew."""
    got = results[0]["rng"]
    losses = dict(zip(got["names"], got["losses"].tolist()))
    base = losses["fill_drain"]
    for name in ("fill_drain_never", "1f1b", "zb", "interleaved"):
        assert losses[name] == pytest.approx(base, rel=1e-6), name
    assert losses["again"] == base
    assert losses["other_key"] != base
    g_always = dict(par.items(got["fill_drain_grads"]))
    for path, g in par.items(got["fill_drain_never_grads"]):
        np.testing.assert_allclose(g.numpy(), g_always[path].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))


def test_offload_is_never_bitwise(results):
    """``checkpoint='offload'`` (fill-drain): the loss and every gradient
    bitwise the ``'never'`` step's; the saved tensors are counted (on the
    CPU nothing moves)."""
    got = results[0]["offload"]
    assert bool(got["bitwise"].all())
    assert got["saved_bytes"] > 0 and got["moved_bytes"] == 0


def test_guard_skips_a_poisoned_step_exactly(results):
    """StepGuard over the SPMD step: ``faults.inject(nan_at=(1, 0))``
    poisons stage 1's first cell, the step is skipped on every rank with
    the parameters and the optimizer state bitwise as before, and the
    next clean step equals an unguarded one from the same state."""
    assert bool(results[0]["guard"]["bitwise"].all())


@pytest.mark.parametrize("name", ["bomb_fill_drain", "bomb_1f1b", "bomb_apply"])
def test_exception_propagates_naming_the_cell(results, name):
    """The reference's test_spmd_exception_propagates_naming_the_cell and
    test_spmd_forward_only_also_propagates: the type kept, a note naming
    stage 0 and micro-batch 0."""
    got = results[0][name]
    assert got["type"] == "ExpectedError"
    assert "stage 0" in got["notes"] and "micro-batch 0" in got["notes"], got["notes"]


def test_failing_stage_is_named_in_a_two_stage_world(results):
    """pp=2 x dp=2 under 1F1B with stage 1's block failing: its ranks
    raise the block's error with a note naming stage 1, micro-batch 0;
    stage 0's ranks see their peers leave."""
    ranks = results[0]["bomb_stage1"]["ranks"]
    for r in (2, 3):
        assert ranks[r]["type"] == "ExpectedError"
        assert "stage 1, micro-batch 0" in ranks[r]["notes"], ranks[r]["notes"]
    assert all(ranks[r]["type"] != "none" for r in (0, 1))


def test_nan_at_refused_where_there_is_no_hook(cpu_devices):
    """A ``nan_at`` plan on a schedule without the per-cell hook is
    refused with the reference's words (its ``_fault_token_checked``)."""
    from torchgpipe_tpu.resilience import faults as jfaults

    jpipe, _, _, _ = par.reference(dict(MLP, schedule="1f1b"), cpu_devices)
    with jfaults.inject(nan_at=(1, 0)):
        with pytest.raises(NotImplementedError) as je:
            jpipe._fault_token_checked(for_train=True)
    mesh = _fake_mesh()
    pipe = spmd.SpmdGPipe(torch.nn.Linear(4, 4), 2, mesh, chunks=2,
                          loss_fn=lambda o, t: ((o - t) ** 2).mean(), schedule="1f1b",
                          dp_axis="dp")
    with faults.inject(nan_at=(1, 0)):
        with pytest.raises(NotImplementedError) as te:
            pipe._fault_check(for_train=True)
        pipe._fault_check()   # the 1F1B pipe's forward has the hook
    assert str(te.value) == str(je.value)


def _fake_mesh():
    import types

    return types.SimpleNamespace(axis_names=("pp", "dp"), shape={"pp": 2, "dp": 2},
                                 coords={"pp": 0, "dp": 0}, device=torch.device("cpu"))


def test_megastep_knob_and_refusals():
    """``SpmdGPipe(megastep=K)`` is the default of ``make_train_step``
    (and shows in the repr); K below 1 and an unstacked batch are refused
    as the reference refuses them."""
    mse = lambda o, t: ((o - t) ** 2).mean()  # noqa: E731
    pipe = spmd.SpmdGPipe(torch.nn.Linear(4, 4), 2, _fake_mesh(), chunks=2, loss_fn=mse,
                          megastep=2)
    assert "megastep=2" in repr(pipe)
    step = pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=0.1))
    assert step.megastep == 2
    with pytest.raises(ValueError, match="megastep must be"):
        pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=0.1), megastep=-1)
    with pytest.raises(ValueError, match=r"\[K, \.\.\.\]-stacked"):
        step({}, torch.zeros(8, 4), torch.zeros(8, 4))
