"""torchgpipe_tpu_torch.spmd under ``schedule='interleaved'`` and
``schedule='zb'``, their tables and ``simulate_pipeline``'s projections,
against the reference (the mirror of tests/test_spmd_interleaved.py,
tests/test_spmd_zb.py and tests/test_zerobubble.py).

The port's copies of the reference's numpy tables
(``parallel/interleaved.py``, ``parallel/zerobubble.py``) are held bit
for bit, errors included.  Each rank runs its column of the tables tick
by tick; its steps are held against the reference's engine of the same
schedule at the same weights and batch: loss to rtol 1e-5, every
gradient leaf to rtol 1e-4 / atol 1e-5 at float32, as
tests/test_torch_spmd.py (the two engines add the same float32 products
in other orders, a few ulps apart).  Ranks are OS processes over gloo
(tests/torch_spmd_rank.py); the reference runs on the virtual CPU
devices.  The projections are plain float arithmetic over the same
events, so they agree to 1e-12.
"""

import itertools

import numpy as np
import pytest

import torch_spmd_parity as par
from torchgpipe_tpu.parallel import interleaved as jil
from torchgpipe_tpu.parallel import zerobubble as jzb
from torchgpipe_tpu.utils import tracing as jtr
from torchgpipe_tpu_torch.parallel import interleaved as til
from torchgpipe_tpu_torch.parallel import zerobubble as tzb
from torchgpipe_tpu_torch.utils import tracing as ttr

IL = dict(model="llama", n_layers=4, v=2, schedule="interleaved")
WORLDS = {
    (1, 1): {   # one stage: chunk c's output comes back to this rank as c+1's input
        "il_one_stage": dict(model="mlp", v=2, schedule="interleaved", chunks=2, batch=8,
                             checkpoint="except_last"),
    },
    (2, 1): {
        "il_always": dict(IL, chunks=4, batch=8, checkpoint="always"),
        "il_except_last": dict(IL, chunks=4, batch=8, checkpoint="except_last"),
        "il_never": dict(IL, chunks=4, batch=8, checkpoint="never"),
        "il_apply": dict(IL, chunks=2, batch=4, apply=True),
        "zb_never": dict(model="llama", n_layers=2, chunks=4, batch=8, schedule="zb",
                         checkpoint="never"),
        "zb_always": dict(model="llama", n_layers=2, chunks=4, batch=8, schedule="zb",
                          checkpoint="always"),
        "zb_ragged": dict(model="mlp", chunks=2, batch=7, schedule="zb",
                          checkpoint="never"),
    },
    (2, 2): {
        "il_dp": dict(IL, chunks=2, batch=8, checkpoint="always"),
        "il_fsdp": dict(IL, chunks=2, batch=8, checkpoint="except_last", fsdp=True),
        "il_fsdp_apply": dict(IL, chunks=2, batch=8, fsdp=True, apply=True),
        "zb_dp_fsdp": dict(model="llama", n_layers=2, chunks=2, batch=8, schedule="zb",
                           checkpoint="never", fsdp=True),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp)
         for (pp, dp), cases in WORLDS.items() for name, spec in cases.items()}


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return par.run_both(WORLDS, CASES, cpu_devices,
                        str(tmp_path_factory.mktemp("spmd_schedules")))


@pytest.mark.parametrize("name", [n for n, s in CASES.items() if not s.get("apply")])
def test_matches_reference(results, name):
    """Loss and every gradient leaf (the ``[n, v, ...]`` blocks of an
    interleaved pipe, fsdp shards gathered) equal the reference's."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"])


@pytest.mark.parametrize("name", [n for n, s in CASES.items() if s.get("apply")])
def test_interleaved_apply_and_eval_loss(results, name):
    """``apply`` and ``eval_loss`` over the interleaved forward tables
    (fsdp's gathered at use) equal the reference's."""
    port, want = results
    np.testing.assert_allclose(port[name]["out"].numpy(), want[name]["out"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)


def test_params_from_jax_carries_an_interleaved_tree(results):
    """``convert.params_from_jax`` of a reference interleaved pipe's
    params (blocks ``[n, v, ...]``) gives the port's tree: same layout,
    same values."""
    import torch

    from torchgpipe_tpu_torch import convert
    from torchgpipe_tpu_torch.models import transformer as tt

    _, want = results
    host = want["il_always"]["params"]
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
                               dtype=torch.float32)
    tree = convert.params_from_jax(cfg, host, device="cpu")
    assert tuple(tree["blocks"][0]["wq"].shape[:2]) == (2, 2)
    par.assert_trees_close(tree, host, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# the tables                                                            #
# --------------------------------------------------------------------- #

GRID = [(n, m, v) for n, m, v in itertools.product((1, 2, 3, 4), (1, 2, 3, 4, 6, 8),
                                                   (1, 2, 3))]


def _same_or_same_error(fn_t, fn_j, *args):
    try:
        want = fn_j(*args)
    except (ValueError, RuntimeError) as e:
        with pytest.raises(type(e)) as got:
            fn_t(*args)
        assert str(got.value) == str(e)
        return None, None
    return fn_t(*args), want


@pytest.mark.parametrize("kind", ["train", "forward"])
def test_interleaved_tables_bitwise(kind):
    """Every ``(n, m, v)`` of the grid: the same ticks, slot depth and
    ``kind``/``chunk``/``mb`` tables, or the same error."""
    fn = "interleaved_tables" if kind == "train" else "interleaved_forward_tables"
    checked = 0
    for n, m, v in GRID:
        got, want = _same_or_same_error(getattr(til, fn), getattr(jil, fn), n, m, v)
        if got is None:
            continue
        checked += 1
        assert (got.n, got.m, got.v, got.ticks, got.slots, got.bubble_ticks) == \
            (want.n, want.m, want.v, want.ticks, want.slots, want.bubble_ticks)
        for f in ("kind", "chunk", "mb"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (n, m, v, f)
    assert checked > 20
    assert (til.FWD, til.BWD, til.IDLE) == (jil.FWD, jil.BWD, jil.IDLE)


def test_zero_bubble_tables_bitwise():
    """Every ``(n, m)``: the same ticks, slot depths, tables and weighted
    makespans (and the fused-1F1B comparator), or the same error."""
    for n, m in itertools.product((0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 7, 8)):
        got, want = _same_or_same_error(tzb.zero_bubble_tables, jzb.zero_bubble_tables, n, m)
        if got is None:
            continue
        for f in ("n", "m", "ticks", "slots", "y_slots", "resid_slots", "dy_slots",
                  "x_slots", "bubble_ticks"):
            assert getattr(got, f) == getattr(want, f), (n, m, f)
        for f in ("kind", "mb"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), (n, m, f)
        assert got.weighted_makespan(1.0, 0.7, 0.6) == want.weighted_makespan(1.0, 0.7, 0.6)
        assert tzb.fused_1f1b_weighted_makespan(n, m, 1.0, 1.3) == \
            jzb.fused_1f1b_weighted_makespan(n, m, 1.0, 1.3)
    assert (tzb.F, tzb.B, tzb.W, tzb.IDLE) == (jzb.F, jzb.B, jzb.W, jzb.IDLE)


def test_table_validators_refuse_what_the_reference_refuses():
    """A table with a cell moved before its producer fails both
    ``_validate``s with the same text."""
    for mod_t, mod_j, make in ((til, jil, lambda mod: mod.interleaved_tables(2, 4, 2)),
                               (tzb, jzb, lambda mod: mod.zero_bubble_tables(2, 3))):
        bad = []
        for mod in (mod_t, mod_j):
            tb = make(mod)
            kind = tb.kind.copy()
            kind[[0, 1]] = kind[[1, 0]]    # swap the first two ticks
            tb = type(tb)(**dict(tb.__dict__, kind=kind))
            with pytest.raises(AssertionError) as e:
                mod._validate(tb)
            bad.append(str(e.value))
        assert bad[0] == bad[1]


# --------------------------------------------------------------------- #
# the projections                                                       #
# --------------------------------------------------------------------- #


def _timeline(module, m, n, seed):
    """Measured-looking cells: uneven stages, each cell observed twice, a
    loss barrier at micro-batch -1."""
    rng = np.random.default_rng(seed)
    cells, t = [], 0.0
    for _ in range(2):
        for name in ("fwd", "bwd"):
            for i in range(m):
                for j in range(n):
                    d = float(rng.uniform(0.5, 1.5)) * (1.0 + j) * (2.0 if name == "bwd" else 1)
                    cells.append(module.TimelineEvent(name, j, i, t, t + d))
                    t += d
        cells.append(module.TimelineEvent("loss", n - 1, -1, t, t + 0.3))
        t += 0.3
    return cells


@pytest.mark.parametrize("schedule, m, n, v", [
    ("fill_drain", 4, 2, 1), ("1f1b", 4, 2, 1), ("1f1b", 3, 4, 1), ("zb", 4, 2, 1),
    ("zb", 8, 3, 1), ("interleaved", 4, 4, 2), ("interleaved", 2, 4, 2),
    ("interleaved", 6, 6, 2)])
def test_simulate_pipeline_matches_reference(schedule, m, n, v):
    got = ttr.simulate_pipeline(_timeline(ttr, m, n, m * 10 + n), n, schedule, v)
    want = jtr.simulate_pipeline(_timeline(jtr, m, n, m * 10 + n), n, schedule, v)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_simulate_pipeline_interleaved_needs_full_groups():
    """The reference's error, word for word: an interleaved projection of
    a micro-batch count the device count does not divide (the layout
    refusals are tests/test_torch_tracing.py's)."""
    with pytest.raises(ValueError) as je:
        jtr.simulate_pipeline(_timeline(jtr, 3, 4, 0), 4, "interleaved", 2)
    with pytest.raises(ValueError) as te:
        ttr.simulate_pipeline(_timeline(ttr, 3, 4, 0), 4, "interleaved", 2)
    assert str(te.value) == str(je.value)
