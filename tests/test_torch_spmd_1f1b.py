"""torchgpipe_tpu_torch.spmd under ``schedule='1f1b'``, and skips resolved
inside a stage, against the reference's ``SpmdGPipe`` (the mirror of
tests/test_spmd_1f1b.py and tests/test_spmd_skips.py).

Each stage runs its cells in the order of the reference's closed-form
tick table (``spmd.fwd_tick`` / ``spmd.bwd_tick``).  The port's 1F1B step
is held against the reference's 1F1B step and against its fill-drain step
at the same weights (the reference's ``test_1f1b_matches_fill_drain``), in
the three checkpoint modes, with dp, a summed loss and a ragged batch; a
U-Net-style skip resolved inside each stage (a ``SkipSequential``)
pipelines under both schedules.  Ranks are OS processes over gloo
(tests/torch_spmd_rank.py); tolerances as tests/test_torch_spmd.py's.
"""

import numpy as np
import pytest

import torch_spmd_parity as par

WORLDS = {
    (2, 1): {
        "always": dict(model="llama", n_layers=2, chunks=4, batch=8, schedule="1f1b"),
        "never": dict(model="llama", n_layers=2, chunks=4, batch=8, schedule="1f1b",
                      checkpoint="never"),
        "except_last": dict(model="llama", n_layers=2, chunks=4, batch=8,
                            schedule="1f1b", checkpoint="except_last"),
        "sum_loss": dict(model="mlp", chunks=4, batch=16, schedule="1f1b",
                         loss_reduction="sum"),
        "ragged": dict(model="mlp", chunks=2, batch=7, schedule="1f1b"),
        "skips_1f1b": dict(model="skips", chunks=4, batch=8, schedule="1f1b",
                           checkpoint="except_last"),
        "skips_fill_drain": dict(model="skips", chunks=4, batch=8,
                                 checkpoint="except_last"),
    },
    (4, 1): {
        "pp4": dict(model="llama", n_layers=4, chunks=6, batch=12, schedule="1f1b"),
    },
    (2, 2): {
        "dp": dict(model="llama", n_layers=2, chunks=2, batch=8, schedule="1f1b",
                   checkpoint="except_last"),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp)
         for (pp, dp), cases in WORLDS.items() for name, spec in cases.items()}
# The reference's fill-drain step at each 1F1B case's weights.
FILL_DRAIN = {name: dict(spec, schedule="fill_drain")
              for name, spec in CASES.items() if spec.get("schedule") == "1f1b"}


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    port, want = par.run_both(WORLDS, CASES, cpu_devices,
                              str(tmp_path_factory.mktemp("spmd_1f1b")), extra=FILL_DRAIN)
    fill = {name: want.pop("extra:" + name) for name in FILL_DRAIN}
    return port, want, fill


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(results, name):
    port, want, _ = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"])


@pytest.mark.parametrize("name", list(FILL_DRAIN))
def test_1f1b_matches_fill_drain(results, name):
    port, _, fill = results
    np.testing.assert_allclose(float(port[name]["loss"]), fill[name]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], fill[name]["grads"])
