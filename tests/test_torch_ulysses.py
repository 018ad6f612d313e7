"""Ulysses sequence parallelism in torchgpipe_tpu_torch against the
reference (the mirror of tests/test_ulysses.py).

``ulysses_attention`` runs in rank processes over gloo
(tests/torch_spmd_rank.py), each rank holding its sequence shard, against
the reference's under ``shard_map`` on the same shards: the outputs to
2e-5 and the q/k/v gradients to 5e-5 (tests/torch_tp_parity.py), causal
and not, with GQA pairing and with a sliding window.  The engine at pp=2
x sp=2 with ``sp_impl='ulysses'`` is held against the reference's
sequential oracle (loss to rtol 1e-5, gradients to rtol 2e-4 / atol
2e-5).
"""

import types

import numpy as np
import pytest
import torch

import torch_spmd_parity as par
import torch_tp_parity as tpp
from torchgpipe_tpu_torch import parallel, spmd
from torchgpipe_tpu_torch.models import transformer as tt

ULY = dict(op="ulysses", causal=True, shape=(2, 16, 4, 4, 8))
LLAMA = dict(model="llama", n_layers=2, chunks=2, batch=4, checkpoint="except_last",
             cfg=dict(sp_impl="ulysses"))
WORLDS = {
    (2, 1, 2, 1): {
        "ulysses_causal": dict(ULY),
        "ulysses_full": dict(ULY, causal=False, seed=1),
        "ulysses_gqa": dict(ULY, shape=(2, 16, 4, 2, 8), seed=2),
        "ulysses_window": dict(ULY, shape=(2, 16, 4, 2, 8), window=5, seed=3),
        "sp_ulysses": dict(LLAMA),
        "sp_ulysses_window": dict(LLAMA, cfg=dict(sp_impl="ulysses", attn_window=3)),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp, sp=sp, tp=tp)
         for (pp, dp, sp, tp), cases in WORLDS.items() for name, spec in cases.items()}
OPS = [n for n, s in CASES.items() if s.get("op")]
ENGINE = [n for n, s in CASES.items() if not s.get("op")]


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return tpp.run_cases(WORLDS, CASES, cpu_devices, str(tmp_path_factory.mktemp("uly")))


@pytest.mark.parametrize("name", OPS)
def test_ulysses_matches_reference(results, name):
    port, want = results
    np.testing.assert_allclose(port[name]["out"].numpy(), want[name]["out"],
                               rtol=tpp.OUT_TOL, atol=tpp.OUT_TOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port[name][g].numpy(), want[name][g],
                                   rtol=tpp.GRAD_TOL, atol=tpp.GRAD_TOL, err_msg=g)


@pytest.mark.parametrize("name", ENGINE)
def test_engine_with_ulysses_matches_the_oracle(results, name):
    """pp=2 x sp=2 with ``sp_impl='ulysses'`` (and a sliding window, which
    Ulysses' whole-sequence attention takes exactly): loss and gradients
    equal the unsharded oracle's."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=tpp.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"],
                           rtol=tpp.SP_GRAD_RTOL, atol=tpp.SP_GRAD_ATOL)


def fake_mesh(**shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                                 coords={a: 0 for a in shape}, device=torch.device("cpu"))


def test_head_divisibility_is_checked_with_the_references_words(cpu_devices):
    """At engine construction (local head counts under tp) and in the op
    itself, in the reference's wording."""
    from torchgpipe_tpu.models import transformer as jt
    from torchgpipe_tpu.spmd import SpmdGPipe as JSpmd, make_mesh as jmesh

    kw = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, sp_axis="sp",
              sp_impl="ulysses")
    jb, jpre, jpost = jt.llama_spmd(jt.TransformerConfig(**kw), 2)
    with pytest.raises(ValueError) as je:
        JSpmd(jb, 2, jmesh(2, dp=1, sp=4, devices=cpu_devices), chunks=2,
              loss_fn=jt.cross_entropy, pre=jpre, post=jpost, sp_axis="sp")
    block, pre, post = tt.llama_spmd(tt.TransformerConfig(**kw, dtype=torch.float32), 2,
                                     device="cpu")
    with pytest.raises(ValueError, match="sp_impl='ulysses' shards attention heads") as te:
        spmd.SpmdGPipe(block, 2, fake_mesh(pp=2, dp=1, sp=4), chunks=2,
                       loss_fn=tt.cross_entropy, pre=pre, post=post, sp_axis="sp")
    assert str(te.value) == str(je.value)
    q, k = torch.zeros(1, 4, 6, 8), torch.zeros(1, 4, 3, 8)
    with parallel.bind_axes(fake_mesh(sp=4), ["sp"]):
        with pytest.raises(ValueError, match=r"n_heads \(6\) and kv_heads \(3\) must both "
                                             r"be divisible by the 'sp' axis size \(4\)"):
            parallel.ulysses_attention(q, k, k, "sp")


def test_unbound_collectives_name_their_axis():
    with pytest.raises(NameError, match="'sp' is not bound"):
        parallel.ulysses_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                                   torch.zeros(1, 4, 2, 8), "sp")
    with pytest.raises(NameError, match="'tp' is not bound"):
        parallel.psum_value(torch.zeros(2), "tp")
    assert parallel.axis_bound("sp") is None and parallel.axis_bound(None) is None
