"""Expert parallelism in torchgpipe_tpu_torch.spmd (``make_mesh(ep=)``,
``SpmdGPipe(ep_axis=)``, ``MoEConfig(ep_axis=)``, ``llama_moe_spmd``),
against the reference (the mirror of tests/test_moe.py's ep cases).

One world of four rank processes over gloo, pp=2 x ep=2
(tests/torch_spmd_rank.py): each ep lane holds 2 of a Llama's 4 experts
(dim 32, 2 MoE blocks, top-2 at capacity factor 8, so no token drops at
the lane's or the whole batch's token count) and its own rows of the
batch; the experts' buffers cross the lanes by all-to-all.  The
reference runs the same cases on four virtual CPU devices
(``make_mesh(2, 1, ep=2)``) from the same drawn params and batch.

Tolerances, as tests/torch_spmd_parity.py states them for every SPMD
parity file: float32 on both sides, the same products summed in other
orders (a cell's einsums, the all-to-all's concatenation, the pp and ep
reductions) a few float32 ulps apart: the loss to rtol 1e-5, every
gradient leaf (each rank's expert shard, gathered) to rtol 1e-4 / atol
1e-5.  Placement and conversion move values only: bitwise.
"""

import types

import jax
import numpy as np
import pytest
import torch

import torch_spmd_parity as par
from torchgpipe_tpu.models import moe as jm
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import convert, spmd
from torchgpipe_tpu_torch.models import moe as tm
from torchgpipe_tpu_torch.models import transformer as tt

MOE = dict(model="moe", n_layers=2, chunks=2)
WORLDS = {
    (2, 1, 1, 1, 2): {   # pp=2 x ep=2
        "ep_dense": dict(MOE, batch=8, checkpoint="always"),
        "ep_sparse": dict(MOE, batch=8, dispatch="sparse", checkpoint="except_last"),
        "ep_ragged": dict(MOE, batch=7, checkpoint="never"),
        "ep_1f1b": dict(MOE, batch=8, schedule="1f1b", checkpoint="except_last",
                        balance_weight=0.01),
        "ep_apply": dict(MOE, batch=8, apply=True),
        "ep_place": dict(MOE, batch=8, place=True),
    },
}
CASES = {name: dict(spec, pp=shape[0], dp=shape[1], ep=shape[4])
         for shape, cases in WORLDS.items() for name, spec in cases.items()}
# The reference's unsharded pp=2 run of ep_dense's model and batch (its
# test_spmd_moe_ep_transparency oracle: ep changes no init math).
EXTRA = {"unsharded": dict(CASES["ep_dense"], ep=1)}


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return par.run_both(WORLDS, CASES, cpu_devices,
                        str(tmp_path_factory.mktemp("spmd_moe_ep")), extra=EXTRA)


@pytest.mark.parametrize("name", [n for n, s in CASES.items()
                                  if not (s.get("apply") or s.get("place"))])
def test_matches_reference(results, name):
    """Loss and every gradient leaf (the expert leaves each ep lane's
    half, gathered) equal the reference's pp=2 x ep=2 step: dense and
    sparse dispatch, a ragged batch (7 rows padded to chunks*ep = 4's
    multiple, the mask scaled by dp*ep/N_real) and 1F1B with the balance
    penalty's gradient."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"])


def test_ep_is_transparent(results):
    """The ep=2 step equals the reference's unsharded pp=2 step on the
    same params and batch (the only difference is where experts live)."""
    port, want = results
    unsharded = want["extra:unsharded"]
    par.assert_trees_close(port["ep_dense"]["grads"], unsharded["grads"])
    np.testing.assert_allclose(float(port["ep_dense"]["loss"]), unsharded["loss"],
                               rtol=par.LOSS_RTOL)


def test_sparse_dispatch_matches_dense_under_ep(results):
    """The sparse buffers feed the same all-to-all round trip as the dense
    einsums: the same loss and gradients (the reference's tolerances for
    this pair, rtol 1e-6 / 1e-5)."""
    port, _ = results
    dense, sparse = port["ep_dense"], port["ep_sparse"]
    np.testing.assert_allclose(float(sparse["loss"]), float(dense["loss"]), rtol=1e-6)
    got, ref = dict(par.items(sparse["grads"])), dict(par.items(dense["grads"]))
    assert sorted(map(str, got)) == sorted(map(str, ref))
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[path].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))


def test_apply_and_eval_loss_under_ep(results):
    """``apply`` (the rows gathered over ep) and ``eval_loss`` (averaged
    over ep) equal the reference's."""
    port, want = results
    np.testing.assert_allclose(port["ep_apply"]["out"].numpy(), want["ep_apply"]["out"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(port["ep_apply"]["loss"]), want["ep_apply"]["loss"],
                               rtol=par.LOSS_RTOL)


def test_placement_and_conversion_of_an_ep_tree(results):
    """Each rank holds its stage's slice and its ep lane's experts (dim 1
    of ``[1, E, ...]`` cut to ``E/ep``), the router and every other leaf
    whole; ``gather`` gives the drawn tree back bitwise, and
    ``convert.spmd_params_from_jax(cfg, reference params, moe=)`` is that
    tree, bitwise."""
    port, want = results
    ranks, whole = port["ep_place"]["ranks"], want["ep_place"]["params"]
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(whole))
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               dtype=torch.float32)
    moe = tm.MoEConfig(**par.moe_kw(CASES["ep_place"]))
    converted = convert.spmd_params_from_jax(cfg, host, device="cpu", moe=moe)
    par.assert_trees_close(converted, host, rtol=0, atol=0)
    par.assert_trees_close(port["ep_place"]["params"], host, rtol=0, atol=0)
    for rank, tree in enumerate(ranks):
        j, e = divmod(rank, 2)
        mlp = tree["blocks"][0]["mlp"]
        want_w = host["blocks"][0]["mlp"]["w_gate"][j:j + 1, 2 * e:2 * e + 2]
        np.testing.assert_array_equal(mlp["w_gate"].numpy(), want_w)
        np.testing.assert_array_equal(mlp["router"].numpy(),
                                      host["blocks"][0]["mlp"]["router"][j:j + 1])
        assert tuple(tree["pre"]["table"].shape) == (64, 32)


# --------------------------------------------------------------------- #
# refusals, word for word                                               #
# --------------------------------------------------------------------- #

JCFG = jt.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=2)
TCFG = tt.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=2,
                            dtype=torch.float32)


@pytest.mark.parametrize("kw", [dict(dispatch="dropless"), dict(router="expert_choice")])
def test_capacity_paths_only_under_ep(kw):
    """``dispatch='dropless'`` and ``router='expert_choice'`` need local
    experts: the reference's errors."""
    with pytest.raises(ValueError) as je:
        jm.moe_mlp(JCFG, jm.MoEConfig(n_experts=4, ep_axis="ep", **kw))
    with pytest.raises(ValueError) as te:
        tm.MoEMLP(TCFG, tm.MoEConfig(n_experts=4, ep_axis="ep", **kw), device="cpu")
    assert str(te.value) == str(je.value)


def fake_mesh(**shape):
    """What the engine's checks read of a mesh, without a process group."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                                 coords={a: 0 for a in shape}, device=torch.device("cpu"))


def _engines(moe_kw, mesh_shape, **kw):
    """The reference's and the port's engine constructions of one case
    (their errors compared by the callers)."""
    from torchgpipe_tpu.spmd import SpmdGPipe, make_mesh

    out = []
    jb, jpre, jpost = jm.llama_moe_spmd(JCFG, jm.MoEConfig(**moe_kw), 2)
    devices = jax.devices()[:2 * int(np.prod(list(mesh_shape.values())))]
    jmesh = make_mesh(2, mesh_shape.get("dp", 1), ep=mesh_shape.get("ep", 1), devices=devices)
    out.append(lambda: SpmdGPipe(jb, 2, jmesh, chunks=2, loss_fn=jt.cross_entropy, pre=jpre,
                                 post=jpost, **kw))
    tb, tpre, tpost = tm.llama_moe_spmd(TCFG, tm.MoEConfig(**moe_kw), 2, device="cpu")
    out.append(lambda: spmd.SpmdGPipe(tb, 2, fake_mesh(pp=2, **mesh_shape), chunks=2,
                                      loss_fn=tt.cross_entropy, pre=tpre, post=tpost, **kw))
    return out


@pytest.mark.parametrize("case", ["indivisible", "undeclared", "fsdp"])
def test_engine_refusals_match_the_reference(cpu_devices, case):
    """Indivisible experts (6 over ep=4), a model routed for ep that the
    engine was not told of, and fsdp with ep: the reference's errors."""
    moe, shape, kw = {
        "indivisible": (dict(n_experts=6, top_k=1, ep_axis="ep"), dict(dp=1, ep=4),
                        dict(ep_axis="ep")),
        "undeclared": (dict(n_experts=4, top_k=1, ep_axis="ep"), dict(dp=1, ep=2), {}),
        "fsdp": (dict(n_experts=4, top_k=1, ep_axis="ep"), dict(dp=2, ep=2),
                 dict(ep_axis="ep", dp_axis="dp", fsdp=True)),
    }[case]
    ref, port = _engines(moe, shape, **kw)
    with pytest.raises(ValueError) as je:
        ref()
    with pytest.raises(ValueError) as te:
        port()
    assert str(te.value) == str(je.value)
