"""torchgpipe_tpu_torch.spmd (fill-drain) against the reference's
``SpmdGPipe`` (the mirror of tests/test_spmd.py).

The port's engine is one process per mesh position over gloo: its ranks
are OS processes (tests/torch_spmd_rank.py), each world running every
case of its ``(pp, dp)`` shape once (a module fixture); the reference runs
here on the 8 virtual CPU devices.  Both start from the reference's
initial params and batch.  Loss to rtol 1e-5, gradients to rtol 1e-4 /
atol 1e-5 at float32, as the reference's own SPMD tests hold its engine
(tests/torch_spmd_parity.py).  The engine's argument checks and the
parameter-tree helpers run in this process on a mesh stand-in (no
process group is needed for them).
"""

import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

import torch_spmd_parity as par
from torchgpipe_tpu_torch import convert, spmd
from torchgpipe_tpu_torch.gpipe import GPipe
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops.nn import GELU, Dense, LayerNorm

WORLDS = {
    (2, 1): {
        "mlp_always": dict(model="mlp", chunks=4, batch=16, checkpoint="always"),
        "mlp_except_last": dict(model="mlp", chunks=4, batch=16, checkpoint="except_last"),
        "mlp_never": dict(model="mlp", chunks=4, batch=16, checkpoint="never"),
        "mlp_sum": dict(model="mlp", chunks=4, batch=16, loss_reduction="sum"),
        "mlp_replicated": dict(model="mlp", chunks=4, batch=16, loss_reduction=None),
        "mlp_ragged": dict(model="mlp", chunks=2, batch=7),
        "mlp_ragged_sum": dict(model="mlp", chunks=2, batch=7, loss_reduction="sum"),
        "llama": dict(model="llama", n_layers=2, chunks=2, batch=4,
                      checkpoint="except_last"),
        "llama_tied": dict(model="llama", n_layers=2, chunks=2, batch=4, tied=True),
        "llama_apply": dict(model="llama", n_layers=2, chunks=2, batch=4, apply=True),
    },
    (4, 1): {
        "pp4_always": dict(model="mlp", chunks=4, batch=16, checkpoint="always"),
        "pp4_except_last": dict(model="mlp", chunks=4, batch=16, checkpoint="except_last"),
        "pp4_never": dict(model="mlp", chunks=4, batch=16, checkpoint="never"),
        "pp4_llama_tied": dict(model="llama", n_layers=4, chunks=2, batch=8, tied=True),
    },
    (2, 2): {
        "dp_pre_post": dict(model="mlp", chunks=2, batch=8, pre_post=True),
        "dp_ragged": dict(model="mlp", chunks=2, batch=9),
        "dp_llama_tied": dict(model="llama", n_layers=2, chunks=2, batch=8, tied=True,
                              checkpoint="never"),
        "dp_sgd_step": dict(model="llama", n_layers=2, chunks=2, batch=8, tied=True,
                            step=True),
    },
    (4, 2): {
        "pp4_dp2": dict(model="mlp", chunks=2, batch=16),
        "pp4_dp2_apply": dict(model="mlp", chunks=2, batch=8, apply=True),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp)
         for (pp, dp), cases in WORLDS.items() for name, spec in cases.items()}


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    """Every case: the port ranks' results (one world per mesh shape) and
    the reference's numbers."""
    return par.run_both(WORLDS, CASES, cpu_devices, str(tmp_path_factory.mktemp("spmd")))


@pytest.mark.parametrize("name", [n for n, s in CASES.items()
                                  if not s.get("apply") and not s.get("step")])
def test_train_step_matches_reference(results, name):
    """Loss and every gradient leaf (blocks, pre, post; the tied
    embedding's two paths summed into pre) equal the reference's."""
    port, want = results
    got, ref = port[name], want[name]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=par.LOSS_RTOL)
    par.assert_trees_close(got["grads"], ref["grads"])


@pytest.mark.parametrize("name", [n for n, s in CASES.items() if s.get("apply")])
def test_apply_and_eval_loss_match_reference(results, name):
    port, want = results
    np.testing.assert_allclose(port[name]["out"].numpy(), want[name]["out"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)


def test_make_train_step_updates_every_rank_in_place(results):
    """One ``make_train_step`` SGD step (lr 0.1) over pp=2 x dp=2 with
    tied embeddings: the gathered params equal the reference's params
    minus 0.1 x its gradients (every dp lane updated alike)."""
    port, want = results
    np.testing.assert_allclose(float(port["dp_sgd_step"]["loss"]),
                               want["dp_sgd_step"]["loss"], rtol=par.LOSS_RTOL)
    par.assert_trees_close(port["dp_sgd_step"]["params"], want["dp_sgd_step"]["params"],
                           rtol=1e-5, atol=1e-6)


def test_global_batch_from_local_and_data_placement(results):
    """Each rank's own rows assembled over dp in lane order, on every
    rank (rank 0's copy here); ``pipe_data_sharding`` of an SPMD pipe is
    its rank's device."""
    port, _ = results
    for shape in ("2x2", "4x2"):
        got = port[f"global_batch_{shape}"]["global"]
        base = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        assert torch.equal(got, torch.cat([base, base + 10]))   # lanes 0 and 1 of stage 0
    from torchgpipe_tpu_torch.utils.data import pipe_data_sharding

    pipe = spmd.SpmdGPipe(mlp_block(), 2, fake_mesh(2), chunks=2, loss_fn=mse)
    assert pipe_data_sharding(pipe) == torch.device("cpu")


def test_pp_only_matches_the_ports_gpipe(results):
    """pp only, at the same weights: the SPMD step's loss and gradients
    equal the port's own MPMD ``GPipe`` (the Llama as one layer list,
    cut where the SPMD stages are)."""
    port, want = results
    ref = want["llama"]
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               dtype=torch.float32)
    host = ref["params"]
    flat = [host["pre"]] + [jax.tree_util.tree_map(lambda a: a[j], host["blocks"])[0]
                            for j in range(2)] + [host["post"]]
    model = convert.params_from_jax(cfg, flat, device="cpu")
    pipe = GPipe(list(model), [2, 2], devices=["cpu"], chunks=2, checkpoint="except_last")
    x = torch.from_numpy(np.array(ref["x"])).long()
    loss, _, _ = pipe.value_and_grad(x, x, tt.cross_entropy)
    np.testing.assert_allclose(float(port["llama"]["loss"]), float(loss), rtol=par.LOSS_RTOL)
    g = port["llama"]["grads"]
    pairs = [(g["pre"]["table"], model[0].table)] + [
        (g["blocks"][0][k][j], getattr(model[1 + j], k))
        for j in range(2) for k in g["blocks"][0]] + [
        (g["post"][k], getattr(model[3], k)) for k in g["post"]]
    for a, p in pairs:
        np.testing.assert_allclose(a.numpy(), p.grad.numpy(), rtol=par.GRAD_RTOL,
                                   atol=par.GRAD_ATOL)


def test_params_from_jax_carries_a_stacked_tree(results):
    """``convert.params_from_jax`` of a reference ``SpmdGPipe``'s params
    (numpy leaves) gives the port's tree: same layout, same values,
    tensors on the named device, checked against the port's own
    ``llama_spmd`` structure."""
    _, want = results
    host = want["llama_tied"]["params"]
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               tie_embeddings=True, dtype=torch.float32)
    tree = convert.params_from_jax(cfg, host, device="cpu")
    assert sorted(tree) == ["blocks", "post", "pre"] and "table" not in tree["post"]
    par.assert_trees_close(tree, host, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        bad = dict(host, pre={"table": np.zeros((3, 32), np.float32)})
        convert.params_from_jax(cfg, bad, device="cpu")


# --------------------------------------------------------------------- #
# in-process: validation, layouts, trees                                #
# --------------------------------------------------------------------- #


def fake_mesh(pp, dp=1, coords=(0, 0)):
    """What the engine reads of a :class:`spmd.Mesh`, without a process
    group."""
    return types.SimpleNamespace(
        axis_names=("pp", "dp"), shape={"pp": pp, "dp": dp},
        coords={"pp": coords[0], "dp": coords[1]}, device=torch.device("cpu"),
        rank_of=lambda j, d: j * dp + d)


def mlp_block():
    return nn.Sequential(LayerNorm(8, device="cpu"), Dense(8, 8, device="cpu"), GELU())


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(loss_reduction="max"), ValueError, "loss_reduction must be"),
    (dict(checkpoint="sometimes"), ValueError, "checkpoint="),
    (dict(schedule="gpipe"), ValueError, "schedule must be"),
    (dict(scan_unroll=0), ValueError, "scan_unroll"),
    (dict(megastep=0), ValueError, "megastep must be"),
    (dict(dp_axis="data"), ValueError, "mesh has no 'data' axis"),
    (dict(pp_axis="stages"), ValueError, "mesh has no 'stages' axis"),
    (dict(virtual_stages=2), ValueError, "virtual_stages only applies"),
    (dict(sp_axis="dp", loss_reduction=None), ValueError, "decomposable loss"),
    (dict(fsdp=True), ValueError, "fsdp shards parameters over the data-parallel lanes"),
    (dict(schedule="zb", checkpoint="except_last"), ValueError, "no zb counterpart"),
    (dict(schedule="interleaved", virtual_stages=1), ValueError, "virtual_stages >= 2"),
    (dict(schedule="interleaved", virtual_stages=2, chunks=3), ValueError,
     r"chunks \(3\) divisible by n_stages \(2\)"),
    (dict(schedule="1f1b", virtual_stages=2), ValueError, "virtual_stages only applies"),
    (dict(zero_update=2), ValueError, "zero=2 is not a supported ZeRO level"),
    (dict(ep_axis="dp", loss_reduction=None), ValueError, "batch-decomposable loss"),
    (dict(checkpoint="offload", schedule="1f1b"), ValueError, "fill_drain feature"),
    (dict(remat_policy=lambda *a: None), NotImplementedError, r"queue A item 2\b"),
    (dict(fsdp=True, dp_axis="dp", ep_axis="dp"), ValueError, r"fsdp \+ ep is not supported"),
])
def test_constructor_validation(kw, exc, match):
    kw = dict(dict(chunks=2), **kw)
    with pytest.raises(exc, match=match):
        spmd.SpmdGPipe(mlp_block(), 2, fake_mesh(2), loss_fn=mse, **kw)


def test_constructor_checks_mesh_and_skips():
    with pytest.raises(ValueError, match="pp mesh axis size 4 != n_stages 2"):
        spmd.SpmdGPipe(mlp_block(), 2, fake_mesh(4), chunks=2, loss_fn=mse)
    from torchgpipe_tpu_torch import skip

    with pytest.raises(ValueError, match=r"chain\(\) stage"):
        spmd.SpmdGPipe(skip.stash("a"), 2, fake_mesh(2), chunks=2, loss_fn=mse)
    cfg = tt.TransformerConfig(vocab=16, dim=16, n_layers=2, n_heads=2,
                               tie_embeddings=True, dtype=torch.float32)
    block, pre, post = tt.llama_spmd(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="fill_drain schedule"):
        spmd.SpmdGPipe(block, 2, fake_mesh(2), chunks=2, loss_fn=tt.cross_entropy,
                       pre=pre, post=post, schedule="1f1b")
    with pytest.raises(ValueError, match="no pre layer"):
        spmd.SpmdGPipe(block, 2, fake_mesh(2), chunks=2, loss_fn=tt.cross_entropy,
                       post=post)


def test_repr():
    pipe = spmd.SpmdGPipe(mlp_block(), 2, fake_mesh(2, 2), chunks=4, loss_fn=mse,
                          dp_axis="dp", loss_reduction="sum", schedule="1f1b")
    assert repr(pipe) == (
        "SpmdGPipe(block='Sequential', n_stages=2, chunks=4, checkpoint='always', "
        "mesh={'pp': 2, 'dp': 2}, loss_reduction='sum', schedule='1f1b')")


def test_init_place_and_param_checks():
    """``init`` stacks a stage's tree per stage from one generator (equal
    on every rank), refuses a shape-changing or stateful block; ``place``
    keeps this stage's slice; ``train_step`` refuses foreign trees with the
    reference's messages."""
    cfg = tt.TransformerConfig(vocab=16, dim=16, n_layers=4, n_heads=2,
                               dtype=torch.float32)
    tokens = torch.zeros(4, 8, dtype=torch.long)
    b4, pre4, post4 = tt.llama_spmd(cfg, 4, device="cpu")
    eng4 = spmd.SpmdGPipe(b4, 4, fake_mesh(4, coords=(2, 0)), chunks=2,
                          loss_fn=tt.cross_entropy, pre=pre4, post=post4)
    p4 = eng4.init(torch.Generator().manual_seed(0), tokens)
    again = eng4.init(torch.Generator().manual_seed(0), tokens)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(spmd._items(p4), spmd._items(again)))
    wq = p4["blocks"][0]["wq"]
    assert wq.shape[0] == 4 and not torch.equal(wq[0], wq[1])
    local = eng4.place(p4)
    assert torch.equal(local["blocks"][0]["wq"], wq[2:3])
    cfg2 = tt.TransformerConfig(vocab=16, dim=16, n_layers=2, n_heads=2,
                                dtype=torch.float32)
    b2, pre2, post2 = tt.llama_spmd(cfg2, 2, device="cpu")
    eng2 = spmd.SpmdGPipe(b2, 2, fake_mesh(2), chunks=2, loss_fn=tt.cross_entropy,
                          pre=pre2, post=post2)
    with pytest.raises(ValueError, match="different pipeline configuration"):
        eng2.train_step(p4, tokens, tokens)
    with pytest.raises(ValueError, match="different pipeline configuration"):
        eng2.place(p4)
    with pytest.raises(ValueError, match="params must be the dict"):
        eng2.train_step(p4["blocks"], tokens, tokens)
    with pytest.raises(ValueError, match="pre"):
        eng4.train_step({k: v for k, v in local.items() if k != "pre"}, tokens, tokens)
    grow = spmd.SpmdGPipe(Dense(8, 16, device="cpu"), 2, fake_mesh(2), chunks=2,
                          loss_fn=mse)
    with pytest.raises(ValueError, match="preserve activation"):
        grow.init(None, ((4, 8), torch.float32))
    from torchgpipe_tpu_torch.ops.nn import BatchNorm

    bn = spmd.SpmdGPipe(nn.Sequential(Dense(8, 8, device="cpu"), BatchNorm(8, device="cpu")),
                        2, fake_mesh(2), chunks=2, loss_fn=mse)
    with pytest.raises(ValueError, match="stateless"):
        bn.init(None, ((4, 8), torch.float32))


def test_ragged_batch_needs_decomposable_loss():
    pipe = spmd.SpmdGPipe(mlp_block(), 2, fake_mesh(2), chunks=2, loss_fn=mse,
                          loss_reduction=None)
    params = pipe.place(pipe.init(None, ((4, 8), torch.float32)))
    with pytest.raises(ValueError, match="row-decomposable"):
        pipe.train_step(params, torch.zeros(7, 8), torch.zeros(7, 8))


def test_specs_and_trees():
    """The partition-spec helpers and the module trees in the reference's
    layout."""
    block = mlp_block()
    assert spmd.layer_param_specs(block, "pp") == spmd.P("pp")
    assert spmd.layer_param_specs(block) == spmd.P()
    block[1].meta = {"param_specs": {"w": spmd.P(None, "tp"), "b": spmd.P("tp")}}
    specs = spmd.layer_param_specs(block, "pp")
    assert specs == (spmd.P("pp"), {"w": spmd.P("pp", None, "tp"), "b": spmd.P("pp", "tp")},
                     spmd.P("pp"))
    tree = spmd.module_tree(block)
    assert [sorted(t) if t else t for t in tree] == [["bias", "scale"], ["b", "w"], ()]
    full = spmd.broadcast_specs(specs, tree)
    assert full[0] == {"scale": spmd.P("pp"), "bias": spmd.P("pp")}
    assert spmd.spec_mentions(spmd.P("pp", ("dp", "tp")), "tp")
    assert not spmd.spec_mentions(spmd.P("pp", None), "tp")
    with pytest.raises(ValueError):
        spmd.broadcast_specs((spmd.P(),), tree)
    names = spmd.module_tree(block, lambda n, p: n)
    assert names[1] == {"w": "1.w", "b": "1.b"}


def test_make_mesh_needs_a_process_group_and_refuses_later_axes():
    """ep, sp and tp need a process group of ``pp * dp * ep * sp * tp``
    ranks like the rest (``ep``, sub-slice e, no longer raises
    NotImplementedError)."""
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            spmd.make_mesh(2)
        with pytest.raises(RuntimeError, match=r"n_stages \* dp \* sp \* tp = 4"):
            spmd.make_mesh(2, 1, 2)
        with pytest.raises(RuntimeError, match=r"n_stages \* dp \* sp \* tp \* ep = 8"):
            spmd.make_mesh(2, 2, ep=2)


def test_1f1b_closed_form_is_a_legal_schedule():
    """The tick table (the reference's closed form) has one cell per stage
    per tick, and every cell's inputs are ready a tick before it runs."""
    for n, m in [(2, 2), (2, 5), (4, 1), (4, 3), (4, 8), (3, 7)]:
        seen = set()
        for j in range(n):
            for i in range(m):
                for t in (spmd.fwd_tick(i, j, n), spmd.bwd_tick(i, j, n)):
                    assert (t, j) not in seen
                    seen.add((t, j))
                if j:
                    assert spmd.fwd_tick(i, j, n) > spmd.fwd_tick(i, j - 1, n)
                if j < n - 1:
                    assert spmd.bwd_tick(i, j, n) > spmd.bwd_tick(i, j + 1, n)
                assert spmd.bwd_tick(i, j, n) > spmd.fwd_tick(i, j, n)


def test_generation_helpers_match_reference(cpu_devices):
    """``spmd_params_for_generation`` of a tied SPMD tree gives the model
    ``generate`` takes: greedy tokens equal the reference's helper and
    ``generate`` at the same weights; ``spmd_params_from_flat`` inverts it
    (the tied table stripped from the head)."""
    import jax.numpy as jnp

    from torchgpipe_tpu.models import generation as jg
    from torchgpipe_tpu.models import transformer as jt
    from torchgpipe_tpu.spmd import SpmdGPipe as JSpmd, make_mesh as jmesh
    from torchgpipe_tpu_torch.models import generation as tg

    jcfg = jt.TransformerConfig(vocab=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
                                tie_embeddings=True)
    jb, jpre, jpost = jt.llama_spmd(jcfg, 2)
    jpipe = JSpmd(jb, 2, jmesh(2, 1, devices=cpu_devices[:2]), chunks=2,
                  loss_fn=jt.cross_entropy, pre=jpre, post=jpost)
    prompt = np.arange(12, dtype=np.int32).reshape(2, 6) % 64
    jparams = jpipe.init(jax.random.PRNGKey(3), jax.ShapeDtypeStruct(prompt.shape, jnp.int32))
    want = np.asarray(jg.generate(jcfg, jg.spmd_params_for_generation(jpipe, jparams),
                                  jnp.asarray(prompt), 6))
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
                               tie_embeddings=True, dtype=torch.float32)
    block, pre, post = tt.llama_spmd(cfg, 2, device="cpu")
    pipe = spmd.SpmdGPipe(block, 2, fake_mesh(2), chunks=2, loss_fn=tt.cross_entropy,
                          pre=pre, post=post)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    params = convert.params_from_jax(cfg, host, device="cpu")
    model = tg.spmd_params_for_generation(pipe, params, device="cpu")
    got = tg.generate(cfg, model, torch.from_numpy(prompt).long(), 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    back = tg.spmd_params_from_flat(pipe, model)
    assert "table" not in back["post"]
    par.assert_trees_close(back, host, rtol=0, atol=0)
