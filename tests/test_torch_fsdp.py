"""FSDP (ZeRO-3 storage) and the ZeRO levels of
torchgpipe_tpu_torch.spmd, against the reference (the mirror of
tests/test_fsdp.py and of tests/test_optimizer.py's ZeRO gates).

``fsdp=True`` stores each block leaf sharded over dp on the reference's
chosen dim; a step all-gathers the full tensors, runs the schedule, and
reduce-scatters the gradients back.  The port's fsdp steps are held
against the reference's fsdp engine at the same weights and batch: loss
to rtol 1e-5, gradients (gathered) to rtol 1e-4 / atol 1e-5 at float32,
as tests/test_torch_spmd.py (other summation orders, a few float32 ulps
apart), and against the port's own ``fsdp=False`` engine at the same
tolerances.  The ZeRO updates are held BITWISE to the port's own
unsharded update (the reference's
``test_zero_sharded_update_bitwise_equals_unsharded`` fails on this jax,
ROADMAP.md C): elementwise optimizers compute each element alike whatever
the tensor it sits in, so a segment or shard of the update is the update
of the segment.  Ranks are OS processes over gloo
(tests/torch_spmd_rank.py); the argument checks and the dim chooser run
in this process on a mesh stand-in.
"""

import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

import torch_spmd_parity as par
from torchgpipe_tpu_torch import spmd
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops.nn import GELU, Dense, LayerNorm

LLAMA = dict(model="llama", n_layers=2, chunks=2, batch=8)
WORLDS = {
    (2, 2): {
        "fsdp_fill_drain": dict(model="mlp", chunks=2, batch=8, pre_post=True, fsdp=True),
        "fsdp_1f1b": dict(LLAMA, schedule="1f1b", checkpoint="except_last", fsdp=True),
        "fsdp_llama_tied": dict(LLAMA, tied=True, checkpoint="never", fsdp=True),
        "nofsdp_llama_tied": dict(LLAMA, tied=True, checkpoint="never"),
        "fsdp_ragged": dict(model="mlp", chunks=2, batch=9, fsdp=True),
        "fsdp_step": dict(LLAMA, tied=True, fsdp=True, step=True),
        "fsdp_place": dict(LLAMA, fsdp=True, place=True),
        "zero": dict(LLAMA, zero=True),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp)
         for (pp, dp), cases in WORLDS.items() for name, spec in cases.items()}


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return par.run_both(WORLDS, CASES, cpu_devices, str(tmp_path_factory.mktemp("fsdp")))


@pytest.mark.parametrize("name", ["fsdp_fill_drain", "fsdp_1f1b", "fsdp_llama_tied",
                                  "fsdp_ragged"])
def test_fsdp_matches_reference(results, name):
    """Loss and every gradient leaf (the block shards gathered over dp)
    equal the reference's fsdp engine's."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"])


def test_fsdp_is_invisible_to_the_math(results):
    """The port's fsdp step against its own ``fsdp=False`` step at the
    same weights (the reference's ``test_fsdp_transparency``)."""
    port, _ = results
    got, want = port["fsdp_llama_tied"], port["nofsdp_llama_tied"]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=par.LOSS_RTOL)
    par.assert_trees_close(got["grads"], want["grads"])


def test_fsdp_make_train_step(results):
    """One SGD step of an fsdp pipe (the plain update of the storage
    shards): the gathered params equal the reference's params minus 0.1
    times its gradients."""
    port, want = results
    np.testing.assert_allclose(float(port["fsdp_step"]["loss"]), want["fsdp_step"]["loss"],
                               rtol=par.LOSS_RTOL)
    par.assert_trees_close(port["fsdp_step"]["params"], want["fsdp_step"]["params"],
                           rtol=1e-5, atol=1e-6)


def test_fsdp_storage_is_the_references(results, cpu_devices):
    """Each rank stores 1/dp of every leaf the reference shards, on the
    reference's dim: every rank's leaf has the shape of the reference's
    per-device shard, and ``gather`` reassembles the global tree."""
    port, _ = results
    spec = CASES["fsdp_place"]
    pipe, params, _, _ = par.reference(spec, cpu_devices)
    pipe._ensure_fsdp(params["blocks"])
    ranks = port["fsdp_place"]["ranks"]
    sharded = 0
    for (path, ref), (_, dim) in zip(par.items(params["blocks"]),
                                     par.items(pipe._fsdp_dims)):
        shard = ref.addressable_shards[0].data.shape
        for tree in ranks:
            assert tuple(spmd._get(tree["blocks"], path).shape) == tuple(shard), path
        sharded += dim >= 0
    assert sharded >= 7
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    par.assert_trees_close(port["fsdp_place"]["params"], host, rtol=0, atol=0)


def test_zero_updates_are_bitwise_the_unsharded_update(results):
    """Two ``make_train_step`` updates on every rank, for SGD with
    momentum, Adam and AdamW: ``zero=1`` equals ``zero=0`` bitwise
    (losses and params), and an fsdp pipe's ``zero=3`` equals the
    unsharded update of the gathered tensors bitwise.  Per rank, ZeRO-1's
    state is 1/dp of ZeRO-0's (each leaf's segment padded to a multiple
    of dp), and ZeRO-3 stores half the block elements."""
    z = results[0]["zero"]
    dp = CASES["zero"]["dp"]
    for name in ("sgd", "adam", "adamw"):
        assert bool(z[f"{name}_zero1"].all()), name
        assert bool(z[f"{name}_zero3"].all()), name
        state = z[f"{name}_state"]        # [pp, dp, 4]: zero=0, 1, 3, unsharded
        assert bool((state[..., 0] > 0).all())
        # each of a rank's (at most 64) state tensors pads to a multiple of dp
        pad = state[..., 1] * dp - state[..., 0]
        assert bool(((pad >= 0) & (pad < dp * 64)).all()), name
        assert bool((state[..., 2] < state[..., 3]).all()), name
    blocks = z["block_numel"]                 # [pp, dp, 2]: fsdp=False, fsdp
    assert bool((blocks[..., 1] * dp == blocks[..., 0]).all())


# --------------------------------------------------------------------- #
# in-process: the layout, the levels and their errors                   #
# --------------------------------------------------------------------- #


def stand_in(pp, dp, tp=1):
    """What the engine reads of a :class:`spmd.Mesh`, without a process
    group."""
    names = ("pp", "dp") + (("tp",) if tp > 1 else ())
    sizes = {"pp": pp, "dp": dp, "tp": tp}
    return types.SimpleNamespace(
        axis_names=names, shape={a: sizes[a] for a in names},
        coords={a: 0 for a in names}, device=torch.device("cpu"))


def mlp_block():
    return nn.Sequential(LayerNorm(8, device="cpu"), Dense(8, 8, device="cpu"), GELU())


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def test_fsdp_dim_chooser_invariants():
    """Per leaf, the chooser never picks dim 0 (the stage dim) or a dim
    another axis shards, always one dp divides, -1 when nothing qualifies
    (the reference's ``test_fsdp_dim_chooser_invariants``)."""
    pp, dp, tp = 2, 2, 2
    cfg = tt.TransformerConfig(vocab=64, dim=16, n_layers=pp, n_heads=4, n_kv_heads=2,
                               tp_axis="tp", dtype=torch.float32)
    block, pre, post = tt.llama_spmd(cfg, pp, device="cpu")
    pipe = spmd.SpmdGPipe(block, pp, stand_in(pp, dp, tp), chunks=2,
                          loss_fn=tt.cross_entropy, pre=pre, post=post, dp_axis="dp",
                          tp_axis="tp", fsdp=True)
    base = spmd.broadcast_specs(pipe._blocks_spec, pipe._global_blocks)
    checked = sharded = 0
    for (_, spec), (_, dim), (_, leaf) in zip(spmd._items(base), spmd._items(pipe._fsdp_dims),
                                             spmd._items(pipe._global_blocks)):
        checked += 1
        if dim < 0:
            assert all(leaf.shape[i] % dp or (i < len(spec) and spec[i] is not None)
                       for i in range(1, leaf.ndim))
            continue
        sharded += 1
        assert dim >= 1 and (spec[dim] if dim < len(spec) else None) is None
        assert leaf.shape[dim] % dp == 0
    assert checked > 0 and sharded > 0
    # What tp already shards stays tp's: wq's columns are tp's, its rows dp's.
    wq = pipe._specs["blocks"][0]["wq"]
    assert wq == spmd.P("pp", "dp", "tp")


def test_fsdp_constructor_errors_match_reference(cpu_devices):
    from torchgpipe_tpu.layers import chain
    from torchgpipe_tpu.ops import dense, gelu, layer_norm
    from torchgpipe_tpu.spmd import SpmdGPipe, make_mesh

    jblock = chain([layer_norm(name="ln"), dense(8, name="fc"), gelu("act")], name="block")
    for kw, mesh in ((dict(fsdp=True), make_mesh(2, 1, devices=cpu_devices[:2])),
                     (dict(fsdp=True, dp_axis="dp", ep_axis="ep"),
                      make_mesh(2, 2, ep=2, devices=cpu_devices[:8]))):
        with pytest.raises(ValueError) as je:
            SpmdGPipe(jblock, 2, mesh, chunks=2, loss_fn=mse, **kw)
        stand = stand_in(2, 2)
        stand.axis_names += ("ep",)
        stand.shape["ep"], stand.coords["ep"] = 2, 0
        with pytest.raises(ValueError) as te:
            spmd.SpmdGPipe(mlp_block(), 2, stand, chunks=2, loss_fn=mse, **kw)
        assert str(te.value) == str(je.value)
    # 'use' is accepted and runs 'block', as the reference.
    pipe = spmd.SpmdGPipe(mlp_block(), 2, stand_in(2, 2), chunks=2, loss_fn=mse,
                          dp_axis="dp", fsdp=True, gather_schedule="use")
    assert pipe.gather_schedule == "use"


def test_zero_level_errors_match_reference(cpu_devices):
    """Every ``_zero_level`` / ``_zero_check`` refusal, word for word."""
    from torchgpipe_tpu.layers import chain
    from torchgpipe_tpu.ops import dense, gelu, layer_norm
    from torchgpipe_tpu.spmd import SpmdGPipe, make_mesh

    jblock = chain([layer_norm(name="ln"), dense(8, name="fc"), gelu("act")], name="block")
    for fsdp, dp, zero in ((False, 2, 2), (False, 2, "yes"), (True, 2, 1), (False, 2, 3),
                           (False, 1, 1), (True, 2, 7)):
        jmesh = make_mesh(2, dp, devices=cpu_devices[:2 * dp])
        jpipe = SpmdGPipe(jblock, 2, jmesh, chunks=2, loss_fn=mse, dp_axis="dp",
                          fsdp=fsdp)
        with pytest.raises(ValueError) as je:
            jpipe._zero_check(jpipe._zero_level(zero))
        pipe = spmd.SpmdGPipe(mlp_block(), 2, stand_in(2, dp), chunks=2, loss_fn=mse,
                              dp_axis="dp", fsdp=fsdp)
        with pytest.raises(ValueError) as te:
            pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=0.1), zero=zero)
        assert str(te.value) == str(je.value)
        if zero != 1 or dp == 2:   # the declared level is checked at construction
            with pytest.raises(ValueError) as te:
                spmd.SpmdGPipe(mlp_block(), 2, stand_in(2, dp), chunks=2, loss_fn=mse,
                               dp_axis="dp", fsdp=fsdp, zero_update=zero)
            assert str(te.value) == str(je.value)
    pipe = spmd.SpmdGPipe(mlp_block(), 2, stand_in(2, 2), chunks=2, loss_fn=mse,
                          dp_axis="dp", fsdp=True, zero_update=True)
    assert pipe._zero_level() == 3 and pipe._zero_level(False) == 0


def test_zero_refusals_and_state_size():
    """ZeRO-1 refuses a layout that shards a leaf over dp and an
    optimizer whose state is neither the segment's shape nor a scalar
    (the reference's texts); a segment is ``ceil(numel / dp)`` elements,
    the padding zeros."""
    block = mlp_block()
    block[1].meta = {"param_specs": {"w": spmd.P(None, "dp"), "b": spmd.P()}}
    pipe = spmd.SpmdGPipe(block, 2, stand_in(2, 2), chunks=2, loss_fn=mse, dp_axis="dp")
    params = pipe.place(pipe.init(torch.Generator().manual_seed(0), ((4, 8), torch.float32)))
    with pytest.raises(ValueError, match=r"zero=True needs dp-replicated parameters, but the "
                                         r"layout shards leaf 'blocks/1/w' over the dp axis"):
        pipe.zero_opt_state(lambda ts: torch.optim.SGD(ts, lr=0.1), params, zero=1)

    class Odd(torch.optim.Optimizer):
        """State of another shape than its parameter's."""

        def __init__(self, params):
            super().__init__(params, {})

        def step(self):
            for p in self.param_groups[0]["params"]:
                self.state[p]["extra"] = torch.zeros(p.numel() + 1)

    pipe = spmd.SpmdGPipe(mlp_block(), 1, stand_in(1, 3), chunks=2, loss_fn=mse,
                          dp_axis="dp")
    params = pipe.place(pipe.init(torch.Generator().manual_seed(0), ((4, 8), torch.float32)))
    opt = pipe.zero_opt_state(Odd, params)
    assert opt.zero_level == 1
    assert [s.shape for s in opt.zero_segments] == [(3,), (3,), (22,), (3,)]
    w = params["blocks"][1]["w"].reshape(-1)
    assert torch.equal(opt.zero_segments[2], w[:22])
    with pytest.raises(ValueError, match=r"state has a leaf of shape \(4,\) that matches "
                                         r"neither — use zero=False"):
        pipe._zero_apply(opt, pipe._flat(params))
