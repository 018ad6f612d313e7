"""Sharded checkpoints of the SPMD engine (ROADMAP A.5.4e3):
``CheckpointManager`` in a multi-process job and its ``sharded=True``
backend, ``utils.serialization.save_sharded`` / ``restore_sharded`` and
``SpmdGPipe.train_state`` / ``load_train_state``.

One world of four port ranks (pp=2 x dp=2, ``fsdp=True``, ZeRO-3 AdamW,
a 2-block Llama; tests/torch_spmd_rank.py ``run_ckpt``) runs every case
of the world; the checks of other meshes read its files here, in one
process.  The oracles are the reference's round trips as behaviour, not
its bytes (orbax): tests/test_resilience.py:114 (a snapshot resumes, a
corrupted one falls back to the next older), tests/test_utils_aux.py:164
and :349 (``save_sharded`` replaces through a temp directory and a
restore gives the tree back) and :600 (the filesystem surgery is rank
0's alone and no rank branches on its own probe of the filesystem).
Every comparison is bitwise: the same float32 values written and read
back, and a resumed step is the same computation on the same values.
"""

import jax
import numpy as np
import pytest
import torch

import torch_spmd_parity as par
from torchgpipe_tpu_torch import spmd
from torchgpipe_tpu_torch.resilience.checkpoint import CheckpointError
from torchgpipe_tpu_torch.utils import serialization as ser

SPEC = dict(model="llama", n_layers=2, pp=2, dp=2, chunks=2, batch=8, fsdp=True, zero=3,
            ckpt=True)


@pytest.fixture(scope="module")
def world(cpu_devices, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_ckpt"))
    case = par.port_inputs(SPEC, *par.reference(SPEC, cpu_devices))
    res = par.run_port({"ckpt": case}, 2, 2, out)["ckpt"]
    return res, f"{out}/res_2x2/ckpt"   # the ranks' checkpoint root


def test_resume_from_a_sharded_snapshot_is_bitwise(world):
    """A fresh engine restores the snapshot of step 1 (the newest, of step
    2, has a flipped byte in one rank's file, so the whole snapshot falls
    back) and retakes step 2: loss, every parameter shard and AdamW's
    state bitwise the uninterrupted run's, on every rank."""
    ranks = world[0]["ranks"]
    assert [r["fell_back_to"] for r in ranks] == [1] * 4
    assert all(r["resume_bitwise"] for r in ranks)


def test_manager_protocol_in_the_world(world):
    """A sharded restore without a template names the template; GC keeps
    the last two complete snapshots; a same-step re-save leaves no temp
    or ``.old`` directory, and a crash between its renames restores from
    ``.old``; ``world_size=`` returns an npz snapshot flat when the
    recorded world differs; saves succeed with renames, removals and
    existence probes refused on every rank but 0, and a second
    ``overwrite=False`` save refuses on every rank (rank 0's look)."""
    for r in world[0]["ranks"]:
        assert r["template_refused"]
        assert r["steps_after_gc"] == [2, 3]
        assert r["resave_clean"] == ["step_0000000002", "step_0000000003"]
        assert r["old_recovered"]
        assert r["world_size_flat"]
        assert r["gated_swap"]
        assert r["no_clobber"]
        assert r["zero1_same_mesh"]


def _global_template(g):
    return {"params": {k: spmd._tree_map(torch.empty_like, v) for k, v in g.items()}}


def test_restore_into_a_gathered_tree(world):
    """The step-1 copy restores, in one process with no mesh, into whole
    tensors: the gathered params bitwise."""
    res, out = world
    g = res["gathered"]["params"]
    back = ser.restore_sharded(f"{out}/one", _global_template(g))
    for (path, want), (_, got) in zip(par.items(g), par.items(back["params"])):
        assert torch.equal(got, want), path


def test_restore_into_dp1_reshards_params_and_optimizer_state(world):
    """The pp=2 x dp=2 fsdp copy restores into each stage of pp=2 x dp=1
    (blocks ``[1, ...]``, whole), the ZeRO-3 moments too (their leaves'
    slices): bitwise the gathered step-1 values."""
    res, out = world
    g = res["gathered"]
    keys = [k for k in ("pre", "blocks", "post") if k in g["params"]]
    for j in range(2):
        def stage(tree, name):
            if name != "blocks":
                return spmd._tree_map(torch.empty_like, tree)
            return spmd._tree_map(lambda a: ser.Shard(torch.empty_like(a[j:j + 1]), tuple(a.shape),
                                                      (j,) + (0,) * (a.ndim - 1)), tree)

        params = {k: stage(g["params"][k], k) for k in keys}
        index = [sh for k in keys for sh in spmd._leaves(params[k])]
        opt = []
        for sh in index:
            like = sh.local if isinstance(sh, ser.Shard) else sh
            entry = {}
            for name in ("exp_avg", "exp_avg_sq"):
                t = torch.empty_like(like)
                entry[name] = ser.Shard(t, sh.global_shape, sh.start) \
                    if isinstance(sh, ser.Shard) else t
            opt.append(entry)
        back = ser.restore_sharded(f"{out}/one", {"params": params, "opt": opt})
        want = {k: spmd._tree_map(lambda a: a[j:j + 1] if k == "blocks" else a, g["params"][k])
                for k in keys}
        for k in keys:
            assert all(torch.equal(a, b) for a, b in
                       zip(spmd._leaves(back["params"][k]), spmd._leaves(want[k])))
        for name in ("exp_avg", "exp_avg_sq"):
            whole = [(k, m) for k in keys for m in spmd._leaves(g[name][k])]
            assert len(whole) == len(back["opt"])
            for i, ((k, m), entry) in enumerate(zip(whole, back["opt"])):
                assert torch.equal(entry[name], m[j:j + 1] if k == "blocks" else m), (j, i, name)


def test_zero1_segments_refuse_another_mesh(world):
    """ZeRO-1's segments are pieces of a rank-local flat leaf: a restore
    into another dp raises, naming both meshes."""
    _, out = world
    files = ser._Pieces(f"{out}/z1")
    try:
        gshape, _, layout = files.index["['opt'][0]['exp_avg']"][0][1]
    finally:
        files.close()
    assert "'dp': 2" in layout
    other = layout.replace("'dp': 2", "'dp': 1")
    tree = {"opt": [{"exp_avg": ser.Shard(torch.empty(gshape[0]), tuple(gshape), (0,), True,
                                          other)}]}
    with pytest.raises(CheckpointError, match=r"'dp': 2.*'dp': 1"):
        ser.restore_sharded(f"{out}/z1", tree)


def test_corrupt_rank_file_of_the_only_snapshot_gives_none(tmp_path):
    """In one process (world of one rank): a sharded snapshot whose rank
    file has a flipped byte is skipped, and with no older one
    ``restore_latest`` answers None; the intact one restores bitwise."""
    from torchgpipe_tpu_torch.resilience.checkpoint import CheckpointManager

    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))
    tree = {"w": ser.Shard(w, (3, 4), (0, 0)), "n": np.arange(3)}
    mgr = CheckpointManager(str(tmp_path), keep_last_k=1)
    path = mgr.save(5, tree, sharded=True)
    tmpl = {"w": torch.empty(3, 4), "n": np.zeros(3, np.int64)}
    snap = mgr.restore_latest(tmpl)
    assert snap.step == 5 and torch.equal(snap.tree["w"], w)
    f = f"{path}/sharded/rank_00000.npz"
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    assert mgr.restore_latest(tmpl) is None
    with pytest.raises(CheckpointError, match="template"):
        mgr.restore_latest()
