"""Ring attention and the sequence-parallel engine in torchgpipe_tpu_torch
against the reference (the mirror of tests/test_ring_attention.py).

``ring_attention`` runs in rank processes over gloo (tests/torch_spmd_rank.py)
on a ring of four, each rank holding its sequence shard, against the
reference's under ``shard_map`` on the same shards: the outputs to 2e-5
and the q/k/v gradients to 5e-5 (tests/torch_tp_parity.py).  The cases
cover causal and not, GQA pairing, more shards than heads, and
``kv_block_size`` sub-steps (an even split and one where the block size
does not divide the shard).  The engine at pp=2 x sp=2 is held against
the reference's sequential oracle (loss to rtol 1e-5, gradients to rtol
2e-4 / atol 2e-5), and so is its inference.
"""

import types

import numpy as np
import pytest
import torch

import torch_spmd_parity as par
import torch_tp_parity as tpp
from torchgpipe_tpu_torch import parallel, spmd
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.parallel.ring_attention import ring_tiles

RING = dict(op="ring", causal=True, shape=(2, 32, 4, 4, 8))
LLAMA = dict(model="llama", n_layers=2, chunks=2, batch=4, checkpoint="except_last")
# The GPT-2 class: learned positions (each sp lane reads its global rows),
# LayerNorms and biases, every vector leaf perturbed.
CLASSIC = dict(n_kv_heads=4, norm="layernorm", pos_emb="learned", max_pos=16,
               mlp_impl="classic", act="gelu_tanh", attn_bias=True, attn_out_bias=True)
WORLDS = {
    (1, 1, 4, 1): {
        "ring_causal": dict(RING),
        "ring_full": dict(RING, causal=False, seed=1),
        "ring_gqa": dict(RING, shape=(2, 32, 4, 2, 8), seed=2),
        "ring_uneven_heads": dict(RING, shape=(1, 64, 2, 2, 4), seed=3),
        "ring_substeps": dict(RING, kv_block_size=4, seed=4),
        "ring_substeps_ragged": dict(RING, kv_block_size=3, seed=5),
        "ring_substeps_full": dict(RING, causal=False, kv_block_size=3, seed=6),
    },
    (2, 1, 2, 1): {
        "sp_ring": dict(LLAMA),
        "sp_classic": dict(LLAMA, cfg=CLASSIC, perturb=True),
        "sp_ring_apply": dict(LLAMA, apply=True),
    },
}
CASES = {name: dict(spec, pp=pp, dp=dp, sp=sp, tp=tp)
         for (pp, dp, sp, tp), cases in WORLDS.items() for name, spec in cases.items()}
OPS = [n for n, s in CASES.items() if s.get("op")]


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return tpp.run_cases(WORLDS, CASES, cpu_devices, str(tmp_path_factory.mktemp("ring")))


@pytest.mark.parametrize("name", OPS)
def test_ring_attention_matches_reference(results, name):
    port, want = results
    np.testing.assert_allclose(port[name]["out"].numpy(), want[name]["out"],
                               rtol=tpp.OUT_TOL, atol=tpp.OUT_TOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port[name][g].numpy(), want[name][g],
                                   rtol=tpp.GRAD_TOL, atol=tpp.GRAD_TOL, err_msg=g)


@pytest.mark.parametrize("name", ["sp_ring", "sp_classic"])
def test_engine_with_sequence_parallelism_matches_the_oracle(results, name):
    """pp=2 x sp=2: each sp lane holds half of every sequence (rotary,
    learned positions and the ring at global positions); loss and
    gradients (reduced over sp as the reference's pmean) equal the
    unsharded oracle's."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=tpp.LOSS_RTOL)
    par.assert_trees_close(port[name]["grads"], want[name]["grads"],
                           rtol=tpp.SP_GRAD_RTOL, atol=tpp.SP_GRAD_ATOL)


def test_sp_inference_matches_the_oracle(results):
    """``apply`` reassembles the sequence from the sp lanes; ``eval_loss``
    averages the lanes' losses."""
    port, want = results
    got = port["sp_ring_apply"]
    np.testing.assert_allclose(got["out"].numpy(), want["sp_ring_apply"]["out"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), want["sp_ring_apply"]["loss"],
                               rtol=tpp.LOSS_RTOL)


def test_global_batch_from_local_under_sp(results):
    """Each sp lane's own positions assembled along dim 1 in lane order
    (``P(None, "sp")``), on every rank (rank 0's copy here); an SPMD
    pipe's batches belong on its rank's device, whole."""
    port, _ = results
    got = port["global_batch_sp_2x1x2x1"]["global"]
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(got, torch.cat([base, base + 10], 1))
    from torchgpipe_tpu_torch.utils.data import pipe_data_sharding

    pipe = _engine(_cfg(sp_axis="sp"), fake_mesh(pp=2, dp=1, sp=2), sp_axis="sp")
    assert pipe_data_sharding(pipe) == torch.device("cpu")


def test_ring_tiles_cover_the_causal_square_once():
    """Every (query, key) pair a causal (or full) ring attends lies in
    exactly one tile; a later rank's block has none; a causal tile is
    square on the diagonal."""
    for sp, s, n_sub in [(4, 8, 1), (4, 8, 2), (2, 12, 3), (3, 6, 6)]:
        for causal in (True, False):
            for rank in range(sp):
                seen = np.zeros((s, sp * s), int)
                for t in range(sp):
                    src = (rank - t) % sp
                    for q0, q1, k0, k1, c in ring_tiles(rank, src, s, n_sub, causal):
                        if c:
                            assert (q0, q1) == (k0, k1) and src == rank
                        for i in range(q0, q1):
                            for j in range(k0, k1):
                                if not c or j <= i:
                                    seen[i, src * s + j] += 1
                qpos = rank * s + np.arange(s)[:, None]
                want = (np.arange(sp * s)[None] <= qpos) if causal else np.ones_like(seen)
                np.testing.assert_array_equal(seen, want.astype(int))


def fake_mesh(**shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                                 coords={a: 0 for a in shape}, device=torch.device("cpu"))


def _cfg(**kw):
    base = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, dtype=torch.float32)
    return tt.TransformerConfig(**dict(base, **kw))


def _engine(cfg, mesh, **kw):
    block, pre, post = tt.llama_spmd(cfg, 2, device="cpu")
    kw = dict(dict(chunks=2, loss_fn=tt.cross_entropy, pre=pre, post=post), **kw)
    return spmd.SpmdGPipe(block, 2, mesh, **kw)


def _ref_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_engine_rejections_carry_the_references_messages(cpu_devices):
    """An sp axis the model does not declare, a loss that does not
    decompose, 1F1B with sp, a window on the ring, and a batch whose
    sequence or target does not divide by sp: the reference's errors."""
    import jax
    import jax.numpy as jnp

    from torchgpipe_tpu.models import transformer as jt
    from torchgpipe_tpu.spmd import SpmdGPipe as JSpmd, make_mesh as jmesh

    jkw = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)

    def jengine(cfg, **kw):
        jb, jpre, jpost = jt.llama_spmd(cfg, 2)
        return JSpmd(jb, 2, jmesh(2, dp=1, sp=2, devices=cpu_devices[:4]), chunks=2,
                     loss_fn=jt.cross_entropy, pre=jpre, post=jpost, **kw)

    mesh = fake_mesh(pp=2, dp=1, sp=2)
    cases = [
        (dict(), dict(sp_axis="sp"), "declare sp_axis"),
        (dict(sp_axis="sp"), dict(sp_axis="sp", loss_reduction=None), "decomposable"),
        (dict(sp_axis="sp"), dict(sp_axis="sp", schedule="1f1b"), "does not compose"),
        (dict(sp_axis="sp", attn_window=4), dict(sp_axis="sp"), "attn_window"),
    ]
    for cfg_kw, kw, match in cases:
        want = _ref_error(lambda: jengine(jt.TransformerConfig(**jkw, **cfg_kw),
                                                        **kw))
        with pytest.raises(ValueError, match=match) as e:
            _engine(_cfg(**cfg_kw), mesh, **kw)
        assert str(e.value) == want
    jpipe = jengine(jt.TransformerConfig(**jkw, sp_axis="sp"), sp_axis="sp")
    jparams = jpipe.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((4, 16), jnp.int32))
    pipe = _engine(_cfg(sp_axis="sp"), mesh, sp_axis="sp")
    params = pipe.place(pipe.init(torch.Generator().manual_seed(0),
                                  torch.zeros(4, 16, dtype=torch.long)))
    for x, y in [((4, 16), (4, 15)), ((4, 15), (4, 15))]:
        want = _ref_error(lambda: jpipe.train_step(
            jparams, jnp.zeros(x, jnp.int32), jnp.zeros(y, jnp.int32)))
        with pytest.raises(ValueError, match="sequence parallelism shards data dim 1") as e:
            pipe.train_step(params, torch.zeros(x, dtype=torch.long),
                            torch.zeros(y, dtype=torch.long))
        assert str(e.value) == want


def test_dispatcher_rejections(cpu_devices):
    """``attention``: an impl other than ring/ulysses, segment packing
    under a bound sp axis, and a window on the ring, as the reference's
    dispatcher refuses them; unbound, it is the port's attention."""
    from torchgpipe_tpu.parallel import attention as jattention

    q = torch.randn(1, 8, 2, 4)
    with pytest.raises(ValueError, match="must be 'ring' or 'ulysses'") as e:
        parallel.attention(q, q, q, impl="star")
    import jax.numpy as jnp

    with pytest.raises(ValueError) as je:
        jattention(jnp.zeros((1, 8, 2, 4)), jnp.zeros((1, 8, 2, 4)),
                   jnp.zeros((1, 8, 2, 4)), impl="star")
    assert str(e.value) == str(je.value)
    mesh = fake_mesh(sp=2)
    with parallel.bind_axes(mesh, ["sp"]):
        with pytest.raises(ValueError, match="segment-packed attention"):
            parallel.attention(q, q, q, axis_name="sp", seg=torch.ones(1, 8, dtype=torch.long))
        with pytest.raises(ValueError, match="sliding-window attention does not compose"):
            parallel.attention(q, q, q, axis_name="sp", window=2)
    got = parallel.attention(q, q, q, axis_name="sp")      # unbound: the port's attention
    torch.testing.assert_close(got, parallel.full_attention(q, q, q), rtol=1e-5, atol=1e-6)
