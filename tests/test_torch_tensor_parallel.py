"""Tensor parallelism in torchgpipe_tpu_torch against the reference (the
mirror of tests/test_tensor_parallel.py).

The port's ranks are OS processes over gloo (tests/torch_spmd_rank.py),
one world per mesh shape running every case of that shape; the reference
runs here on the 8 virtual CPU devices (tests/torch_tp_parity.py).  The
engine is held against the reference's sequential oracle (the unsharded
model under ``jax.value_and_grad``) at float32: the loss to rtol 1e-5,
gradients to rtol 1e-4 / atol 1e-5 (tests/torch_spmd_parity.py's), and
with sp to the reference's own rtol 2e-4 / atol 2e-5
(tests/torch_tp_parity.py derives both).  The primitives are held against
the reference's under ``shard_map``; their values are sums and maxima of
a few float32 terms, to 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_parity as par
import torch_tp_parity as tpp
from torchgpipe_tpu_torch import convert, spmd
from torchgpipe_tpu_torch.models import transformer as tt

LLAMA = dict(model="llama", n_layers=2, chunks=2, batch=4, checkpoint="except_last")
CLASSIC = dict(n_kv_heads=4, norm="layernorm", pos_emb="learned", max_pos=16,
               mlp_impl="classic", act="gelu_tanh", attn_bias=True, attn_out_bias=True)
WORLDS = {
    (2, 1, 1, 2): {
        "tp": dict(LLAMA),
        "tp_sharded_logits": dict(LLAMA, gather_logits=False),
        "tp_1f1b": dict(LLAMA, schedule="1f1b"),
        "tp_classic": dict(LLAMA, cfg=CLASSIC, perturb=True),
        "tp_apply": dict(LLAMA, gather_logits=False, apply=True),
        "tp_place": dict(LLAMA, place=True),
        "tp_ops": dict(op="tensor"),
    },
    (2, 2, 1, 2): {"tp_dp": dict(LLAMA, batch=8, checkpoint="never"),
                   "tp_dp_fsdp": dict(LLAMA, batch=8, checkpoint="never", fsdp=True)},
    (2, 1, 2, 2): {"tp_sp": dict(LLAMA, checkpoint="always")},
}
CASES = {name: dict(spec, pp=pp, dp=dp, sp=sp, tp=tp)
         for (pp, dp, sp, tp), cases in WORLDS.items() for name, spec in cases.items()}
TRAIN = [n for n, s in CASES.items()
         if not (s.get("op") or s.get("apply") or s.get("place"))]
PRIMITIVES = ["psum_grad", "psum_value", "psum_value_grad", "pmax_stop", "pmax_stop_grad",
              "all_gather_value", "all_gather_value_grad", "vpce", "vpce_grad"]


@pytest.fixture(scope="module")
def results(cpu_devices, tmp_path_factory):
    return tpp.run_cases(WORLDS, CASES, cpu_devices, str(tmp_path_factory.mktemp("tp")))


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_matches_the_sequential_oracle(results, name):
    """Loss and every gradient leaf of the tp-sharded engine (the sharded
    leaves gathered) equal the unsharded oracle's: vocab-parallel
    embedding and head, column/row-parallel blocks, Megatron's
    cross-entropy over sharded logits, 1F1B, the classic (GPT-2 class)
    block with its biases, and tp with dp (with fsdp too: the dims tp
    leaves free sharded over dp) and with sp (the ring)."""
    port, want = results
    np.testing.assert_allclose(float(port[name]["loss"]), want[name]["loss"],
                               rtol=tpp.LOSS_RTOL)
    rtol, atol = ((tpp.SP_GRAD_RTOL, tpp.SP_GRAD_ATOL) if CASES[name]["sp"] > 1
                  else (par.GRAD_RTOL, par.GRAD_ATOL))
    par.assert_trees_close(port[name]["grads"], want[name]["grads"], rtol=rtol, atol=atol)


def test_sharded_head_inference_gathers_full_logits(results):
    """``apply`` of a ``gather_logits=False`` model returns full
    ``[B, S, vocab]`` logits (the engine gathers the head's declared
    output sharding), and ``eval_loss`` runs Megatron's cross-entropy
    inside the step; both equal the oracle's."""
    port, want = results
    got = port["tp_apply"]
    assert tuple(got["out"].shape) == want["tp_apply"]["out"].shape == (4, 8, 64)
    np.testing.assert_allclose(got["out"].numpy(), want["tp_apply"]["out"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), want["tp_apply"]["loss"],
                               rtol=tpp.LOSS_RTOL)


def test_placement_matches_the_references_shards(results, cpu_devices):
    """Each rank's placed leaves are the reference's physical shards at
    its mesh position (column-parallel weights over tp on their output
    dim, row-parallel on their input dim, the vocab over tp, norms
    replicated); ``gather`` of the placement is bitwise the tree that
    ``convert.params_from_jax`` makes of the reference's."""
    from torchgpipe_tpu.models.transformer import (
        TransformerConfig as JCfg, cross_entropy as jce, llama_spmd as jllama)
    from torchgpipe_tpu.spmd import SpmdGPipe as JSpmd, make_mesh as jmesh

    port, want = results
    jcfg = JCfg(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, tp_axis="tp")
    jb, jpre, jpost = jllama(jcfg, 2)
    jmesh_ = jmesh(2, dp=1, tp=2, devices=cpu_devices[:4])
    jpipe = JSpmd(jb, 2, jmesh_, chunks=2, loss_fn=jce, pre=jpre, post=jpost, tp_axis="tp")
    jparams = jpipe.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((4, 8), jnp.int32))
    ranks = port["tp_place"]["ranks"]
    devices = jmesh_.devices.reshape(2, 2)            # [pp, tp] (dp of size 1)
    checked = 0
    for path, leaf in par.items(jparams):
        index = leaf.sharding.devices_indices_map(leaf.shape)
        for j in range(2):
            for t in range(2):
                local = dict(par.items(ranks[j * 2 + t]))[path]
                np.testing.assert_array_equal(
                    local.numpy(), np.asarray(leaf)[index[devices[j, t]]], err_msg=str(path))
                checked += 1
    assert checked == 4 * len(par.items(jparams))
    blocks = ranks[1]["blocks"][0]
    assert tuple(blocks["wq"].shape) == (1, 32, 16) and tuple(blocks["wo"].shape) == (1, 16, 32)
    assert tuple(ranks[1]["pre"]["table"].shape) == (32, 32)
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               tp_axis="tp", dtype=torch.float32)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(want["tp_place"]["params"]))
    converted = convert.params_from_jax(cfg, host, device="cpu")
    par.assert_trees_close(port["tp_place"]["params"], converted, rtol=0, atol=0)


def test_generation_from_a_tp_trained_tree(results):
    """``spmd_params_for_generation`` of the tree ``gather`` reassembles
    from a tp pipe gives the model ``generate`` takes: greedy tokens equal
    those of the same weights through an engine without tp."""
    from torchgpipe_tpu_torch.models import generation as tg

    port, _ = results
    tree = port["tp_place"]["params"]
    prompt = torch.arange(10).reshape(2, 5) % 64
    outs = []
    for tp in ("tp", None):
        cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                   tp_axis=tp, dtype=torch.float32)
        mesh = fake_mesh(pp=2, dp=1, tp=2) if tp else fake_mesh(pp=2, dp=1)
        pipe = _engine(cfg, mesh, tp_axis=tp)
        model = tg.spmd_params_for_generation(pipe, tree, device="cpu")
        outs.append(tg.generate(model[0].cfg, model, prompt, 4, device="cpu"))
    assert outs[0].shape == (2, 4) and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("what", PRIMITIVES)
def test_primitives_match_reference(results, what):
    """``psum_grad`` (identity, its cotangent summed), ``psum_value``
    (summed, its cotangent passed through), ``pmax_stop`` (zero
    gradient), ``all_gather_value`` (its cotangent sliced) and
    ``vocab_parallel_cross_entropy`` over two tp lanes: each lane's value
    and input gradient equal the reference's under ``shard_map``."""
    port, want = results
    np.testing.assert_allclose(port["tp_ops"][what].numpy(), want["tp_ops"][what],
                               rtol=1e-6, atol=1e-6)


def test_vocab_parallel_ce_is_stable_under_a_large_shift(results):
    """The lanes' log-sum-exp shifted by their maximum stays finite at
    logits + 5e4 and equals the unshifted loss to the input's float32
    quantization (~3e-3 an entry at 5e4, the reference's own bound)."""
    port, want = results
    got = port["tp_ops"]
    assert torch.isfinite(got["vpce_shift"]).all()
    np.testing.assert_allclose(got["vpce_shift"].numpy(), want["tp_ops"]["vpce_shift"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["vpce_shift"].numpy(), got["vpce"].numpy(), rtol=1e-3)


def test_vocab_parallel_ce_outside_a_bound_axis_is_plain_ce():
    from torchgpipe_tpu.models.transformer import (
        cross_entropy as jce, vocab_parallel_cross_entropy as jvpce)

    logits = np.random.default_rng(0).standard_normal((2, 4, 16), dtype=np.float32)
    labels = np.random.default_rng(1).integers(0, 16, (2, 4))
    want = float(jvpce("tp")(jnp.asarray(logits), jnp.asarray(labels)))
    assert want == pytest.approx(float(jce(jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)
    got = tt.vocab_parallel_cross_entropy("tp")(torch.from_numpy(logits),
                                                torch.from_numpy(labels))
    assert float(got) == pytest.approx(want, rel=1e-6)


def fake_mesh(**shape):
    """What the engine's checks read of a mesh, without a process group."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                                 coords={a: 0 for a in shape}, device=torch.device("cpu"))


def _engine(cfg, mesh, **kw):
    block, pre, post = tt.llama_spmd(cfg, 2, device="cpu")
    return spmd.SpmdGPipe(block, 2, mesh, chunks=2, loss_fn=tt.cross_entropy, pre=pre,
                          post=post, **kw)


def test_rejections_carry_the_references_messages(cpu_devices):
    """A tp axis the model does not declare, a kv head count the tp size
    does not divide, and a tied chunked loss under tp: the reference's
    errors, word for word."""
    from torchgpipe_tpu.models import transformer as jt
    from torchgpipe_tpu.spmd import SpmdGPipe as JSpmd, make_mesh as jmesh

    def ref_error(cfg, tp):
        jb, jpre, jpost = jt.llama_spmd(cfg, 2)
        with pytest.raises(ValueError) as e:
            JSpmd(jb, 2, jmesh(2, dp=1, tp=tp, devices=cpu_devices[:2 * tp]), chunks=2,
                  loss_fn=jt.cross_entropy, pre=jpre, post=jpost, tp_axis="tp")
        return str(e.value)

    kw = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
    want = ref_error(jt.TransformerConfig(**kw), 2)
    with pytest.raises(ValueError, match="declare tp_axis") as e:
        _engine(tt.TransformerConfig(**kw, dtype=torch.float32), fake_mesh(pp=2, dp=1, tp=2),
                tp_axis="tp")
    assert str(e.value) == want
    want = ref_error(jt.TransformerConfig(**kw, tp_axis="tp"), 4)
    with pytest.raises(ValueError, match="kv_heads.*not divisible") as e:
        _engine(tt.TransformerConfig(**kw, tp_axis="tp", dtype=torch.float32),
                fake_mesh(pp=2, dp=1, tp=4), tp_axis="tp")
    assert str(e.value) == want
    tied = dict(kw, tie_embeddings=True, tp_axis="tp")
    with pytest.raises(ValueError) as je:
        jt.chunked_lm_loss(jt.TransformerConfig(**tied))
    with pytest.raises(ValueError) as te:
        tt.chunked_lm_loss(tt.TransformerConfig(**tied, dtype=torch.float32), device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="vocab=63 is not divisible"):
        _engine(tt.TransformerConfig(**dict(kw, vocab=63), tp_axis="tp",
                                     dtype=torch.float32),
                fake_mesh(pp=2, dp=1, tp=2), tp_axis="tp")


def test_specs_and_mesh_layout():
    """The block's, embedding's and head's ``param_specs`` are the
    reference's; ``make_mesh`` lays tp innermost (rank ``((pp * dp + d) *
    sp + s) * tp + t``) and needs a process group of that size."""
    cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               tp_axis="tp", dtype=torch.float32)
    block, pre, post = tt.llama_spmd(cfg, 2, device="cpu", gather_logits=False)
    P = spmd.P
    assert spmd.layer_param_specs(block, "pp")[0] == {
        "ln1": P("pp"), "wq": P("pp", None, "tp"), "wk": P("pp", None, "tp"),
        "wv": P("pp", None, "tp"), "wo": P("pp", "tp", None), "ln2": P("pp"),
        "w_gate": P("pp", None, "tp"), "w_up": P("pp", None, "tp"),
        "w_down": P("pp", "tp", None)}
    assert spmd.layer_param_specs(pre) == {"table": P("tp")}
    assert spmd.layer_param_specs(post) == {"scale": P(), "w": P(None, "tp")}
    assert post.meta["out_gather"] == ("tp", -1)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match=r"n_stages \* dp \* sp \* tp = 8"):
            spmd.make_mesh(2, 1, 2, tp=2)
