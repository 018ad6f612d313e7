"""Named-save remat policies (ROADMAP A.2.12): ``checkpoint.policies``
through ``GPipe(fused=True, remat_policy=)`` and ``SpmdGPipe(remat_policy=)``.

Oracles.  Gradients under every preset are bitwise the port's own
policy-free gradients: a policy only hands the recompute values its
forward made, and the port's cells are deterministic, so nothing is
computed in another order.  Against the reference's engines with the
same preset on the same numpy weights, the tolerances of
tests/test_torch_gpipe.py (loss rtol 1e-5, each gradient leaf to 1e-4 of
its max) and of the SPMD parity files (loss rtol 1e-5, gradients rtol
1e-4 / atol 1e-5): the same float32 network summed in other orders.
Under tensor parallelism (pp=2 x tp=2) the oracle is the reference's
unsharded model under ``jax.value_and_grad``, at tests/
test_torch_tensor_parallel.py's tolerances.
The refusals are the reference's, word for word.  On the CPU the flash
autograd Functions run their plain forward (``_reference_fwd``);
counting its calls shows that ``save_flash_stats`` leaves the recompute
without a forward call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_parity as par
import torch_tp_parity as tpp
from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import checkpoint as jckpt
from torchgpipe_tpu import spmd as jspmd
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe, spmd
from torchgpipe_tpu_torch import checkpoint as tckpt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import flash_attention as tfa

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
BATCH, SEQ, BALANCE, CHUNKS = 4, 16, [2, 2], 2
LOSS_RTOL, GRAD_REL_TOL = 1e-5, 1e-4
PRESETS = ["save_attn_out", "save_block_outputs", "save_flash_stats", "dots_no_batch",
           "nothing_saveable", "offload_names"]


def _preset(policies, name):
    if name == "offload_names":
        return policies.offload_names("attn_out", "mlp_hidden")
    return getattr(policies, name)


def _jloss(out, tokens):
    return jt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


def _tloss(out, tokens):
    return tt.cross_entropy(out[:, :-1, :], tokens[:, 1:])


@pytest.fixture(scope="module")
def weights():
    pipe = JGPipe(jt.llama(JCFG), balance=[4])
    params, _ = pipe.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32))
    flat = [jax.tree_util.tree_map(np.asarray, p) for stage in params for p in stage]
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (BATCH, SEQ)).astype(np.int32)
    return flat, tokens


def _port(flat, tokens, policy=None, checkpoint="always"):
    """``(loss, grads, calls of the flash forward)`` of one fused step."""
    pipe = GPipe(params_from_jax(TCFG, flat, device="cpu"), BALANCE, devices=["cpu"],
                 chunks=CHUNKS, checkpoint=checkpoint, fused=True, remat_policy=policy)
    calls, orig = [0], tfa._reference_fwd

    def counted(*a):
        calls[0] += 1
        return orig(*a)

    t = torch.from_numpy(tokens)
    tfa._reference_fwd = counted
    try:
        loss, grads, _ = pipe.value_and_grad(t, t, _tloss)
    finally:
        tfa._reference_fwd = orig
    leaves = [(j, i, n, g) for j, st in enumerate(grads) for i, lay in enumerate(st)
              for n, g in sorted(lay.items())]
    return loss, leaves, calls[0], pipe


@pytest.fixture(scope="module")
def policy_free(weights):
    return {ck: _port(*weights, checkpoint=ck) for ck in ("always", "except_last")}


@pytest.mark.parametrize("checkpoint", ["always", "except_last"])
@pytest.mark.parametrize("name", PRESETS)
def test_presets_are_bitwise_the_policy_free_step_and_match_the_reference(
        weights, policy_free, name, checkpoint):
    flat, tokens = weights
    loss, leaves, _, pipe = _port(flat, tokens, _preset(tckpt.policies, name), checkpoint)
    free_loss, free, _, _ = policy_free[checkpoint]
    assert torch.equal(loss, free_loss)
    assert all(torch.equal(a[3], b[3]) for a, b in zip(leaves, free))
    if name != "nothing_saveable":
        assert pipe.remat_stats["saved_bytes"] > 0
    if checkpoint == "except_last":
        return   # the reference's values once a preset, below
    jpipe = JGPipe(jt.llama(JCFG), balance=BALANCE, chunks=CHUNKS, checkpoint=checkpoint,
                   devices=[jax.devices()[0]], fused=True,
                   remat_policy=_preset(jckpt.policies, name))
    params, i = [], 0
    for n in BALANCE:
        params.append([jax.tree_util.tree_map(jnp.asarray, p) for p in flat[i:i + n]])
        i += n
    _, state = jpipe.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32))
    x = jnp.asarray(tokens)
    jl, jg, _, _ = jpipe.value_and_grad(jpipe.place(tuple(params)), state, x, x, _jloss)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for j, li, n, g in leaves:
        want = np.asarray(jg[j][li][n])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_REL_TOL * np.abs(want).max(),
                                   err_msg=f"stage {j} layer {li} {n}")


def test_save_flash_stats_runs_no_forward_in_the_recompute(weights, policy_free):
    """Each block's flash forward runs once a cell under the policy (the
    recompute takes the kept O and LSE), twice without it."""
    flat, tokens = weights
    _, _, calls, pipe = _port(flat, tokens, tckpt.policies.save_flash_stats)
    blocks = KW["n_layers"]
    assert calls == blocks * CHUNKS and policy_free["always"][2] == 2 * blocks * CHUNKS
    # One (O, LSE) pair a block and micro-batch: O in float32 [b/m, s, h, d],
    # LSE float32 [b/m * h, s].
    o = BATCH // CHUNKS * SEQ * KW["n_heads"] * (KW["dim"] // KW["n_heads"]) * 4
    lse = BATCH // CHUNKS * KW["n_heads"] * SEQ * 4
    assert pipe.remat_stats["saved_bytes"] == blocks * CHUNKS * (o + lse)


def test_gpipe_refusals_are_the_references():
    """Not fused, ``checkpoint='never'`` and ``'offload'`` under fused name
    the reference's reasons; a policy that is no preset is refused."""
    layers = jt.llama(JCFG)[:2]
    for kw in ({"remat_policy": jckpt.policies.save_attn_out},
               {"remat_policy": jckpt.policies.save_attn_out, "fused": True,
                "checkpoint": "never"},
               {"fused": True, "checkpoint": "offload"}):
        with pytest.raises(ValueError) as je:
            JGPipe(layers, [1, 1], devices=[jax.devices()[0]], **kw)
        tkw = dict(kw)
        if "remat_policy" in tkw:
            tkw["remat_policy"] = tckpt.policies.save_attn_out
        with pytest.raises(ValueError) as te:
            GPipe([torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)], [1, 1], devices=["cpu"],
                  **tkw)
        assert str(te.value) == str(je.value)
        assert "offload_names" in str(te.value) or "remat_policy" in str(te.value)
    with pytest.raises(TypeError, match="checkpoint.policies preset"):
        GPipe([torch.nn.Linear(2, 2)], [1], devices=["cpu"], fused=True,
              remat_policy=lambda *a: True)


def test_spmd_refusals_are_the_references(cpu_devices):
    """``zb``, ``1f1b``/``interleaved`` and ``'never'`` refuse a policy
    with the reference's text."""
    import types

    mesh = types.SimpleNamespace(
        axis_names=("pp", "dp"), shape={"pp": 2, "dp": 1}, coords={"pp": 0, "dp": 0},
        device=torch.device("cpu"))
    jmesh = jspmd.make_mesh(2, devices=cpu_devices[:2])
    jblock, _, _ = jt.llama_spmd(jt.TransformerConfig(vocab=16, dim=16, n_layers=2,
                                                      n_heads=2), 2)
    tblock, _, _ = tt.llama_spmd(tt.TransformerConfig(vocab=16, dim=16, n_layers=2,
                                                      n_heads=2), 2, device="cpu")
    cases = [dict(schedule="zb"), dict(schedule="1f1b"), dict(schedule="interleaved",
                                                             virtual_stages=2),
             dict(checkpoint="never")]
    for kw in cases:
        with pytest.raises(ValueError) as je:
            jspmd.SpmdGPipe(jblock, 2, jmesh, chunks=2, loss_fn=jt.cross_entropy,
                            remat_policy=jckpt.policies.save_attn_out, **kw)
        with pytest.raises(ValueError) as te:
            spmd.SpmdGPipe(tblock, 2, mesh, chunks=2, loss_fn=tt.cross_entropy,
                           remat_policy=tckpt.policies.save_attn_out, **kw)
        assert str(te.value) == str(je.value), kw


SPMD = dict(model="llama", n_layers=2, pp=2, dp=2, chunks=2, batch=8)
SPMD_CASES = {
    "always": dict(SPMD),
    "always_flash": dict(SPMD, remat="save_flash_stats"),
    "always_block": dict(SPMD, remat="save_block_outputs"),
    "always_dots": dict(SPMD, remat="dots_no_batch"),
    "except_last": dict(SPMD, checkpoint="except_last"),
    "except_last_attn": dict(SPMD, checkpoint="except_last", remat="save_attn_out"),
    "offload_flash": dict(SPMD, checkpoint="offload", remat="save_flash_stats"),
}


@pytest.fixture(scope="module")
def spmd_results(cpu_devices, tmp_path_factory):
    """Every case in one pp=2 x dp=2 world of port ranks; the reference's
    step of each preset case (a reference engine with the same policy)."""
    out = str(tmp_path_factory.mktemp("remat_spmd"))
    inputs, want = {}, {}
    for name, spec in SPMD_CASES.items():
        pipe, params, x, tgt = par.reference(spec, cpu_devices)
        inputs[name] = par.port_inputs(spec, pipe, params, x, tgt)
        if spec.get("remat") and spec.get("checkpoint", "always") == "always":
            jpipe = jspmd.SpmdGPipe(pipe.block, 2, pipe.mesh, chunks=2,
                                    loss_fn=jt.cross_entropy, pre=pipe.pre, post=pipe.post,
                                    dp_axis="dp",
                                    remat_policy=getattr(jckpt.policies, spec["remat"]))
            loss, grads = jpipe.train_step(params, x, tgt)
            want[name] = {"loss": float(loss), "grads": jax.device_get(grads)}
    return par.run_port(inputs, 2, 2, out), want


@pytest.mark.parametrize("name", [n for n in SPMD_CASES if "remat" in SPMD_CASES[n]])
def test_spmd_presets_are_bitwise_the_policy_free_step(spmd_results, name):
    port, want = spmd_results
    free = "except_last" if SPMD_CASES[name].get("checkpoint") == "except_last" else "always"
    got, ref = port[name], port[free]
    assert torch.equal(got["loss"], ref["loss"])
    for (path, a), (_, b) in zip(par.items(got["grads"]), par.items(ref["grads"])):
        assert torch.equal(a, b), path
    if name in want:
        np.testing.assert_allclose(float(got["loss"]), want[name]["loss"], rtol=par.LOSS_RTOL)
        par.assert_trees_close(got["grads"], want[name]["grads"])


TP = dict(model="llama", n_layers=2, chunks=2, batch=4, checkpoint="always")
TP_WORLDS = {(2, 1, 1, 2): {"tp_always": dict(TP),
                            "tp_attn": dict(TP, remat="save_attn_out"),
                            "tp_block": dict(TP, remat="save_block_outputs")}}
TP_CASES = {name: dict(spec, pp=pp, dp=dp, sp=sp, tp=tp)
            for (pp, dp, sp, tp), cases in TP_WORLDS.items() for name, spec in cases.items()}


@pytest.fixture(scope="module")
def tp_results(cpu_devices, tmp_path_factory):
    """The pp=2 x tp=2 world's steps, and the unsharded oracle's."""
    return tpp.run_cases(TP_WORLDS, TP_CASES, cpu_devices,
                         str(tmp_path_factory.mktemp("remat_tp")))


@pytest.mark.parametrize("name", ["tp_attn", "tp_block"])
def test_tp_presets_are_bitwise_the_policy_free_step(tp_results, name):
    """Under tp the attention output is an all-reduce into a cloned
    buffer: a value written in place after the clone made it.  Kept as the
    clone's output, the recompute would reduce it a second time (tp times
    too large); the policy leaves it to the recompute, so the step is
    bitwise the policy-free one and matches the oracle, while the
    feed-forward hidden (no collective) is kept."""
    port, want = tp_results
    got, ref = port[name], port["tp_always"]
    assert torch.equal(got["loss"], ref["loss"])
    for (path, a), (_, b) in zip(par.items(got["grads"]), par.items(ref["grads"])):
        assert torch.equal(a, b), path
    np.testing.assert_allclose(float(got["loss"]), want[name]["loss"], rtol=tpp.LOSS_RTOL)
    par.assert_trees_close(got["grads"], want[name]["grads"])
    if name == "tp_block":
        assert int(got["remat_bytes"]) > 0
