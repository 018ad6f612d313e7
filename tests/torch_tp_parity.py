"""Shared by the tensor- and sequence-parallel parity tests
(tests/test_torch_tensor_parallel.py, test_torch_ring_attention.py,
test_torch_ulysses.py): the reference's numbers of each case and the
port's ranks (tests/torch_spmd_rank.py) started beside them.

Engine cases hold the port's ``SpmdGPipe`` under tp and sp against the
reference's sequential oracle (its tests/test_tensor_parallel.py:46-62
pattern: the unsharded ``llama_spmd`` stages one after another under
``jax.value_and_grad``); the reference's own engine-level tp and sp tests
are marked slow.  ``op`` cases hold ``ring_attention``,
``ulysses_attention`` and the tensor-parallel primitives against the
reference's under ``shard_map`` on the same shards.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import torch_spmd_parity as par
from torchgpipe_tpu.models.transformer import (
    TransformerConfig,
    cross_entropy,
    llama_spmd,
    vocab_parallel_cross_entropy,
)
from torchgpipe_tpu.parallel import ring_attention, ulysses_attention
from torchgpipe_tpu.parallel.tensor import (
    all_gather_value,
    pmax_stop,
    psum_grad,
    psum_value,
)
from torchgpipe_tpu.spmd import SpmdGPipe, make_mesh
from torchgpipe_tpu.spmd import shard_map_compat as shard_map

# Loss to rtol 1e-5 everywhere; gradients as tests/torch_spmd_parity.py
# (rtol 1e-4 / atol 1e-5), and under sp the reference's own looser
# tolerance for its sp-with-tp test (tests/test_tensor_parallel.py:247,
# rtol 2e-4 / atol 2e-5): the ring merges the per-block softmaxes by LSE
# (the reference: an online recurrence) and Ulysses moves the whole
# attention to other lanes, so the float32 sums run in other orders over
# two more reductions.  Attention primitives against the reference's on
# the same shards: outputs to 2e-5 and gradients to 5e-5 (rtol and atol),
# the reference's ring against its dense oracle (tests/test_ring_attention.py).
LOSS_RTOL = 1e-5
SP_GRAD_RTOL, SP_GRAD_ATOL = 2e-4, 2e-5
OUT_TOL, GRAD_TOL = 2e-5, 5e-5


def ref_cfg(spec):
    """The case's reference config with no parallel axes (tp and sp
    change no init math and no result)."""
    kw = dict(vocab=64, dim=32, n_layers=spec.get("n_layers", 2), n_heads=4,
              n_kv_heads=2)
    kw.update(spec.get("cfg", {}))
    kw.pop("dtype", None)
    return TransformerConfig(**kw)


def _seq_forward(cfg, pp, p, tokens):
    block, pre, post = llama_spmd(cfg, pp)
    h, _ = pre.apply(p["pre"], (), tokens, rng=None, train=True)
    for j in range(pp):
        pj = jax.tree_util.tree_map(lambda a: a[j], p["blocks"])
        h, _ = block.apply(pj, (), h, rng=None, train=True)
    return post.apply(p["post"], (), h, rng=None, train=True)[0]


def engine_case(spec, devices):
    """``(port inputs, reference numbers)`` of an engine case: the
    reference's initial params (``SpmdGPipe.init`` on a pp-only mesh,
    biases perturbed for ``perturb``), the batch of seed 7, and the
    sequential oracle's loss and gradients (``apply``: its logits and
    loss; ``place``: the params)."""
    pp, B, S = spec["pp"], spec["batch"], spec.get("seq", 8)
    cfg = ref_cfg(spec)
    block, pre, post = llama_spmd(cfg, pp)
    pipe = SpmdGPipe(block, pp, make_mesh(pp, 1, devices=devices[:pp]), chunks=2,
                     loss_fn=cross_entropy, pre=pre, post=post)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    tokens = jax.random.randint(k1, (B, S), 0, cfg.vocab)
    labels = jax.random.randint(k2, (B, S), 0, cfg.vocab)
    params = pipe.init(jax.random.PRNGKey(spec.get("seed", 0)),
                       jax.ShapeDtypeStruct(tokens.shape, tokens.dtype))
    if spec.get("perturb"):
        def bump(path, a):
            # Every vector leaf (a bias or norm scale, stacked per stage in
            # the blocks), so a dropped or missharded one shows.
            vec = a.ndim == 1 or (a.ndim == 2 and "blocks" in str(path[0]))
            return a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) \
                if vec else a

        params = jax.tree_util.tree_map_with_path(bump, params)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    inputs = {"spec": spec, "params": par.to_torch(host),
              "x": torch.from_numpy(np.array(tokens)),
              "tgt": torch.from_numpy(np.array(labels))}
    if spec.get("place"):
        return inputs, {"params": host}

    def loss_of(p):
        return cross_entropy(_seq_forward(cfg, pp, p, tokens), labels)

    if spec.get("apply"):
        logits = jax.jit(lambda p: _seq_forward(cfg, pp, p, tokens))(params)
        return inputs, {"out": np.asarray(logits), "loss": float(jax.jit(loss_of)(params))}
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return inputs, {"loss": float(loss), "grads": jax.device_get(grads)}


def attn_inputs(spec):
    """q, k, v and the output cotangent ``do`` of an attention op case
    (numpy, seed ``spec["seed"]``): ``[b, s, h, d]`` and ``[b, s, g, d]``."""
    b, s, h, g, d = spec["shape"]
    rng = np.random.default_rng(spec.get("seed", 0))
    q, do = (rng.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, g, d), dtype=np.float32) for _ in range(2))
    return {"q": q, "k": k, "v": v, "do": do}


def attn_reference(spec, devices):
    """The reference's ring or Ulysses attention under ``shard_map`` over
    ``spec["sp"]`` devices: the output and the q/k/v cotangents of
    ``sum(out * do)``."""
    a = attn_inputs(spec)
    mesh = Mesh(np.array(devices[:spec["sp"]]), ("sp",))
    if spec["op"] == "ring":
        fn = lambda q, k, v: ring_attention(  # noqa: E731
            q, k, v, "sp", causal=spec["causal"],
            kv_block_size=spec.get("kv_block_size", 2048))
    else:
        fn = lambda q, k, v: ulysses_attention(  # noqa: E731
            q, k, v, "sp", causal=spec["causal"], window=spec.get("window"))
    mapped = shard_map(fn, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                       out_specs=P(None, "sp"))

    def run(q, k, v, do):
        out, vjp = jax.vjp(mapped, q, k, v)
        return (out, *vjp(do))

    got = jax.jit(run)(*(jnp.asarray(a[n]) for n in ("q", "k", "v", "do")))
    return dict(zip(("out", "dq", "dk", "dv"), (np.asarray(t) for t in got)))


def tensor_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((3, 4), dtype=np.float32),
            "logits": 3.0 * rng.standard_normal((2, 4, 16), dtype=np.float32),
            "labels": rng.integers(0, 16, (2, 4))}


def tensor_reference(tp, devices):
    """The reference's four primitives under ``shard_map`` over ``tp``
    devices, as the port's rank script drives them: each lane's value
    and input cotangent, stacked by lane."""
    x = jnp.asarray(tensor_inputs()["x"])
    mesh = Mesh(np.array(devices[:tp]), ("tp",))

    def local(x):
        lane = lax.axis_index("tp").astype(x.dtype) + 1.0
        out = {}
        out["psum_grad"] = jax.grad(lambda x: jnp.sum(psum_grad(x, "tp") * lane))(x)
        y, vjp = jax.vjp(lambda x: psum_value(x * lane, "tp"), x)
        out["psum_value"], (out["psum_value_grad"],) = y, vjp(x)
        y, vjp = jax.vjp(lambda x: pmax_stop(x * lane, "tp"), x)
        out["pmax_stop"], (out["pmax_stop_grad"],) = y, vjp(x)
        y, vjp = jax.vjp(lambda x: all_gather_value(x * lane, "tp", -1), x)
        cot = jnp.arange(y.size, dtype=y.dtype).reshape(y.shape)
        out["all_gather_value"], (out["all_gather_value_grad"],) = y, vjp(cot)
        return {k: v[None] for k, v in out.items()}

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=P(), out_specs=P("tp")))
    out = {k: np.asarray(v) for k, v in fn(x).items()}
    inp = tensor_inputs()
    ce = vocab_parallel_cross_entropy("tp")
    for key, shift in (("vpce", 0.0), ("vpce_shift", 5e4)):
        def lane(lg, lb):
            loss, g = jax.value_and_grad(ce)(lg, lb)
            return loss[None], g[None]

        loss, grad = jax.jit(shard_map(
            lane, mesh=mesh, in_specs=(P(None, None, "tp"), P()),
            out_specs=(P("tp"), P("tp"))))(jnp.asarray(inp["logits"]) + shift,
                                            jnp.asarray(inp["labels"]))
        v = inp["logits"].shape[-1] // tp
        out[key] = np.asarray(loss).reshape(tp, 1)
        out[key + "_grad"] = np.asarray(grad).reshape(tp, *inp["logits"].shape[:-1], v)
    return out


def to_inputs(spec, arrays):
    return {"spec": spec, **{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}}


def run_cases(worlds, cases, devices, out):
    """Every case: the port's worlds started on their inputs in a thread
    while the reference computes its numbers here.  Returns ``(port
    results, reference numbers)`` by case name."""
    inputs, want, later = {}, {}, []
    for shape, names in worlds.items():
        inputs[shape] = {}
        for name in names:
            spec = cases[name]
            if spec.get("op") == "tensor":
                inputs[shape][name] = to_inputs(spec, tensor_inputs())
                later.append((name, lambda s=spec: tensor_reference(s["tp"], devices)))
            elif spec.get("op"):
                inputs[shape][name] = to_inputs(spec, attn_inputs(spec))
                later.append((name, lambda s=spec: attn_reference(s, devices)))
            else:
                inputs[shape][name], want[name] = engine_case(spec, devices)
    port, error = {}, []

    def ranks():
        try:
            port.update(par.run_port_worlds(inputs, out))
        except BaseException as e:   # re-raised below, in the test's thread
            error.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        for name, fn in later:
            want[name] = fn()
    finally:
        thread.join()
    if error:
        raise error[0]
    return port, want

