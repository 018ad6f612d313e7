"""Shared by the SPMD parity tests (tests/test_torch_spmd.py,
tests/test_torch_spmd_1f1b.py): the reference engine of a case, its
numbers, and the port's ranks run as OS processes over gloo
(tests/torch_spmd_rank.py).

A case is a dict: ``model`` (``mlp``, ``llama`` or ``skips``; see
``torch_spmd_rank.build``), ``pp``, ``dp``, ``chunks``, ``batch``,
``checkpoint``, ``schedule``, ``loss_reduction``, and flags (``pre_post``,
``tied``, ``apply``).  The reference runs in this process on the 8
virtual CPU devices; the port's ranks get the reference's initial params
(numpy -> torch, the same tree layout) and the same batch.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.subproc_env import REPO, cpu_subproc_env
from torchgpipe_tpu.layers import chain
from torchgpipe_tpu.models.transformer import (
    TransformerConfig,
    cross_entropy,
    llama_spmd,
)
from torchgpipe_tpu.ops import dense, gelu, layer_norm
from torchgpipe_tpu.skip import Namespace, pop_cat, stash
from torchgpipe_tpu.spmd import SpmdGPipe, make_mesh

SCRIPT = os.path.join(REPO, "tests", "torch_spmd_rank.py")
DIM, SKIP_DIM = 8, 16
# Loss and gradients at float32 as the reference's own SPMD tests hold its
# engine against its oracle (tests/test_spmd.py): the loss to rtol 1e-5,
# every gradient leaf to rtol 1e-4 / atol 1e-5.  The two engines compute
# the same float32 sums in other orders (a cell's products, the dp and pp
# reductions), a few float32 ulps apart.
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def mse(out, tgt):
    return jnp.mean((out - tgt) ** 2)


def mse_sum(out, tgt):
    return jnp.sum((out - tgt) ** 2)


def u_stage():
    ns = Namespace()
    return chain([
        layer_norm(name="ln"), dense(SKIP_DIM, name="enc"), stash("feat", ns=ns),
        dense(SKIP_DIM // 4, name="down"), gelu("mid"), dense(SKIP_DIM, name="up"),
        pop_cat("feat", ns=ns), dense(SKIP_DIM, name="proj")], name="u_stage")


def reference(spec, devices):
    """``(pipe, params, x, tgt)`` of the reference engine for a case."""
    n, dp, m, B = spec["pp"], spec["dp"], spec["chunks"], spec["batch"]
    mesh = make_mesh(n, dp, devices=devices[:n * dp])
    kw = dict(chunks=m, checkpoint=spec.get("checkpoint", "always"),
              schedule=spec.get("schedule", "fill_drain"),
              loss_reduction=spec.get("loss_reduction", "mean"),
              dp_axis="dp" if dp > 1 or spec.get("dp_axis") else None,
              fsdp=spec.get("fsdp", False), virtual_stages=spec.get("v", 1))
    key = jax.random.PRNGKey(spec.get("seed", 0))
    if spec["model"] == "llama":
        cfg = TransformerConfig(vocab=64, dim=32, n_layers=spec["n_layers"], n_heads=4,
                                n_kv_heads=2, tie_embeddings=spec.get("tied", False))
        block, pre, post = llama_spmd(cfg, n * kw["virtual_stages"])
        pipe = SpmdGPipe(block, n, mesh, loss_fn=cross_entropy, pre=pre, post=post, **kw)
        tokens = jax.random.randint(jax.random.PRNGKey(1), (B, 8), 0, 64)
        params = pipe.init(key, jax.ShapeDtypeStruct(tokens.shape, tokens.dtype))
        return pipe, params, tokens, tokens
    loss = mse_sum if kw["loss_reduction"] == "sum" else mse
    if spec["model"] == "skips":
        pipe = SpmdGPipe(u_stage(), n, mesh, loss_fn=loss, **kw)
        d_in = d_out = SKIP_DIM
    else:
        block = chain([layer_norm(name="ln"), dense(DIM, name="fc"), gelu("act")],
                      name="block")
        pre = post = None
        d_in = d_out = DIM
        if spec.get("pre_post"):
            pre, post, d_in, d_out = dense(DIM, name="embed"), dense(3, name="head"), 5, 3
        pipe = SpmdGPipe(block, n, mesh, loss_fn=loss, pre=pre, post=post, **kw)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, d_in))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (B, d_out))
    params = pipe.init(key, jax.ShapeDtypeStruct((4, d_in), jnp.float32))
    return pipe, params, x, tgt


def to_torch(tree):
    """A reference tree (dicts, tuples, lists of arrays) as torch tensors,
    the same layout."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def items(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in items(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in items(v, path + (i,))]
    return [(path, tree)]


def assert_trees_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Every leaf of the port's tree against the reference's at the same
    path (the reference's leaves that the port lacks fail too)."""
    g = dict(items(got))
    w = dict(items(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(map(str, g)) == sorted(map(str, w))
    for path, ref in w.items():
        np.testing.assert_allclose(g[path].numpy(), ref, rtol=rtol, atol=atol,
                                   err_msg=str(path))


def run_reference(cases, devices):
    """The reference's numbers and the port's inputs of every case."""
    prepared = {name: reference(spec, devices) for name, spec in cases.items()}
    inputs = {name: port_inputs(spec, *prepared[name]) for name, spec in cases.items()}
    return inputs, {name: numbers(spec, *prepared[name]) for name, spec in cases.items()}


def port_inputs(spec, pipe, params, x, tgt):
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return {"spec": spec, "params": to_torch(host), "x": torch.from_numpy(np.array(x)),
            "tgt": torch.from_numpy(np.array(tgt))}


def numbers(spec, pipe, params, x, tgt):
    """The reference's step (or apply) of a case; none for a port-only
    ``zero`` case."""
    if spec.get("zero"):
        return {}
    if spec.get("step"):
        loss, grads = pipe.train_step(params, x, tgt)
        new = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads)
        return {"loss": float(loss), "params": jax.device_get(new)}
    if spec.get("apply"):
        return {"out": np.asarray(pipe.apply(params, x)),
                "loss": float(pipe.eval_loss(params, x, tgt))}
    loss, grads = pipe.train_step(params, x, tgt)
    return {"loss": float(loss), "grads": jax.device_get(grads),
            "params": jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
            "x": np.asarray(x), "tgt": np.asarray(tgt)}


def run_both(worlds, cases, devices, out, extra=None):
    """Every case on both engines: the reference's params drawn first,
    then the port's worlds started on them (a thread waits on the rank
    processes) while the reference computes its numbers here, and those
    of the reference-only ``extra`` cases.  Returns ``(port results,
    reference numbers)`` by case name."""
    import threading

    prepared = {name: reference(cases[name], devices)
                for shape in worlds for name in worlds[shape]}
    inputs = {shape: {name: port_inputs(cases[name], *prepared[name])
                      for name in names} for shape, names in worlds.items()}
    port, error = {}, []

    def ranks():
        try:
            port.update(run_port_worlds(inputs, out))
        except BaseException as e:   # re-raised below, in the test's thread
            error.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        want = {name: numbers(cases[name], *p) for name, p in prepared.items()}
        for name, spec in (extra or {}).items():
            want["extra:" + name] = numbers(spec, *reference(spec, devices))
    finally:
        thread.join()
    if error:
        raise error[0]
    return port, want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_port(inputs, pp, dp, out, timeout=240, sp=1, tp=1):
    """Every case of ``inputs`` on ``pp * dp * sp * tp`` rank processes;
    returns rank 0's results by case name (with ``"ranks"``, every rank's
    own file, where a case writes one per rank)."""
    tag = f"{pp}x{dp}" + (f"x{sp}x{tp}" if sp * tp > 1 else "")
    path = os.path.join(out, f"inputs_{tag}.pt")
    torch.save(inputs, path)
    res = os.path.join(out, f"res_{tag}")
    os.makedirs(res, exist_ok=True)
    world, port = pp * dp * sp * tp, _free_port()
    procs = []
    for rank in range(world):
        log = open(os.path.join(res, f"rank{rank}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, SCRIPT, "--rank", str(rank), "--world", str(world),
             "--port", str(port), "--pp", str(pp), "--dp", str(dp), "--sp", str(sp),
             "--tp", str(tp), "--inputs", path, "--out", res],
            cwd=REPO, env=cpu_subproc_env(OMP_NUM_THREADS="1"), stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.time() + timeout
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.time())) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(rcs):
        logs = "".join(open(os.path.join(res, f"rank{r}.log")).read()[-3000:]
                       for r in range(world))
        raise AssertionError(f"rank exit codes {rcs}:\n{logs}")
    out = {name: torch.load(os.path.join(res, name + ".pt"), weights_only=True)
           for name in inputs}
    for name in inputs:
        per_rank = [os.path.join(res, f"{name}_rank{r}.pt") for r in range(world)]
        if os.path.exists(per_rank[0]):
            out[name]["ranks"] = [torch.load(f, weights_only=True) for f in per_rank]
    extra = os.path.join(res, "global_batch.pt")
    if os.path.exists(extra):
        out[f"global_batch_{pp}x{dp}"] = torch.load(extra, weights_only=True)
    extra = os.path.join(res, "global_batch_sp.pt")
    if os.path.exists(extra):
        out[f"global_batch_sp_{tag}"] = torch.load(extra, weights_only=True)
    return out


def run_port_worlds(inputs_by_shape, out):
    """:func:`run_port` for each ``(pp, dp[, sp, tp]): inputs`` in turn;
    every case's rank-0 results by name."""
    res = {}
    for shape, inputs in inputs_by_shape.items():
        pp, dp, sp, tp = (*shape, 1, 1)[:4]
        res.update(run_port(inputs, pp, dp, out, sp=sp, tp=tp))
    return res
