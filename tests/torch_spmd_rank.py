"""One rank of a torchgpipe_tpu_torch.spmd world on the CPU, over gloo.

Run by tests/test_torch_spmd.py and tests/test_torch_spmd_1f1b.py as
``pp * dp`` OS processes:

    python tests/torch_spmd_rank.py --rank R --world W --port P \\
        --pp PP --dp DP --inputs inputs.pt --out DIR

``inputs.pt`` maps case names to ``{"spec", "params", "x", "tgt"}``: the
case's description (see :func:`build`), the global params tree in the
reference's layout (torch tensors, blocks stacked ``[n_stages, ...]``) and
the batch.  Every rank runs every case with this world's ``(pp, dp)``;
rank 0 writes ``DIR/<case>.pt``: ``{"loss", "grads"}`` (the gathered
global gradient tree) for a train case, ``{"loss", "params"}`` after one
``make_train_step`` SGD step (lr 0.1) for a ``step`` case, ``{"out",
"loss"}`` for an ``apply`` case; a world with dp > 1 also writes
``global_batch.pt`` (``utils.data.global_batch_from_local`` of each
rank's rows).
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchgpipe_tpu_torch import skip  # noqa: E402
from torchgpipe_tpu_torch import spmd  # noqa: E402
from torchgpipe_tpu_torch.models import transformer as tt  # noqa: E402
from torchgpipe_tpu_torch.ops.nn import GELU, Dense, LayerNorm  # noqa: E402
from torchgpipe_tpu_torch.utils.data import global_batch_from_local  # noqa: E402

DIM = 8
SKIP_DIM = 16


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def mse_sum(out, tgt):
    return ((out - tgt) ** 2).sum()


def llama_cfg(spec):
    return tt.TransformerConfig(
        vocab=64, dim=32, n_layers=spec["n_layers"], n_heads=4, n_kv_heads=2,
        tie_embeddings=spec.get("tied", False), dtype=torch.float32)


def u_stage():
    """The reference test's mini-U stage: a skip resolved inside it."""
    ns = skip.Namespace()
    return skip.SkipSequential(
        LayerNorm(SKIP_DIM, device="cpu"), Dense(SKIP_DIM, SKIP_DIM, device="cpu"),
        skip.stash("feat", ns=ns), Dense(SKIP_DIM, SKIP_DIM // 4, device="cpu"), GELU(),
        Dense(SKIP_DIM // 4, SKIP_DIM, device="cpu"), skip.pop_cat("feat", ns=ns),
        Dense(2 * SKIP_DIM, SKIP_DIM, device="cpu"))


def build(spec, mesh):
    """The port's engine of a case: ``spec["model"]`` is ``mlp`` (LayerNorm,
    Dense, GELU blocks; ``pre_post`` adds a Dense embedding 5 -> 8 and a
    Dense head 8 -> 3), ``llama`` (``llama_spmd``, cross-entropy) or
    ``skips`` (:func:`u_stage`)."""
    kw = dict(chunks=spec["chunks"], checkpoint=spec.get("checkpoint", "always"),
              schedule=spec.get("schedule", "fill_drain"),
              loss_reduction=spec.get("loss_reduction", "mean"),
              dp_axis="dp" if spec["dp"] > 1 or spec.get("dp_axis") else None)
    n = spec["pp"]
    if spec["model"] == "llama":
        block, pre, post = tt.llama_spmd(llama_cfg(spec), n, device="cpu")
        return spmd.SpmdGPipe(block, n, mesh, loss_fn=tt.cross_entropy, pre=pre,
                              post=post, **kw)
    loss = mse_sum if kw["loss_reduction"] == "sum" else mse
    if spec["model"] == "skips":
        return spmd.SpmdGPipe(u_stage(), n, mesh, loss_fn=loss, **kw)
    block = nn.Sequential(LayerNorm(DIM, device="cpu"), Dense(DIM, DIM, device="cpu"),
                          GELU())
    pre = post = None
    if spec.get("pre_post"):
        pre, post = Dense(5, DIM, device="cpu"), Dense(DIM, 3, device="cpu")
    return spmd.SpmdGPipe(block, n, mesh, loss_fn=loss, pre=pre, post=post, **kw)


def main():
    ap = argparse.ArgumentParser()
    for name in ("rank", "world", "port", "pp", "dp"):
        ap.add_argument(f"--{name}", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a.port}",
                            rank=a.rank, world_size=a.world)
    try:
        mesh = spmd.make_mesh(a.pp, a.dp, device="cpu")
        cases = torch.load(a.inputs, weights_only=True)
        for name, case in cases.items():
            spec = case["spec"]
            pipe = build(spec, mesh)
            params = pipe.place(case["params"])
            if spec.get("apply"):
                out = pipe.apply(params, case["x"])
                loss = pipe.eval_loss(params, case["x"], case["tgt"])
                if a.rank == 0:
                    torch.save({"out": out, "loss": loss}, os.path.join(a.out, name + ".pt"))
                continue
            if spec.get("step"):   # one SGD step through make_train_step
                step = pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=0.1))
                loss = step(params, case["x"], case["tgt"])
                params = pipe.gather(params)
                if a.rank == 0:
                    torch.save({"loss": loss, "params": params},
                               os.path.join(a.out, name + ".pt"))
                continue
            loss, grads = pipe.train_step(params, case["x"], case["tgt"])
            grads = pipe.gather(grads)
            if a.rank == 0:
                torch.save({"loss": loss, "grads": grads}, os.path.join(a.out, name + ".pt"))
        if a.dp > 1:   # every rank's own rows, assembled over dp
            local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * a.rank
            got = global_batch_from_local(mesh, spmd.P("dp"), local)
            if a.rank == 0:
                torch.save({"global": got}, os.path.join(a.out, "global_batch.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
