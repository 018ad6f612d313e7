"""One rank of a torchgpipe_tpu_torch.spmd world on the CPU, over gloo.

Run by tests/test_torch_spmd.py, tests/test_torch_spmd_1f1b.py, the
tensor- and sequence-parallel tests (tests/test_torch_tensor_parallel.py,
test_torch_ring_attention.py, test_torch_ulysses.py) and the
expert-parallel and engine-knob tests (test_torch_spmd_moe_ep.py,
test_torch_spmd_knobs.py) as ``pp * dp * sp * tp * ep`` OS processes:

    python tests/torch_spmd_rank.py --rank R --world W --port P \\
        --pp PP --dp DP [--sp SP --tp TP --ep EP] --inputs inputs.pt --out DIR

``inputs.pt`` maps case names to ``{"spec", "params", "x", "tgt"}``: the
case's description (see :func:`build`), the global params tree in the
reference's layout (torch tensors, blocks stacked ``[n_stages, ...]``) and
the batch.  Every rank runs every case with this world's ``(pp, dp)``;
rank 0 writes ``DIR/<case>.pt``: ``{"loss", "grads"}`` (the gathered
global gradient tree) for a train case, ``{"loss", "params"}`` after one
``make_train_step`` SGD step (lr 0.1) for a ``step`` case, ``{"out",
"loss"}`` for an ``apply`` case; a world with dp > 1 also writes
``global_batch.pt`` (``utils.data.global_batch_from_local`` of each
rank's rows); a ``zero`` case (:func:`run_zero`) writes whether each
ZeRO update was bitwise its unsharded one, gathered from every rank.  A ``place`` case writes the gathered placement on rank 0
and every rank's own tree to ``DIR/<case>_rank<r>.pt``; an ``op`` case
(``ring``, ``ulysses`` or ``tensor``: :func:`run_op`) runs one parallel
primitive on this rank's shard of ``{"q", "k", "v", "do"}`` or ``{"x"}``;
a ``knob`` case (:func:`run_knob`) runs the engine's own knobs (megastep,
``rng=``, ``checkpoint='offload'``, StepGuard under ``faults.inject``,
a failing cell's note) and writes each rank's findings.
"""

import argparse
import functools
import os
import sys

import torch
import torch.distributed as dist
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchgpipe_tpu_torch import parallel, skip  # noqa: E402
from torchgpipe_tpu_torch import spmd  # noqa: E402
from torchgpipe_tpu_torch.models import moe as tm  # noqa: E402
from torchgpipe_tpu_torch.models import transformer as tt  # noqa: E402
from torchgpipe_tpu_torch import rng as trng  # noqa: E402
from torchgpipe_tpu_torch.ops.nn import GELU, Dense, Dropout, LayerNorm  # noqa: E402
from torchgpipe_tpu_torch.resilience import StepGuard, faults  # noqa: E402
from torchgpipe_tpu_torch.utils.data import global_batch_from_local  # noqa: E402

DIM = 8
SKIP_DIM = 16


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def mse_sum(out, tgt):
    return ((out - tgt) ** 2).sum()


def llama_cfg(spec):
    """The case's config: the parity tests' Llama, with the case's tp/sp
    axes and knobs (``spec["cfg"]``)."""
    kw = dict(vocab=64, dim=32, n_layers=spec["n_layers"], n_heads=4, n_kv_heads=2,
              tie_embeddings=spec.get("tied", False), dtype=torch.float32,
              tp_axis="tp" if spec.get("tp", 1) > 1 else None,
              sp_axis="sp" if spec.get("sp", 1) > 1 else None)
    kw.update(spec.get("cfg", {}))
    return tt.TransformerConfig(**kw)


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
    Dense head 8 -> 3), ``llama`` (``llama_spmd``, cross-entropy), ``moe``
    (``llama_moe_spmd``, 4 experts over the ep axis when the world has
    one; :func:`moe_kw`) or ``skips`` (:func:`u_stage`)."""
    kw = dict(chunks=spec["chunks"], checkpoint=spec.get("checkpoint", "always"),
              schedule=spec.get("schedule", "fill_drain"),
              loss_reduction=spec.get("loss_reduction", "mean"),
              dp_axis="dp" if spec["dp"] > 1 or spec.get("dp_axis") else None,
              fsdp=spec.get("fsdp", False), virtual_stages=spec.get("v", 1))
    n = spec["pp"]
    if spec["model"] == "moe":
        cfg = tt.TransformerConfig(vocab=64, dim=32, n_layers=spec["n_layers"], n_heads=4,
                                   n_kv_heads=2, dtype=torch.float32)
        block, pre, post = tm.llama_moe_spmd(cfg, tm.MoEConfig(**moe_kw(spec)), n,
                                             device="cpu")
        return spmd.SpmdGPipe(block, n, mesh, loss_fn=tt.cross_entropy, pre=pre, post=post,
                              ep_axis="ep" if spec.get("ep", 1) > 1 else None, **kw)
    if spec["model"] == "llama":
        cfg = llama_cfg(spec)
        gather = spec.get("gather_logits", True)
        block, pre, post = tt.llama_spmd(cfg, n * kw["virtual_stages"], device="cpu",
                                         gather_logits=gather)
        loss = tt.cross_entropy if gather else tt.vocab_parallel_cross_entropy(cfg.tp_axis)
        return spmd.SpmdGPipe(block, n, mesh, loss_fn=loss, pre=pre, post=post,
                              tp_axis=cfg.tp_axis, sp_axis=cfg.sp_axis, **kw)
    loss = mse_sum if kw["loss_reduction"] == "sum" else mse
    if spec["model"] in ("drop", "drop2", "bomb"):
        # Dropout blocks (one or two Dense/Dropout/GELU groups a block) and
        # a block whose second layer raises once armed.
        group = lambda: [Dense(DIM, DIM, device="cpu"), Dropout(0.1), GELU()]  # noqa: E731
        layers = {"drop": group(), "drop2": group() + group(),
                  "bomb": [Dense(DIM, DIM, device="cpu"), Bomb()]}[spec["model"]]
        return spmd.SpmdGPipe(nn.Sequential(*layers), n, mesh, loss_fn=loss, **kw)
    if spec["model"] == "skips":
        return spmd.SpmdGPipe(u_stage(), n, mesh, loss_fn=loss, **kw)
    block = nn.Sequential(LayerNorm(DIM, device="cpu"), Dense(DIM, DIM, device="cpu"),
                          GELU())
    pre = post = None
    if spec.get("pre_post"):
        pre, post = Dense(5, DIM, device="cpu"), Dense(DIM, 3, device="cpu")
    return spmd.SpmdGPipe(block, n, mesh, loss_fn=loss, pre=pre, post=post, **kw)


def moe_kw(spec):
    """tests/torch_spmd_parity.py's ``moe_kw``: the reference's fields."""
    kw = dict(n_experts=4, top_k=2, capacity_factor=8.0,
              dispatch=spec.get("dispatch", "dense"),
              balance_weight=spec.get("balance_weight", 0.0))
    if spec.get("ep", 1) > 1:
        kw["ep_axis"] = "ep"
    return kw


class ExpectedError(Exception):
    pass


class Bomb(nn.Module):
    """Identity until ``armed``; then raises :class:`ExpectedError`."""

    armed = False

    def forward(self, x):
        if self.armed:
            raise ExpectedError("armed")
        return x


def _equal_trees(a, b):
    """Leaf for leaf bitwise (NaNs equal where both hold one)."""
    la, lb = spmd._leaves(a), spmd._leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.nan_to_num(x, nan=1234.5), torch.nan_to_num(y, nan=1234.5))
        and torch.equal(x.isnan(), y.isnan()) for x, y in zip(la, lb))


def _opt_state(opt):
    return [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]


def run_knob(spec, case, mesh, out, rank):
    """One knob case on this rank; rank 0's findings (``every`` rank's
    booleans gathered) for the test."""
    knob, x, y = spec["knob"], case["x"], case["tgt"]
    # Layers without reset_parameters keep their constructed values: the
    # same on every rank.
    torch.manual_seed(0)
    res = {}
    if knob == "megastep":
        # K AdamW steps a call over stacked batches with a NaN in batch 1,
        # against StepGuard around K single steps, bitwise.
        pipe = build(spec, mesh)
        opt = lambda ts: torch.optim.AdamW(ts, lr=1e-3, weight_decay=1e-4)  # noqa: E731
        pa, pb, pc = (pipe.place(case["params"]) for _ in range(3))
        stepk = pipe.make_train_step(opt, megastep=spec["k"])
        losses, finite = stepk(pa, x, y)
        step1 = pipe.make_train_step(opt)
        guard = StepGuard(step1)
        single = torch.stack([guard(pb, x[k], y[k]) for k in range(spec["k"])])
        guard_k = StepGuard(pipe.make_train_step(opt, megastep=spec["k"]))
        guard_k(pc, x, y)
        res["bitwise"] = (_equal_trees(losses, single) and _equal_trees(pa, pb)
                          and _equal_trees(_opt_state(stepk.optimizer),
                                           _opt_state(step1.optimizer)))
        res["guard_stats"] = torch.tensor([guard.stats.steps, guard.stats.skipped,
                                           guard_k.stats.steps, guard_k.stats.skipped])
        res["finite"] = finite.cpu()
        res["losses"] = losses
        res["params"] = pipe.gather(pa)
    elif knob == "megastep_rng":
        # Inner step k of a keyed megastep is a single step keyed fold_in(rng, k).
        pipe = build(spec, mesh)
        params = pipe.init(torch.Generator().manual_seed(0), x[0])
        opt = lambda ts: torch.optim.SGD(ts, lr=1e-2)  # noqa: E731
        pa, pb, pc = (pipe.place(params) for _ in range(3))
        pipe.make_train_step(opt, megastep=2)(pa, x, y, 42)
        step1 = pipe.make_train_step(opt)
        key = trng.key_tensor(42)
        for k in range(2):
            step1(pb, x[k], y[k], trng.fold_in(key, k))
        pipe.make_train_step(opt, megastep=2)(pc, x, y, 43)
        res["bitwise"] = _equal_trees(pa, pb)
        res["other_key_differs"] = not _equal_trees(pa, pc)
    elif knob == "rng":
        # One model, two layouts: fill-drain blocks of two Dense/Dropout/GELU
        # groups, and the interleaved pipe's one group a virtual stage.
        fd = build(dict(spec, model="drop2"), mesh)
        params = fd.init(torch.Generator().manual_seed(0), x)
        n = spec["pp"]

        def group(gb):   # global group gb's Dense leaves in the fill-drain tree
            return spmd._tree_map(lambda a: a[gb // 2], params["blocks"][3 * (gb % 2)])

        il_blocks = (spmd._stack([spmd._stack([group(c * n + j) for c in range(2)])
                                  for j in range(n)]), (), ())
        il_params = dict(params, blocks=il_blocks)
        losses = {}
        for name, kw in (("fill_drain", {}), ("fill_drain_never", dict(checkpoint="never")),
                         ("1f1b", dict(schedule="1f1b", checkpoint="except_last")),
                         ("zb", dict(schedule="zb", checkpoint="never")),
                         ("interleaved", dict(model="drop", schedule="interleaved", v=2))):
            pipe = build(dict(spec, **dict(dict(model="drop2"), **kw)), mesh)
            tree = pipe.place(il_params if kw.get("v") else params)
            loss, grads = pipe.train_step(tree, x, y, 7)
            losses[name] = loss
            if name.startswith("fill_drain"):
                res[name + "_grads"] = pipe.gather(grads)
        losses["again"] = fd.train_step(fd.place(params), x, y, 7)[0]
        losses["other_key"] = fd.train_step(fd.place(params), x, y, 8)[0]
        res["losses"] = torch.stack(list(losses.values()))
        res["names"] = list(losses)
    elif knob == "offload":
        # 'offload' against 'never': the same products, bitwise.
        got = {}
        params = build(spec, mesh).init(torch.Generator().manual_seed(0), x)
        for mode in ("never", "offload"):
            pipe = build(dict(spec, checkpoint=mode), mesh)
            loss, grads = pipe.train_step(pipe.place(params), x, y)
            got[mode] = (loss, pipe.gather(grads))
        res["bitwise"] = (torch.equal(got["never"][0], got["offload"][0])
                          and (rank != 0 or _equal_trees(got["never"][1], got["offload"][1])))
        res["saved_bytes"] = pipe.offload_stats["saved_bytes"]
        res["moved_bytes"] = pipe.offload_stats["moved_bytes"]
    elif knob == "guard":
        # StepGuard: a step whose stage-1 input is poisoned is skipped with
        # every parameter and the optimizer state bitwise as before, and the
        # next clean step equals an unguarded one from the same state.
        pipe = build(spec, mesh)
        params = pipe.place(case["params"])
        step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9))
        guard = StepGuard(step)
        guard(params, x, y)
        live = lambda: spmd._leaves(params) + _opt_state(step.optimizer)  # noqa: E731
        before = [t.clone() for t in live()]
        with faults.inject(nan_at=(1, 0)):
            bad = guard(params, x, y)
        skipped_same = guard.stats.skipped == 1 and _equal_trees(live(), before)
        good = guard(params, x, y)
        after = [t.clone() for t in live()]
        with torch.no_grad():
            for t, b in zip(live(), before):
                t.copy_(b)
        plain = step(params, x, y)
        res["bitwise"] = (skipped_same and not bool(torch.isfinite(bad))
                          and torch.equal(good, plain) and _equal_trees(after, live()))
    elif knob == "bomb":
        # A cell that raises: the type kept, a note naming the cell.
        pipe = build(spec, mesh)
        params = pipe.place(pipe.init(torch.Generator().manual_seed(0), x))
        for m in pipe.block.modules():
            if isinstance(m, Bomb):
                m.armed = mesh.coords["pp"] in spec["armed_stages"]
        try:
            if spec.get("apply"):
                pipe.apply(params, x)
            else:
                pipe.train_step(params, x, y)
            res = {"type": "none", "notes": ""}
        except Exception as e:  # noqa: BLE001 — what the test reads
            res = {"type": type(e).__name__, "notes": "".join(getattr(e, "__notes__", []))}
        if spec.get("ends_world"):
            # The failed schedule left its peers' transfers unmatched: every
            # rank records what it caught and leaves the world at once.
            torch.save(res, os.path.join(out, f"{case['name']}_rank{rank}.pt"))
            if rank == 0:
                torch.save(res, os.path.join(out, case["name"] + ".pt"))
            sys.stdout.flush()
            os._exit(0)
        return res
    if knob in ("megastep", "megastep_rng", "offload", "guard"):
        for key in [k for k, v in res.items() if isinstance(v, bool)]:
            flags = torch.tensor([res[key]], dtype=torch.int64)
            flags = torch.stack(mesh.all_gather(flags, "dp"))
            res[key] = torch.stack(mesh.all_gather(flags, "pp")).reshape(-1)
    return res


def run_op(spec, case, mesh):
    """One parallel primitive on this rank's shard; the results gathered
    over the axis (``sp``: the sequence dim of ``out``/``dq``/``dk``/``dv``;
    ``tp``: each lane's values stacked) for rank 0."""
    if spec["op"] == "tensor":
        with parallel.bind_axes(mesh, ["tp"]) as (ax,):
            x = case["x"].clone().requires_grad_()
            lane = float(ax.index + 1)
            res = {}
            y = parallel.psum_grad(x, "tp")
            (y * lane).sum().backward()
            res["psum_grad"], x.grad = x.grad, None
            y = parallel.psum_value(x * lane, "tp")
            (y * case["x"]).sum().backward()
            res["psum_value"], res["psum_value_grad"], x.grad = y.detach(), x.grad, None
            y = parallel.pmax_stop(x * lane, "tp")
            (y * case["x"]).sum().backward()
            res["pmax_stop"], res["pmax_stop_grad"], x.grad = y.detach(), x.grad, None
            y = parallel.all_gather_value(x * lane, "tp", -1)
            (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)).sum().backward()
            res["all_gather_value"], res["all_gather_value_grad"] = y.detach(), x.grad
            # Megatron's cross-entropy over this lane's vocab shard, and the
            # same logits shifted by 5e4 (the max shift keeps it finite).
            v = case["logits"].shape[-1] // ax.size
            for key, shift in (("vpce", 0.0), ("vpce_shift", 5e4)):
                loc = (case["logits"][..., ax.index * v:(ax.index + 1) * v] + shift
                       ).requires_grad_()
                loss = tt.vocab_parallel_cross_entropy("tp")(loc, case["labels"])
                loss.backward()
                res[key], res[key + "_grad"] = loss.detach().reshape(1), loc.grad
            return {k: torch.stack(mesh.all_gather(v, "tp")) for k, v in res.items()}
    sp, r = mesh.shape["sp"], mesh.coords["sp"]

    def shard(t):
        s = t.shape[1] // sp
        return t[:, r * s:(r + 1) * s].contiguous()

    q, k, v = (shard(case[n]).requires_grad_() for n in ("q", "k", "v"))
    with parallel.bind_axes(mesh, ["sp"]):
        if spec["op"] == "ring":
            out = parallel.ring_attention(q, k, v, "sp", causal=spec["causal"],
                                          kv_block_size=spec.get("kv_block_size", 2048))
        else:
            out = parallel.ulysses_attention(q, k, v, "sp", causal=spec["causal"],
                                             window=spec.get("window"))
        out.backward(shard(case["do"]))
    return {n: torch.cat(mesh.all_gather(t.detach(), "sp"), 1)
            for n, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


# The optimizers of a ``zero`` case: elementwise updates with state.
ZERO_OPTS = {
    "sgd": lambda ts: torch.optim.SGD(ts, lr=0.1, momentum=0.9),
    "adam": lambda ts: torch.optim.Adam(ts, lr=1e-2),
    "adamw": lambda ts: torch.optim.AdamW(ts, lr=1e-2, weight_decay=0.1),
}


def state_numel(opt):
    """Elements of ``opt``'s per-parameter state tensors on this rank."""
    return sum(v.numel() for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.ndim)


def run_zero(spec, case, mesh):
    """Two ``make_train_step`` updates for each of :data:`ZERO_OPTS`:
    ``zero=1`` against ``zero=0`` on dp-replicated params, and an fsdp
    pipe's ``zero=3`` against the unsharded update of this lane's
    gathered tensors (fed the fsdp step's gradients, gathered); whether
    each trajectory's losses and params are bitwise equal, and this
    rank's state and block sizes."""
    x, y = case["x"], case["tgt"]
    res = {}
    for name, opt in ZERO_OPTS.items():
        pipe = build(dict(spec, fsdp=False), mesh)
        ref, z1 = pipe.place(case["params"]), pipe.place(case["params"])
        s0, s1 = pipe.make_train_step(opt, zero=0), pipe.make_train_step(opt, zero=1)
        same = all(torch.equal(s0(ref, x, y), s1(z1, x, y)) for _ in range(2))
        same = same and all(torch.equal(a, b) for a, b in zip(pipe._flat(ref), pipe._flat(z1)))
        res[f"{name}_zero1"] = same
        fp = build(dict(spec, fsdp=True), mesh)
        z3 = fp.place(case["params"])
        s3 = fp.make_train_step(opt, zero=3)
        full = {k: spmd._tree_map(lambda a: a.detach().clone(),
                                  fp._gather_fsdp(v) if k == "blocks" else v)
                for k, v in z3.items()}
        unsharded = opt(fp._flat(full))

        def lane(tree):   # this lane's storage shards of a full tree
            out = dict(tree)
            out["blocks"] = spmd._tree_map(
                lambda a, d: a if d < 0 else a.narrow(
                    d, mesh.coords["dp"] * (a.shape[d] // mesh.shape["dp"]),
                    a.shape[d] // mesh.shape["dp"]).clone(),
                tree["blocks"], fp._fsdp_dims)
            return out

        same = True
        for _ in range(2):
            loss_o, g = fp.train_step(lane(full), x, y)
            g = dict(g, blocks=fp._gather_fsdp(g["blocks"]))
            for t, gr in zip(fp._flat(full), fp._flat(g)):
                t.grad = gr
            unsharded.step()
            same = same and torch.equal(s3(z3, x, y), loss_o)
        same = same and all(torch.equal(a, b) for a, b in
                            zip(fp._flat(z3), fp._flat(lane(full))))
        res[f"{name}_zero3"] = same
        res[f"{name}_state"] = torch.tensor([
            state_numel(s0.optimizer), state_numel(s1.optimizer),
            state_numel(s3.optimizer), state_numel(unsharded)])
    res["block_numel"] = torch.tensor([
        sum(a.numel() for a in spmd._leaves(ref["blocks"])),
        sum(a.numel() for a in spmd._leaves(z3["blocks"]))])
    def every_rank(v):   # [pp, dp, ...] on rank 0
        v = torch.stack(mesh.all_gather(torch.as_tensor(v, dtype=torch.int64), "dp"))
        return torch.stack(mesh.all_gather(v, "pp"))

    return {k: every_rank(v) for k, v in res.items()}


def main():
    ap = argparse.ArgumentParser()
    for name in ("rank", "world", "port", "pp", "dp"):
        ap.add_argument(f"--{name}", type=int, required=True)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a.port}",
                            rank=a.rank, world_size=a.world)
    try:
        mesh = spmd.make_mesh(a.pp, a.dp, a.sp, tp=a.tp, ep=a.ep, device="cpu")
        cases = torch.load(a.inputs, weights_only=True)
        for name, case in cases.items():
            spec = case["spec"]
            if spec.get("knob"):
                res = run_knob(spec, dict(case, name=name), mesh, a.out, a.rank)
                if a.rank == 0:
                    torch.save(res, os.path.join(a.out, name + ".pt"))
                continue
            if spec.get("op") or spec.get("zero"):
                res = (run_zero if spec.get("zero") else run_op)(spec, case, mesh)
                if a.rank == 0:
                    torch.save(res, os.path.join(a.out, name + ".pt"))
                continue
            pipe = build(spec, mesh)
            params = pipe.place(case["params"])
            if spec.get("place"):   # this rank's placement; the gathered tree
                torch.save(params, os.path.join(a.out, f"{name}_rank{a.rank}.pt"))
                back = pipe.gather(params)
                if a.rank == 0:
                    torch.save({"params": back}, os.path.join(a.out, name + ".pt"))
                continue
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
        if a.sp > 1:   # every rank's own positions, assembled over sp on dim 1
            local = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * mesh.coords["sp"]
            got = global_batch_from_local(mesh, spmd.P(None, "sp"), local)
            if a.rank == 0:
                torch.save({"global": got}, os.path.join(a.out, "global_batch_sp.pt"))
        if a.dp > 1:   # every rank's own rows, assembled over dp
            local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * a.rank
            got = global_batch_from_local(mesh, spmd.P("dp"), local)
            if a.rank == 0:
                torch.save({"global": got}, os.path.join(a.out, "global_batch.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
