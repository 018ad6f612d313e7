#!/usr/bin/env python3
"""One workload timed in two checkouts of the port, alternately, on one
NVIDIA GPU.

    python3 torchgpipe_tpu_torch/tools/ab.py --other DIR \\
        [--workload generate|train] [--rounds 4]

``DIR`` is the root of another checkout (for example an unpacked ``git
archive`` of the parent commit).  One worker process per checkout imports
that checkout's ``torchgpipe_tpu_torch``, builds its kernels and makes the
same model at Llama-3-8B width (random weights from ``--seed``); both stay
resident.  Each round then runs the workload in the order other, this,
this, other, so that a drift of the host's or the card's speed during the
run falls on both alike.  Workloads:

* ``generate``: greedy bf16 ``generate`` of 4 prompts of 1024 tokens,
  ``--new-tokens`` new (32 blocks, ~17 GiB a worker).  Each call is timed
  on the device clock, split into prefill and decode by an event its
  prefill records on return; host time sets decode's pace at this size.
  Each call also times 200 back-to-back ``flash_decode_attention`` wrapper
  calls at the decode shape (cache [4, 1152, 8, 128], live 1088), where
  the host's time per call, not the kernel, sets the pace.
* ``train``: a training step of chip_smoke.py's phase 8 (``GPipe(llama,
  [n + 2], chunks=4, checkpoint='except_last')``, batch 8 x seq 1024,
  ``value_and_grad`` with the causal LM loss, then an in-place SGD update
  at lr 1e-4) and a ``generation.prefill`` of 4 prompts of 1024 tokens,
  each timed on the device clock.  ``--layers`` blocks (default 8 of 32,
  so that both workers fit on one 80 GB card; every block is the same, so
  the attention kernels' share of a step is the same as at 32).

Prints one line per call, the medians per checkout, the median of the
per-round ratios (this / other), the card's name and power limit, and as
its last line a JSON object with every number.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LLAMA3_8B = dict(vocab=128256, dim=4096, n_heads=32, n_kv_heads=8, mlp_ratio=5.25)
THIS_TREE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TAG = "AB "   # prefix of the workers' protocol lines on stdout


def _reply(obj) -> None:
    print(TAG + json.dumps(obj), flush=True)


def _setup(seed: int, layers: int):
    import torch

    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    cfg = tt.TransformerConfig(**LLAMA3_8B, n_layers=layers, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch, tt, cfg, gen, tt.llama(cfg, device="cuda", generator=gen), build_s


def generate_calls(args):
    """The ``generate`` workload: yields one call's numbers per ``next``."""
    torch, _, cfg, gen, model, build_s = _setup(args.seed, 32)
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    prompt = torch.randint(0, cfg.vocab, (4, 1024), generator=gen, device="cuda")
    tg.generate(cfg, model, prompt[:, :128], 2)        # warm-up: cuBLAS, allocator
    dq = torch.randn(4, 1, 32, 128, generator=gen, device="cuda").bfloat16()
    dk = torch.randn(4, 1152, 8, 128, generator=gen, device="cuda").bfloat16()
    dv = torch.randn(4, 1152, 8, 128, generator=gen, device="cuda").bfloat16()
    torch.cuda.synchronize()
    yield {"ready": True, "package": os.path.dirname(tg.__file__), "build_s": build_s}

    real_prefill = tg.prefill
    marks = []

    def marked_prefill(*a, **kw):
        res = real_prefill(*a, **kw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return res

    tg.prefill = marked_prefill
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = tg.generate(cfg, model, prompt, args.new_tokens)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        for _ in range(5):
            tfa.flash_decode_attention(dq, dk, dv, 1087)
        torch.cuda.synchronize()
        c0 = torch.cuda.Event(enable_timing=True)
        c1 = torch.cuda.Event(enable_timing=True)
        c0.record()
        for _ in range(200):
            tfa.flash_decode_attention(dq, dk, dv, 1087)
        c1.record()
        c1.synchronize()
        yield {"decode_ms_per_token": marks[-1].elapsed_time(end) / args.new_tokens,
               "prefill_ms": start.elapsed_time(marks[-1]),
               "decode_call_ms": c0.elapsed_time(c1) / 200,
               "total_ms": start.elapsed_time(end), "host_ms": host_ms,
               "tokens": out.flatten().tolist()}


def train_calls(args):
    """The ``train`` workload: yields one call's numbers per ``next``."""
    import numpy as np

    torch, tt, cfg, _, llama, build_s = _setup(args.seed, args.layers)
    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models import generation as tg

    tokens = torch.from_numpy(
        np.random.default_rng(args.seed).integers(0, cfg.vocab, (8, 1024))).cuda()
    prompt = tokens[:4].contiguous()
    model = GPipe(llama, [len(llama)], chunks=4, checkpoint="except_last")
    params = list(model.parameters())

    def loss_fn(out, tgt):
        return tt.cross_entropy(out[:, :-1, :], tgt[:, 1:])

    def step():
        loss, _, _ = model.value_and_grad(tokens, tokens, loss_fn)
        with torch.no_grad():
            for p in params:
                p.add_(p.grad, alpha=-1e-4)
        return loss

    step()                                              # warm-up: cuBLAS, allocator
    with torch.inference_mode():
        tg.prefill(cfg, llama, prompt, 1152)
    torch.cuda.synchronize()
    yield {"ready": True, "package": os.path.dirname(tg.__file__), "build_s": build_s}

    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = step()
        ev[1].record()
        with torch.inference_mode():
            ev[2].record()
            tg.prefill(cfg, llama, prompt, 1152)
            ev[3].record()
        ev[3].synchronize()
        yield {"step_ms": ev[0].elapsed_time(ev[1]), "prefill_ms": ev[2].elapsed_time(ev[3]),
               "loss": loss.item(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# workload -> (worker's calls, the keys compared as this / other ratios)
WORKLOADS = {
    "generate": (generate_calls, ("decode_ms_per_token", "prefill_ms", "decode_call_ms")),
    "train": (train_calls, ("step_ms", "prefill_ms")),
}


def worker(args) -> None:
    """Set up, then answer each ``run`` line on stdin with one call's
    numbers, until ``quit``."""
    calls = WORKLOADS[args.workload][0](args)
    _reply(next(calls))
    while sys.stdin.readline().strip() == "run":
        _reply(next(calls))


def _read(proc, label: str) -> dict:
    while True:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"ab: FAIL: the {label} worker exited (code {proc.poll()})")
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
        print(f"[{label}] {line.rstrip()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="generate")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=128, help="generate's new tokens")
    ap.add_argument("--layers", type=int, default=8, help="train's blocks")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab: FAIL: no CUDA device")
    if not args.other:
        raise SystemExit("ab: FAIL: --other DIR is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    trees = {"other": os.path.abspath(args.other), "this": THIS_TREE}
    procs = {}
    calls = {"other": [], "this": []}
    try:
        # One at a time: each worker's warm-up peaks before it settles.
        for label, tree in trees.items():
            procs[label] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--workload", args.workload, "--seed", str(args.seed),
                 "--new-tokens", str(args.new_tokens), "--layers", str(args.layers)],
                cwd=tree, env=dict(os.environ, PYTHONPATH=tree), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
            ready = _read(procs[label], label)
            if not ready["package"].startswith(tree):
                raise SystemExit(f"ab: FAIL: the {label} worker imported "
                                 f"{ready['package']}, not the one under {tree}")
            print(f"{label}: {ready['package']}, kernels built in "
                  f"{ready['build_s']:.1f}s", flush=True)

        for r in range(args.rounds):
            for label in ("other", "this", "this", "other"):
                procs[label].stdin.write("run\n")
                procs[label].stdin.flush()
                res = _read(procs[label], label)
                res["round"] = r
                calls[label].append(res)
                print(f"round {r} {label}: " + " ".join(
                    f"{k}={v:.5f}" for k, v in res.items() if isinstance(v, float))
                    + f" [{card}]", flush=True)
    finally:
        for proc in procs.values():
            try:
                proc.stdin.write("quit\n")
                proc.stdin.close()
                proc.wait(timeout=60)
            except Exception:
                proc.kill()
                proc.wait()

    med = statistics.median
    summary = {"card": card, "workload": args.workload, "rounds": args.rounds}
    for label, cs in calls.items():
        keys = [k for k, v in cs[0].items() if isinstance(v, float)]
        summary[label] = {"tree": trees[label]} | {k: [c[k] for c in cs] for k in keys}
        summary[label]["median"] = {k: med(summary[label][k]) for k in keys}
    ratios = {}
    for key in WORKLOADS[args.workload][1]:
        per_round = []
        for r in range(args.rounds):
            mine = [c[key] for c in calls["this"] if c["round"] == r]
            theirs = [c[key] for c in calls["other"] if c["round"] == r]
            per_round.append(statistics.mean(mine) / statistics.mean(theirs))
        ratios[key] = {"per_round": per_round, "median": med(per_round),
                       "range": [min(per_round), max(per_round)]}
    summary["ratio_this_over_other"] = ratios
    agreement = ""
    if "tokens" in calls["this"][0]:
        a, b = calls["this"][0]["tokens"], calls["other"][0]["tokens"]
        summary["token_agreement"] = sum(x == y for x, y in zip(a, b)) / len(a)
        agreement = f"; greedy token agreement {summary['token_agreement']:.4f}"
    for label in ("other", "this"):
        print(f"{label}: median " + " ".join(
            f"{k}={v:.5f}" for k, v in summary[label]["median"].items()) + f" [{card}]",
            flush=True)
    print("this / other, median (range) of per-round ratios: " + " ".join(
        f"{k}={v['median']:.4f} ({v['range'][0]:.4f}-{v['range'][1]:.4f})"
        for k, v in ratios.items()) + agreement + f" [{card}]", flush=True)
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
