#!/usr/bin/env python3
"""Greedy bf16 ``generate`` timed in two checkouts of the port, alternately,
on one NVIDIA GPU.

    python3 torchgpipe_tpu_torch/tools/generate_ab.py --other DIR [--rounds 4]

``DIR`` is the root of another checkout (for example an unpacked ``git
archive`` of the parent commit).  One worker process per checkout imports
that checkout's ``torchgpipe_tpu_torch``, builds its kernels, and makes the
same Llama-3-8B-width model (random weights from ``--seed``) and prompt
(batch 4, prompt 1024); both stay resident (~17 GiB each).  The script then
runs ``generate(..., 128 new tokens)`` in the order other, this, this,
other for every round, so a drift of the host's or the card's speed during
the run falls on both alike; host time sets decode's pace at this size.
Each call is timed on the device clock, split into prefill and decode by
an event its prefill records on return.  Each call also times 200
back-to-back ``flash_decode_attention`` wrapper calls at the decode shape
(cache [4, 1152, 8, 128], live 1088) on the device clock: at that size the
host's time per call, not the kernel, sets it.

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

LLAMA3_8B = dict(vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 mlp_ratio=5.25)
THIS_TREE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TAG = "AB "   # prefix of the workers' protocol lines on stdout


def _reply(obj) -> None:
    print(TAG + json.dumps(obj), flush=True)


def worker(seed: int, new_tokens: int) -> None:
    """Build, make the model, then answer ``run`` lines on stdin with one
    timed ``generate`` call each, until ``quit``."""
    import torch

    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.ops import _build
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    cfg = tt.TransformerConfig(**LLAMA3_8B, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tt.llama(cfg, device="cuda", generator=gen)
    prompt = torch.randint(0, cfg.vocab, (4, 1024), generator=gen, device="cuda")
    tg.generate(cfg, model, prompt[:, :128], 2)        # warm-up: cuBLAS, allocator
    dq = torch.randn(4, 1, 32, 128, generator=gen, device="cuda").bfloat16()
    dk = torch.randn(4, 1152, 8, 128, generator=gen, device="cuda").bfloat16()
    dv = torch.randn(4, 1152, 8, 128, generator=gen, device="cuda").bfloat16()
    torch.cuda.synchronize()
    _reply({"ready": True, "package": os.path.dirname(tg.__file__), "build_s": build_s})

    real_prefill = tg.prefill
    marks = []

    def marked_prefill(*a, **kw):
        res = real_prefill(*a, **kw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return res

    tg.prefill = marked_prefill
    while sys.stdin.readline().strip() == "run":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = tg.generate(cfg, model, prompt, new_tokens)
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
        _reply({"total_ms": start.elapsed_time(end),
                "prefill_ms": start.elapsed_time(marks[-1]),
                "decode_ms": marks[-1].elapsed_time(end), "host_ms": host_ms,
                "decode_call_ms": c0.elapsed_time(c1) / 200,
                "tokens": out.flatten().tolist()})


def _read(proc, label: str) -> dict:
    while True:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"generate_ab: FAIL: the {label} worker exited "
                             f"(code {proc.poll()})")
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
        print(f"[{label}] {line.rstrip()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.seed, args.new_tokens)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("generate_ab: FAIL: no CUDA device")
    if not args.other:
        raise SystemExit("generate_ab: FAIL: --other DIR is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    trees = {"other": os.path.abspath(args.other), "this": THIS_TREE}
    procs = {}
    try:
        for label, tree in trees.items():
            env = dict(os.environ, PYTHONPATH=tree)
            procs[label] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--seed", str(args.seed), "--new-tokens", str(args.new_tokens)],
                cwd=tree, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True,
            )
        for label, tree in trees.items():
            ready = _read(procs[label], label)
            if not ready["package"].startswith(tree):
                raise SystemExit(f"generate_ab: FAIL: the {label} worker imported "
                                 f"{ready['package']}, not the one under {tree}")
            print(f"{label}: {ready['package']}, kernels built in "
                  f"{ready['build_s']:.1f}s", flush=True)

        calls = {"other": [], "this": []}
        for r in range(args.rounds):
            for label in ("other", "this", "this", "other"):
                procs[label].stdin.write("run\n")
                procs[label].stdin.flush()
                res = _read(procs[label], label)
                res["round"] = r
                calls[label].append(res)
                print(f"round {r} {label}: total_ms={res['total_ms']:.3f} "
                      f"prefill_ms={res['prefill_ms']:.3f} decode_ms_per_token="
                      f"{res['decode_ms'] / args.new_tokens:.4f} host_ms="
                      f"{res['host_ms']:.3f} decode_call_ms={res['decode_call_ms']:.5f} "
                      f"[{card}]", flush=True)
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
    summary = {"card": card, "rounds": args.rounds, "new_tokens": args.new_tokens}
    for label, cs in calls.items():
        summary[label] = {
            "tree": trees[label],
            "decode_ms_per_token": [c["decode_ms"] / args.new_tokens for c in cs],
            "prefill_ms": [c["prefill_ms"] for c in cs],
            "total_ms": [c["total_ms"] for c in cs],
            "decode_call_ms": [c["decode_call_ms"] for c in cs],
        }
        summary[label]["median"] = {k: med(v) for k, v in summary[label].items()
                                    if isinstance(v, list)}
    ratios = {}
    for key in ("decode_ms_per_token", "prefill_ms", "decode_call_ms"):
        per_round = []
        for r in range(args.rounds):
            mine = [v for v, c in zip(summary["this"][key], calls["this"]) if c["round"] == r]
            theirs = [v for v, c in zip(summary["other"][key], calls["other"])
                      if c["round"] == r]
            per_round.append(statistics.mean(mine) / statistics.mean(theirs))
        ratios[key] = {"per_round": per_round, "median": med(per_round)}
    summary["ratio_this_over_other"] = ratios
    a, b = calls["this"][0]["tokens"], calls["other"][0]["tokens"]
    summary["token_agreement"] = sum(x == y for x, y in zip(a, b)) / len(a)
    for label in ("other", "this"):
        m = summary[label]["median"]
        print(f"{label}: median decode_ms_per_token={m['decode_ms_per_token']:.4f} "
              f"prefill_ms={m['prefill_ms']:.3f} total_ms={m['total_ms']:.3f} "
              f"decode_call_ms={m['decode_call_ms']:.5f} [{card}]", flush=True)
    print("this / other, median of per-round ratios: "
          + " ".join(f"{k}={v['median']:.4f}" for k, v in ratios.items())
          + f"; greedy token agreement {summary['token_agreement']:.4f} [{card}]",
          flush=True)
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
