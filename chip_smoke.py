#!/usr/bin/env python3
"""Smoke run of torchgpipe_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failure exits non-zero):

1. device: card name and power limit (nvidia-smi); TF32 off.
2. build: every CUDA kernel under torchgpipe_tpu_torch/csrc/ with nvcc.
3. flash_fwd against its plain PyTorch version on the card.
4. flash_decode against its plain PyTorch version on the card.
5. slice: greedy ``generate`` at Llama-3-8B width (random weights from a
   seed, 32 layers, batch 4, prompt 1024, 128 new tokens), with the
   kernels' launch counts read around that one call, prefill logits of
   the kernel path against the plain path, and the generated tokens
   against a teacher-forced full forward.
6. profile: device time by kernel and idle share, prefill and decode.

Then one JSON line per kernel (time, launches, bound, plain and library
yardsticks), the card line, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
# bf16 attention output: the kernel rounds P to bf16 before P @ V (one
# bf16 rounding, 2^-9 relative, of each weight of an average of V rows
# with |v| < ~5) and rounds O once; the plain version rounds O once.  The
# two differ by at most ~2 bf16 ulps of |o| < 5: 2 * 2^-8 * 4 = 3.1e-2.
FWD_TOL = 3.2e-2
# LSE is float32 from the same scores (bf16 x bf16 products are exact in
# f32; only summation order differs): ~1e-6 relative of lse ~ 10.
LSE_TOL = 2e-3
# Decode output is float32 on both sides from identical bf16 values; only
# summation order and the fast exp (<= 2 ulp) differ over <= 1152 terms,
# ~1e-5 relative of |o| < 5.
DECODE_TOL = 2e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fwd_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs attended, for the FLOP count."""
    if not causal:
        return s * s
    return sum(min(i + 1, window or i + 1) for i in range(s))


def phase_fwd(torch, tfa, card, gqa_sdpa):
    cases = [
        ("main", 4, 32, 8, 1024, None),
        ("window256", 4, 32, 8, 1024, 256),
        ("ragged1000", 4, 32, 8, 1000, None),
        ("long12288", 1, 4, 1, 12288, None),
    ]
    rows = {}
    for name, b, h, g, s, window in cases:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(b, s, h, 128, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, 128, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, 128, generator=gen, device="cuda").bfloat16()
        o = tfa.flash_attention(q, k, v, window=window)
        ro = tfa.flash_attention_reference(q, k, v, window=window)
        # LSE, the tight check at long s, through the kernel's (o, lse) entry.
        _, lse = tfa._flash_fwd(q, k, v, True, 128 ** -0.5, window)
        _, rlse = tfa._reference_fwd(q, k, v, True, 128 ** -0.5, window)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lerr = (lse - rlse).abs().max().item()
        if not (err <= FWD_TOL and lerr <= LSE_TOL):
            fail(f"flash_fwd {name}: max abs err {err} (tol {FWD_TOL}), "
                 f"lse err {lerr} (tol {LSE_TOL})")
        ms = time_ms(torch, lambda: tfa.flash_attention(q, k, v, window=window), 10)
        plain_ms = time_ms(
            torch, lambda: tfa.flash_attention_reference(q, k, v, window=window), 3, 1
        )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = None
        if window is None:
            lib_ms = time_ms(torch, lambda: gqa_sdpa(qt, kt, vt, True), 10)
        flops = 4.0 * b * h * 128 * fwd_pairs(s, True, window)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * b * h * s
        bms, by = bound(flops, nbytes)
        print(f"flash_fwd {name}: b={b} s={s} h={h} g={g} d=128 window={window} "
              f"max_abs_err={err:.3e} (tol {FWD_TOL}) lse_err={lerr:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms} "
              f"bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                          bound_ms=bms, bound_by=by)
    return rows


def phase_decode(torch, tfa, card, gqa_sdpa):
    b, nh, nkv, hd = 4, 32, 8, 128
    cases = [
        ("len1", 1, 0, None, 1152), ("len129", 1, 128, None, 1152),
        ("len1025", 1, 1024, None, 1152), ("len1152", 1, 1151, None, 1152),
        ("g4", 4, 1148, None, 1152), ("window256", 1, 1151, 256, 1152),
        ("ragged1000", 1, 999, None, 1000),
    ]
    worst = 0.0
    for name, g, pos0, window, max_len in cases:
        gen = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn(b, g, nh, hd, generator=gen, device="cuda").bfloat16()
        ck = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        cv = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        out = tfa.flash_decode_attention(q, ck, cv, pos0, window=window)
        ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        if not err <= DECODE_TOL:
            fail(f"flash_decode {name}: max abs err {err} (tol {DECODE_TOL})")
        print(f"flash_decode {name}: cache=[{b},{max_len},{nkv},{hd}] g={g} "
              f"pos0={pos0} window={window} max_abs_err={err:.3e} "
              f"(tol {DECODE_TOL}) [{card}]", flush=True)

    # Timing at the main path's shape: g=1 at live length 1088 (the middle
    # of the decode run's 1025..1152), cycling four caches (76 MB > the
    # 50 MB L2) as the 32 layers' caches cycle in the real loop.
    live, max_len = 1088, 1152
    gen = torch.Generator(device="cuda").manual_seed(3)
    sets = []
    for _ in range(4):
        q = torch.randn(b, 1, nh, hd, generator=gen, device="cuda").bfloat16()
        ck = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        cv = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        sets.append((q, ck, cv, q.transpose(1, 2), ck[:, :live].transpose(1, 2),
                     cv[:, :live].transpose(1, 2)))
    it = {"i": 0}

    def cycle(fn):
        def run():
            it["i"] = (it["i"] + 1) % 4
            fn(*sets[it["i"]])
        return run

    pos0 = live - 1
    ms = time_ms(torch, cycle(lambda q, ck, cv, *_: tfa.flash_decode_attention(
        q, ck, cv, pos0)), 40)
    plain_ms = time_ms(torch, cycle(lambda q, ck, cv, *_: tfa.flash_decode_reference(
        q, ck, cv, pos0)), 10)
    lib_ms = time_ms(torch, cycle(lambda q, ck, cv, qt, kt, vt: gqa_sdpa(
        qt, kt, vt, False)), 40)
    flops = 4.0 * b * nh * hd * live
    nbytes = 2.0 * (q.numel() + 2 * b * live * nkv * hd) + 4.0 * b * nh * hd
    bms, by = bound(flops, nbytes)
    print(f"flash_decode timing: cache=[{b},{max_len},{nkv},{hd}] live={live} g=1 "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
          f"bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
    return dict(err=worst, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound_ms=bms, bound_by=by)


def phase_slice(torch, tfa, tt, tg, card, seed: int, new_tokens: int = 128,
                reps: int = 3):
    cfg = tt.TransformerConfig(
        vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_ratio=5.25, dtype=torch.bfloat16,
    )
    b, s = 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = tt.llama(cfg, device="cuda", generator=gen)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: Llama-3-8B width, {n_params / 1e9:.3f}B params random from "
          f"seed {seed}, built in {time.perf_counter() - t0:.1f}s [{card}]", flush=True)

    tg.generate(cfg, model, prompt[:, :128], 2)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # Each generate call is split on the device clock by an event that its
    # own prefill records on return (no sync is added): prefill = start ->
    # mark, decode = mark -> end.  The first call is the counted main-path
    # run; the times are the median of `reps` calls.
    real_prefill, marks = tg.prefill, []

    def marked_prefill(*a, **kw):
        res = real_prefill(*a, **kw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return res

    tg.prefill = marked_prefill
    prefill_ms, decode_ms, total_ms = [], [], []
    try:
        for rep in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if rep == 0:
                tfa.flash_attention.launches = 0
                tfa.flash_decode_attention.launches = 0
            start.record()
            out = tg.generate(cfg, model, prompt, new_tokens)
            end.record()
            end.synchronize()
            if rep == 0:
                launches = {"flash_fwd": tfa.flash_attention.launches,
                            "flash_decode": tfa.flash_decode_attention.launches}
                first_out = out
            elif not torch.equal(out, first_out):
                fail("two greedy generate calls on one input disagree")
            prefill_ms.append(start.elapsed_time(marks[-1]))
            decode_ms.append(marks[-1].elapsed_time(end))
            total_ms.append(start.elapsed_time(end))
    finally:
        tg.prefill = real_prefill
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": cfg.n_layers, "flash_decode": cfg.n_layers * new_tokens}
    if launches != want:
        fail(f"kernel launches on the main path {launches}, expected {want}")
    if out.shape != (b, new_tokens) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        fail(f"generate returned {tuple(out.shape)} / ids out of range")

    l_kernel, _ = tg.prefill(cfg, model, prompt, s + new_tokens)
    l_plain, _ = tg.prefill(cfg, model, prompt, s + new_tokens, use_flash=False)
    torch.cuda.synchronize()
    if not (torch.isfinite(l_kernel).all() and torch.isfinite(l_plain).all()):
        fail("non-finite prefill logits")
    diff = (l_kernel - l_plain).abs()
    scale = l_plain.abs().max().item()
    rel = diff.max().item() / scale
    top_agree = (l_kernel.argmax(-1) == l_plain.argmax(-1)).float().mean().item()
    # Logit tolerance: every layer's attention output differs by ~2 bf16
    # ulps (FWD_TOL above) between the two paths; 32 pre-norm residual
    # layers add these perturbations, so the logits differ by ~sqrt(32) x
    # 2^-8 ~ 2e-2 of their scale.  Allow 5e-2 of max |logit|.
    if rel > 5e-2:
        fail(f"prefill logits kernel vs plain: max diff {diff.max().item()} "
             f"= {rel:.3e} of max |logit| {scale} (tol 5e-2)")

    # Teacher forcing: a full forward over prompt + generated tokens must
    # rank each generated token at (or, at a bf16 near-tie, next to) the
    # top.  With ~128k logits of scale ~1, the top two sit within one
    # bf16 ulp (2^-5 at |x| in [4, 8)) at a few percent of positions, and
    # the two paths' logits differ by up to ~0.1 (the prefill check
    # above), so the generated token's logit must be within 0.3 of the
    # forward's max everywhere, and be its argmax at >= 90% of positions.
    with torch.inference_mode():
        seq = torch.cat([prompt, out[:, :-1]], dim=1)
        logits = model(seq)[:, s - 1:].float()
        agree = (logits.argmax(-1) == out).float().mean().item()
        gap = (logits.max(-1).values
               - logits.gather(-1, out[..., None])[..., 0]).max().item()
    if agree < 0.9 or gap > 0.3:
        fail(f"greedy tokens vs the teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= 0.9 needed), worst logit gap {gap:.3f} (<= 0.3)")
    med = statistics.median
    per_tok = [d / new_tokens for d in decode_ms]
    print(f"slice: generate b={b} prompt={s} new={new_tokens}, median of {reps} calls "
          f"(each call: {[round(t, 3) for t in total_ms]} ms total, "
          f"{[round(t, 4) for t in per_tok]} decode ms/token): "
          f"total_ms={med(total_ms):.3f} prefill_ms={med(prefill_ms):.3f} "
          f"decode_ms_per_token={med(per_tok):.4f} "
          f"tokens_per_s={b * new_tokens * 1e3 / med(total_ms):.2f} "
          f"decode_tokens_per_s={b * 1e3 / med(per_tok):.2f} "
          f"max_memory_allocated={peak / 2**30:.2f}GiB launches={launches} "
          f"prefill_logit_max_diff={diff.max().item():.4f} rel={rel:.3e} "
          f"top1_agree={top_agree:.2f} teacher_forced_agree={agree:.4f} "
          f"teacher_forced_max_gap={gap:.4f} [{card}]", flush=True)
    return launches, (cfg, model, prompt)


def phase_profile(torch, tg, card, cfg, model, prompt, steps: int = 16) -> None:
    """Device time by kernel and the device's idle share (torch.profiler;
    one stream, so busy time is the sum of kernel times) for one prefill
    and for a ``steps``-token generate; decode per step is their
    difference over ``steps``."""
    from torch.profiler import ProfilerActivity, profile

    def run(label, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue  # CPU-side ops also carry their kernels' time
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = e.self_cuda_time_total
            if dev > 0:
                rows.append((dev, e.count, e.key))
        busy = sum(r[0] for r in rows) / 1e6
        rows.sort(reverse=True)
        print(f"profile {label}: wall={wall * 1e3:.1f}ms device_busy={busy * 1e3:.1f}ms "
              f"idle_share={1 - busy / wall:.3f} [{card}]", flush=True)
        for dev, count, key in rows[:12]:
            print(f"  {dev / 1e3:9.2f}ms {100 * dev / 1e6 / busy:5.1f}% "
                  f"x{count:<6d} {key[:90]}")
        return wall, busy

    s = prompt.shape[1]
    pw, pb = run("prefill", lambda: tg.prefill(cfg, model, prompt, s + steps))
    gw, gb = run(f"generate x{steps}", lambda: tg.generate(cfg, model, prompt, steps))
    print(f"profile decode (generate - prefill) per step: wall={(gw - pw) * 1e3 / steps:.2f}ms "
          f"device_busy={(gb - pb) * 1e3 / steps:.2f}ms "
          f"idle_share={1 - (gb - pb) / (gw - pw):.3f} [{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and prompt seed")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        from torchgpipe_tpu_torch.models import generation as tg
        from torchgpipe_tpu_torch.models import transformer as tt
        from torchgpipe_tpu_torch.ops import _build
        from torchgpipe_tpu_torch.ops import flash_attention as tfa
    except ImportError as e:
        fail(f"torchgpipe_tpu_torch is not importable beside this script ({e})")

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {sorted(_build.sources())} in {time.perf_counter() - t0:.1f}s "
          f"(per source {({k: round(v, 1) for k, v in secs.items()})})", flush=True)
    spills = [
        line.strip()
        for name in _build.sources()
        for line in open(_build.log_path(name))
        if "spill" in line and not line.strip().startswith("0 bytes stack")
    ]
    print(f"build: ptxas reports {len(spills)} kernel(s) with a stack frame or spills"
          + "".join(f"\n  {line}" for line in spills), flush=True)

    def gqa_sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    fwd = phase_fwd(torch, tfa, card, gqa_sdpa)
    dec = phase_decode(torch, tfa, card, gqa_sdpa)
    launches, (cfg, model, prompt) = phase_slice(torch, tfa, tt, tg, card, args.seed)
    phase_profile(torch, tg, card, cfg, model, prompt)

    src = "torchgpipe_tpu_torch/csrc/"
    ref = "torchgpipe_tpu/ops/flash_attention.py"
    main_fwd = fwd["main"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": f"{ref}:69", "also_replaces": f"{ref}:301",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["err"] for r in fwd.values()),
         "ms": main_fwd["ms"], "plain_ms": main_fwd["plain_ms"],
         "bound_ms": main_fwd["bound_ms"], "bound_by": main_fwd["bound_by"],
         "library_ms": main_fwd["lib_ms"]},
        {"name": "flash_decode", "route": "cuda", "source": src + "flash_decode.cu",
         "replaces": f"{ref}:1024", "launches": launches["flash_decode"],
         "max_abs_err": dec["err"], "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["lib_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
