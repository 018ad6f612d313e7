#!/usr/bin/env python3
"""Smoke run of torchgpipe_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failure exits non-zero):

1. device: card name and power limit (nvidia-smi); TF32 off.
2. build: every CUDA kernel under torchgpipe_tpu_torch/csrc/ with nvcc; any
   register spill that ptxas reports fails the run; each kernel's
   registers and shared memory from the ptxas report.  SASS check
   (``cuobjdump -sass``, from the CUDA toolkit): flash_fwd, flash_bwd_dq and
   flash_bwd_dkv must hold HGMMA (wgmma) and UTMALDG (TMA loads) in every
   instantiation, the decode partial kernel UTMALDG and (bf16 and int8
   caches) HMMA.
3. flash_fwd against its plain PyTorch version on the card at every
   shape the later phases launch it at (the generate prefill, b=4; the
   training micro-batch, b=2; the speculative phase's hd-64 draft and
   target prefills; the beam prefill), and at a window, a ragged and a
   long sequence; timed at each, through the wrapper and in device time.
4. flash_decode against its plain PyTorch version on the card, with a
   bf16 and an int8 cache, up to 20 query rows per kv head (speculative
   verification's g=5 at r=4), at phase 6c's own shapes too (the hd-64
   draft and the 20-row verify at b=1), each also with pos0 as a device
   int32 (bitwise equal to the host int), one call captured in a CUDA
   graph and replayed at three live lengths written to that scalar (each
   equal to the eager call), timed at the decode run's shape (live 1088)
   and at a long cache (live 32704), SDPA timed under each backend.
5. flash_bwd: flash_bwd_dq and flash_bwd_dkv against the plain backward,
   row by row, a probe that the check fails a backward with a tile left
   out, two flash_bwd_dkv and two flash_bwd_dq calls at the main shape
   bitwise equal; device time beside SDPA's backward under each backend.
6. slice: greedy ``generate`` at Llama-3-8B width (random weights from a
   seed, 32 layers, batch 4, prompt 1024, 128 new tokens), with the
   kernels' launch counts read around that one call, prefill logits of
   the kernel path against the plain path, and the generated tokens
   against a teacher-forced full forward.
6b. slice_int8: the same ``generate`` with ``kv_quant=True`` (the int8
   decode kernel): launch counts, times, cache bytes, the teacher-forced
   check, token agreement with phase 6 and the two caches' decode logits
   on phase 6's tokens.
6c. speculative: ``speculative_generate`` with phase 6's model as the
   target and a random benchmarks/llama_speed.py ``1b`` draft (batch 2,
   prompt 512, 64 new tokens, gamma 4, greedy): launch counts against
   ``SpecStats``, the teacher-forced check, agreement with ``generate``;
   then the target as its own draft (acceptance >= 0.8).
6d. beam: ``beam_search`` of one prompt with 4 beams, 32 tokens, and
   ``num_beams=1`` against greedy ``generate`` (equal).
7. profile: device time by kernel and idle share, prefill and decode,
   bf16 and int8 caches.
8. train: ``GPipe`` training at Llama-3-8B width (benchmarks/llama_speed.py
   ``pipeline-1``: 1 stage, batch 8, 4 micro-batches, seq 1024,
   checkpoint 'except_last'; random weights from the seed), one warm-up
   and three timed steps of ``value_and_grad`` plus an in-place SGD
   update, launch counts read around one step, the step-1 loss against
   the unpipelined model's, a falling loss, a profile of one step, and a
   3-stage schedule on one card against the 1-stage one at 4 blocks.

Each path's launch counts are set to 0 just before it runs and read just
after.  Then one JSON line per kernel (time, launches, bound, plain and
library yardsticks, the fastest SDPA backend by name; ``launches``
counts one generate call for the forward
and decode kernels, one ``generate(kv_quant=True)`` call for the int8
decode variant and one training step for the backward kernels; every
path's counts are in ``launches_by_path``), the card line, and the last
line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import time
import warnings

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 rate outside the tensor cores
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
# summation order and the fast exp (<= 2 ulp) differ, ~1e-7 x sqrt(terms)
# relative: ~1e-5 of |o| < 5 at 1152 keys, and at 32704 keys (the long
# timing shape) the output, an average of that many random V rows, is
# far smaller than 5.  For an int8 cache the plain version dequantizes
# each element where the kernel scales each score and each softmax weight
# (csrc/flash_decode.cu): one more f32 rounding per key, the same order.
DECODE_TOL = 2e-4
# bf16 gradients of the backward kernels against the plain float32
# backward rounded once, held row by row: for each (batch, position, head)
# row of d values, max |got - want| <= BWD_ROW_TOL * max |want| over that
# row, plus a floor.  Causal gradients span orders of magnitude across rows
# (the first keys' dK/dV collect every query's weight; dQ falls off along
# the sequence), so one tolerance per tensor would be as large as a typical
# row.  Within a row the kernel rounds P (for dV) and dS (for dQ, dK) to
# bf16 before its products (unit roundoff 2^-8; the term errors have mixed
# signs, so the sum's error is ~2^-8 of the row's typical entry, under 2^-8
# of its max), and each side rounds the output once (the two at most one
# bf16 ulp apart, 2^-7 of the entry): ~3 x 2^-8 of the row max at worst.
# 2^-6 = 4 x 2^-8, while one key or query tile left out of a row's loop
# moves it by far more (a quarter of a row's terms at a band of 256; the
# probe below checks that it fails).  The floor, 2^-9 of the median row
# max, covers rows that are zero in exact arithmetic (query 0's dQ: p = 1,
# dS = dP - delta = 0), where only float32 summation noise is left.
BWD_ROW_TOL = 2 ** -6
BWD_FLOOR = 2 ** -9


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# Kernel entries of the `kernels` line -> (library, kernel functions).
KERNEL_FUNCS = {
    "flash_fwd": ("flash_fwd", ("flash_fwd_kernel",)),
    "flash_decode": ("flash_decode", ("flash_decode_kernel", "flash_decode_merge")),
    "flash_decode_int8": ("flash_decode", ("flash_decode_kernel", "flash_decode_merge")),
    "flash_bwd_dq": ("flash_bwd", ("flash_bwd_dq_kernel",)),
    "flash_bwd_dkv": ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel")),
}
# The redesigned kernels and the instructions their SASS must hold: HGMMA
# (wgmma) and UTMALDG (TMA tensor loads); the decode kernel's scores run on
# mma.sync (HMMA) for bf16 and int8 caches (an f32 cache keeps f32
# products on the CUDA cores: no HMMA there).  SASS_COUNT: instantiations
# each must show (d = 64 and 128; decode: four query/cache type pairs x two
# head dims x four row counts).
SASS_REQUIRED = {"flash_fwd": {"flash_fwd_kernel": ("HGMMA", "UTMALDG")},
                 "flash_bwd": {"flash_bwd_dkv_kernel": ("HGMMA", "UTMALDG"),
                               "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG")},
                 "flash_decode": {"flash_decode_kernel": ("UTMALDG", "HMMA")}}
SASS_COUNT = {"flash_fwd_kernel": 2, "flash_bwd_dkv_kernel": 2, "flash_bwd_dq_kernel": 2,
              "flash_decode_kernel": 32}


def ptxas_report(build):
    """One pass over every build's ptxas report.  Returns the kernels whose
    report shows spills, those with only a stack frame, the number of
    reports read, and ``{function: {"registers", "smem_static_bytes"}}``
    of the kernels line's functions (max over a function's instantiations;
    registers are the count at launch, which warp-specialised kernels
    rebalance with setmaxnreg).  ptxas writes "Compiling entry function
    '<mangled>'", then "Function properties for <mangled>" with "N bytes
    stack frame, S bytes spill stores, L bytes spill loads", then "Used R
    registers, ... B bytes smem"."""
    names = sorted({f for _, fs in KERNEL_FUNCS.values() for f in fs}, key=len, reverse=True)
    spills, frames, reports, resources = [], [], 0, {}
    for lib in build.sources():
        fn = ""
        for line in open(build.log_path(lib)):
            m = re.search(r"(?:Compiling entry function '|Function properties for )"
                          r"([^'\s]+)", line)
            if m:
                fn = m[1]
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                reports += 1
                if any(int(x) for x in m.groups()):
                    (spills if int(m[2]) or int(m[3]) else frames).append(
                        f"{fn}: {line.strip()}")
                continue
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            kernel = next((n for n in names if f"{len(n)}{n}" in fn), None)
            if m and kernel:
                r = resources.setdefault(kernel, {"registers": 0, "smem_static_bytes": 0})
                r["registers"] = max(r["registers"], int(m[1]))
                r["smem_static_bytes"] = max(r["smem_static_bytes"], int(m[2] or 0))
    return spills, frames, reports, resources


def sass_check(build):
    """Fail unless every instantiation of the redesigned kernels issues
    the instructions of SASS_REQUIRED (``cuobjdump -sass`` of the built
    libraries), and each kernel shows SASS_COUNT instantiations."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        fail("cuobjdump not found (the CUDA toolkit's; needed for the SASS check)")
    seen = {}
    for lib, funcs in SASS_REQUIRED.items():
        sass = subprocess.run([tool, "-sass", build.so_path(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        for section in re.split(r"\n\s*Function : ", sass)[1:]:
            name = section.split("\n", 1)[0].strip()
            f = next((f for f in funcs if f"{len(f)}{f}" in name), None)
            if f is None:
                continue
            ops = funcs[f]
            if f == "flash_decode_kernel" and "flash_decode_kernelIff" in name:
                ops = tuple(op for op in ops if op != "HMMA")   # f32 cache: f32 products
            counts = {op: len(re.findall(rf"\b{op}\b", section)) for op in ops}
            if not all(counts.values()):
                fail(f"SASS of {name}: {counts} ({' and '.join(ops)} required)")
            seen.setdefault(f, []).append(counts)
    short = {f: len(seen.get(f, [])) for f, n in SASS_COUNT.items() if len(seen.get(f, [])) != n}
    if short:
        fail(f"SASS check found {short} instantiations, expected {SASS_COUNT}")
    print("build: SASS " + "; ".join(
        f"{f} x{len(c)} (fewest per instantiation: "
        f"{ {op: min(x[op] for x in c if op in x) for op in c[0]} })"
        for f, c in seen.items()), flush=True)


def smem_dynamic(build):
    """Dynamic shared memory per block at d=128 of the redesigned kernels
    (the decode kernel's at its main-path instantiation: bf16 cache, up to
    4 rows a group), from their C interfaces."""
    import ctypes

    fwd = build.function("flash_fwd", "tgt_flash_fwd_smem_bytes", [ctypes.c_int])
    dq = build.function("flash_bwd", "tgt_flash_bwd_dq_smem_bytes", [ctypes.c_int])
    dkv = build.function("flash_bwd", "tgt_flash_bwd_dkv_smem_bytes", [ctypes.c_int])
    dec = build.function("flash_decode", "tgt_flash_decode_smem_bytes", [])
    return {"flash_fwd": fwd(128), "flash_bwd_dq": dq(128), "flash_bwd_dkv": dkv(128),
            "flash_decode": dec(), "flash_decode_int8": dec()}


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


def device_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``: the CUDA kernels' own time summed
    by torch.profiler over ``reps`` calls.  Unlike ``time_ms`` it leaves
    out the host's time between launches, which at decode sizes is
    longer than the kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if dev is None else dev
    return total / 1e3 / reps


def sdpa_backends(torch, sets, causal: bool, reps: int, dout=None):
    """The library yardstick: device time of one
    ``scaled_dot_product_attention`` call (``sets``: ``(q [b, h, s, d], k,
    v [b, g, s_k, d])`` tuples, cycled call by call as the kernel's timing
    cycles its caches; with ``dout``, the backward of the first set: the
    three gradients) under each backend that accepts it, through
    ``torch.nn.attention.sdpa_kernel``.  FLASH_ATTENTION gets K/V expanded
    to ``h`` heads outside the timed region; the others take GQA as it is,
    or expanded where they refuse it.  Returns ``({backend: ms or None},
    fastest backend, its ms)``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    r = sets[0][0].shape[1] // sets[0][1].shape[1]
    expanded = [(q, k.repeat_interleave(r, 1), v.repeat_interleave(r, 1)) for q, k, v in sets]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # a refused backend warns, then raises
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
            out[name] = None
            forms = [(expanded, False)] if name == "FLASH_ATTENTION" else [(sets, True),
                                                                           (expanded, False)]
            for form, gqa in forms:
                it = {"i": 0}
                try:
                    with sdpa_kernel(getattr(SDPBackend, name)):
                        if dout is None:
                            def call():
                                it["i"] = (it["i"] + 1) % len(form)
                                q, k, v = form[it["i"]]
                                F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                               enable_gqa=gqa)
                        else:
                            qg, kg, vg = (t.detach().requires_grad_() for t in form[0])
                            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                               enable_gqa=gqa)

                            def call():
                                torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
                        call()
                        torch.cuda.synchronize()
                        # The profiler has read a backend's kernels as 0 ms
                        # once: measure again, else leave the backend out.
                        for _ in range(2):
                            ms = device_ms(torch, call, reps)
                            if ms > 0:
                                out[name] = ms
                                break
                    break
                except RuntimeError:
                    continue
    del expanded
    done = {n: t for n, t in out.items() if t is not None}
    if not done:
        fail("no SDPA backend took the yardstick call")
    best = min(done, key=done.get)
    return out, best, done[best]


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fwd_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs attended, for the FLOP count."""
    if not causal:
        return s * s
    return sum(min(i + 1, window or i + 1) for i in range(s))


def phase_fwd(torch, tfa, card, gqa_sdpa):
    """flash_fwd against its plain version at every shape the generation
    and training phases give it; timed at each."""
    # (name, b, h, g, s, window, d)
    cases = [
        ("main", 4, 32, 8, 1024, None, 128),
        # One micro-batch of phase 8's step (224 launches a step).
        ("train_microbatch", 2, 32, 8, 1024, None, 128),
        ("window256", 4, 32, 8, 1024, 256, 128),
        ("ragged1000", 4, 32, 8, 1000, None, 128),
        # Phase 6c's prefills: the 1b draft's (hd 64) and the target's
        # (also the self-draft's); phase 6d's one prompt.
        ("spec_draft_d64", 2, 32, 8, 512, None, 64),
        ("spec_target", 2, 32, 8, 512, None, 128),
        ("beam_prefill", 1, 32, 8, 1024, None, 128),
        ("long12288", 1, 4, 1, 12288, None, 128),
    ]
    rows = {}
    for name, b, h, g, s, window, d in cases:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        o = tfa.flash_attention(q, k, v, window=window)
        ro = tfa.flash_attention_reference(q, k, v, window=window)
        # LSE, the tight check at long s, through the kernel's (o, lse) entry.
        _, lse = tfa._flash_fwd(q, k, v, True, d ** -0.5, window)
        _, rlse = tfa._reference_fwd(q, k, v, True, d ** -0.5, window)
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
        lib_ms = lib_dev = None
        if window is None:
            lib_ms = time_ms(torch, lambda: gqa_sdpa(qt, kt, vt, True), 10)
            lib_dev = device_ms(torch, lambda: gqa_sdpa(qt, kt, vt, True), 10)
        # Device time apart from the host's: at the short prefills the
        # wrapper's host time per call can exceed the kernel's.
        dev = device_ms(torch, lambda: tfa.flash_attention(q, k, v, window=window), 10)
        flops = 4.0 * b * h * d * fwd_pairs(s, True, window)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * b * h * s
        bms, by = bound(flops, nbytes)
        print(f"flash_fwd {name}: b={b} s={s} h={h} g={g} d={d} window={window} "
              f"max_abs_err={err:.3e} (tol {FWD_TOL}) lse_err={lerr:.3e} (tol {LSE_TOL}) "
              f"ms={ms:.4f} (device {dev:.4f}) plain_ms={plain_ms:.4f} sdpa_ms={lib_ms} "
              f"(device {lib_dev}) bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
        rows[name] = dict(err=err, ms=ms, device_ms=dev, plain_ms=plain_ms, lib_ms=lib_ms,
                          lib_device_ms=lib_dev, bound_ms=bms, bound_by=by)
    return rows


def int8_cache(torch, tg, gen, b, L, nkv, hd):
    """An int8 cache and its float32 [b, nkv, L] scales: random bf16 rows
    quantized as ``generate(kv_quant=True)`` quantizes them."""
    rows = torch.randn(b, L, nkv, hd, generator=gen, device="cuda").bfloat16()
    q, sc = tg._quant_rows(rows)
    return q, sc.transpose(1, 2).contiguous()


def decode_bound(b, nh, nkv, hd, live, g, cache_bytes_per_elem, scales):
    """The decode kernel's least time: the live K/V prefix read once (and
    the two f32 scale rows of an int8 cache), q read and the f32 output
    written once, against HBM; its f32 products against the f32 rate."""
    flops = 4.0 * b * g * nh * hd * live
    nbytes = (2.0 * b * live * nkv * hd * cache_bytes_per_elem
              + (2.0 * b * nkv * live * 4 if scales else 0.0)
              + 2.0 * b * g * nh * hd + 4.0 * b * g * nh * hd)
    return bound(flops, nbytes, PEAK_F32_FLOPS)


def decode_graph_replay(torch, tfa, tg, card, worst) -> None:
    """One decode call at the generate cell's shape (cache [4, 1152, 8,
    128], g=1) captured in a CUDA graph with a device pos0, replayed after
    writing three live lengths into it: each replay must equal the eager
    host-int call bitwise and the plain version within DECODE_TOL."""
    for kind in ("bf16", "int8"):
        gen = torch.Generator(device="cuda").manual_seed(5)
        q = torch.randn(4, 1, 32, 128, generator=gen, device="cuda").bfloat16()
        if kind == "int8":
            ck, ks = int8_cache(torch, tg, gen, 4, 1152, 8, 128)
            cv, vs = int8_cache(torch, tg, gen, 4, 1152, 8, 128)
            kw = dict(k_scale=ks, v_scale=vs)
        else:
            ck, cv = (torch.randn(4, 1152, 8, 128, generator=gen, device="cuda").bfloat16()
                      for _ in range(2))
            kw = {}
        pos = torch.tensor(1024, dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tfa.flash_decode_attention(q, ck, cv, pos, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tfa.flash_decode_attention(q, ck, cv, pos, **kw)
        errs = []
        for p in (1087, 1024, 1151):
            pos.fill_(p)
            graph.replay()
            want = tfa.flash_decode_attention(q, ck, cv, p, **kw)
            ref = tfa.flash_decode_reference(q, ck, cv, p, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            worst[kind] = max(worst[kind], err)
            if not torch.equal(out, want) or not err <= DECODE_TOL:
                fail(f"flash_decode {kind} graph replay at pos0={p}: equal to the eager "
                     f"call {torch.equal(out, want)}, max abs err {err} (tol {DECODE_TOL})")
            errs.append(err)
        print(f"flash_decode {kind} graph replay: one capture, pos0 1087/1024/1151 written "
              f"to the device scalar, each equal to the eager call bitwise, max abs err "
              f"{max(errs):.3e} (tol {DECODE_TOL}) [{card}]", flush=True)
        del graph


def phase_decode(torch, tfa, tg, card):
    """The decode kernel against its plain version, bf16 and int8 caches,
    at every shape the generation phases give it (the speculative phase's
    hd-64 draft decode and 20-row verify at b=1 included); timed at the
    main path's shape and at a long cache."""
    # (name, b, nh, nkv, hd, g, pos0, window, max_len)
    llama = (4, 32, 8, 128)
    cases = [
        ("len1", *llama, 1, 0, None, 1152), ("len129", *llama, 1, 128, None, 1152),
        ("len1025", *llama, 1, 1024, None, 1152),
        ("len1152", *llama, 1, 1151, None, 1152),
        ("g4", *llama, 4, 1148, None, 1152),
        ("window256", *llama, 1, 1151, 256, 1152),
        ("ragged1000", *llama, 1, 999, None, 1000),
        ("g5_rows20", *llama, 5, 1100, None, 1152),
        ("g5_rows20_window256", *llama, 5, 900, 256, 1152),
        # Phase 6c (prompt 512, 64 new, gamma 4: buffers of 512 + 64 + 5 =
        # 581 positions, one row at a time): the 1b draft's decode reads
        # 513..581 live keys at hd 64; the target's verify, 5 queries (20
        # rows per kv head) at 517..581.
        ("draft_hd64_len513", 1, 32, 8, 64, 1, 512, None, 581),
        ("draft_hd64_len548", 1, 32, 8, 64, 1, 547, None, 581),
        ("draft_hd64_len581", 1, 32, 8, 64, 1, 580, None, 581),
        ("verify_rows20_len517", 1, 32, 8, 128, 5, 512, None, 581),
        ("verify_rows20_len581", 1, 32, 8, 128, 5, 576, None, 581),
    ]
    worst = {"bf16": 0.0, "int8": 0.0}
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        for name, b, nh, nkv, hd, g, pos0, window, max_len in cases:
            gen = torch.Generator(device="cuda").manual_seed(2)
            q = torch.randn(b, g, nh, hd, generator=gen, device="cuda").bfloat16()
            if quant:
                ck, ks = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
                cv, vs = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
                kw = dict(window=window, k_scale=ks, v_scale=vs)
            else:
                ck = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
                cv = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
                kw = dict(window=window)
            out = tfa.flash_decode_attention(q, ck, cv, pos0, **kw)
            # The same call with pos0 as a device scalar: the same bits.
            dev = tfa.flash_decode_attention(
                q, ck, cv, torch.tensor(pos0, dtype=torch.int32, device="cuda"), **kw)
            ref = tfa.flash_decode_reference(q, ck, cv, pos0, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            worst[kind] = max(worst[kind], err)
            if not err <= DECODE_TOL:
                fail(f"flash_decode {kind} {name}: max abs err {err} (tol {DECODE_TOL})")
            if not torch.equal(out, dev):
                fail(f"flash_decode {kind} {name}: a device pos0 gives other bits than "
                     f"the host int")
            print(f"flash_decode {kind} {name}: cache=[{b},{max_len},{nkv},{hd}] g={g} "
                  f"rows/kv head={g * nh // nkv} pos0={pos0} window={window} "
                  f"max_abs_err={err:.3e} (tol {DECODE_TOL}); device pos0 bitwise equal "
                  f"[{card}]", flush=True)
    decode_graph_replay(torch, tfa, tg, card, worst)

    # Timing at the main path's shape: g=1 at live length 1088 (the middle
    # of the decode run's 1025..1152), cycling four caches (76 MB of bf16 >
    # the 50 MB L2) as the 32 layers' caches cycle in the real loop; and at
    # a long cache (live 32704 of 32768: 537 MB of bf16, past L2 alone).
    b, nh, nkv, hd = llama
    timing = {}
    for shape, live, max_len, nsets in (("main", 1088, 1152, 4),
                                        ("long", 32704, 32768, 1)):
        gen = torch.Generator(device="cuda").manual_seed(3)
        sets = []
        for _ in range(nsets):
            q = torch.randn(b, 1, nh, hd, generator=gen, device="cuda").bfloat16()
            ck = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
            cv = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
            qk, ks = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            qv, vs = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            sets.append(dict(q=q, ck=ck, cv=cv, qk=qk, qv=qv, ks=ks, vs=vs,
                             qt=q.transpose(1, 2), kt=ck[:, :live].transpose(1, 2),
                             vt=cv[:, :live].transpose(1, 2)))
        it = {"i": 0}

        def cycle(fn):
            def run():
                it["i"] = (it["i"] + 1) % nsets
                fn(sets[it["i"]])
            return run

        pos0 = live - 1
        d = sets[0]
        for kind, ck, cv, sc in (
            ("bf16", d["ck"], d["cv"], {}),
            ("int8", d["qk"], d["qv"], dict(k_scale=d["ks"], v_scale=d["vs"])),
        ):
            got = tfa.flash_decode_attention(d["q"], ck, cv, pos0, **sc)
            want = tfa.flash_decode_reference(d["q"], ck, cv, pos0, **sc)
            err = (got - want).abs().max().item()
            worst[kind] = max(worst[kind], err)
            if not err <= DECODE_TOL:
                fail(f"flash_decode {kind} timing shape {shape}: max abs err {err} "
                     f"(tol {DECODE_TOL})")
            print(f"flash_decode {kind} timing shape {shape}: live={live} "
                  f"max_abs_err={err:.3e} (tol {DECODE_TOL}) [{card}]", flush=True)
        reps = 40 if shape == "main" else 10
        plain_reps = 3 if shape == "long" else 10
        bf16 = cycle(lambda d: tfa.flash_decode_attention(d["q"], d["ck"], d["cv"], pos0))
        int8 = cycle(lambda d: tfa.flash_decode_attention(
            d["q"], d["qk"], d["qv"], pos0, k_scale=d["ks"], v_scale=d["vs"]))
        ms, q8_ms = device_ms(torch, bf16, reps), device_ms(torch, int8, reps)
        call_ms, q8_call_ms = time_ms(torch, bf16, reps), time_ms(torch, int8, reps)
        plain_ms = device_ms(torch, cycle(lambda d: tfa.flash_decode_reference(
            d["q"], d["ck"], d["cv"], pos0)), plain_reps, 1)
        q8_plain_ms = device_ms(torch, cycle(lambda d: tfa.flash_decode_reference(
            d["q"], d["qk"], d["qv"], pos0, k_scale=d["ks"], v_scale=d["vs"])),
            plain_reps, 1)
        lib_all, lib_best, lib_ms = sdpa_backends(
            torch, [(d["qt"], d["kt"], d["vt"]) for d in sets], False, reps)
        bms, by = decode_bound(b, nh, nkv, hd, live, 1, 2, False)
        q8_bms, q8_by = decode_bound(b, nh, nkv, hd, live, 1, 1, True)
        print(f"flash_decode timing {shape}: cache=[{b},{max_len},{nkv},{hd}] live={live} "
              f"g=1, device time per call (wrapper call time on the host clock): "
              f"bf16: ms={ms:.4f} ({call_ms:.4f}) plain_ms={plain_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} ({lib_best}; by backend {lib_all}) "
              f"bound_ms={bms:.4f} ({by}); int8: ms={q8_ms:.4f} "
              f"({q8_call_ms:.4f}) plain_ms={q8_plain_ms:.4f} bound_ms={q8_bms:.4f} "
              f"({q8_by}) library_ms=None (no PyTorch call reads an int8 cache) "
              f"[{card}]", flush=True)
        timing[shape] = {
            "bf16": dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         lib_backend=lib_best, lib_by_backend=lib_all,
                         bound_ms=bms, bound_by=by),
            "int8": dict(ms=q8_ms, call_ms=q8_call_ms, plain_ms=q8_plain_ms, lib_ms=None,
                         lib_backend=None, lib_by_backend=None,
                         bound_ms=q8_bms, bound_by=q8_by),
        }
        del sets
        torch.cuda.empty_cache()
    return worst, timing


def attn_bytes(b, s, h, g, d, *, reads, writes):
    """Bytes an attention pass must move: ``reads``/``writes`` name the
    bf16 [b, s, h|g, d] tensors (q/o/do: h heads; k/v/dk/dv: g heads) plus
    two float32 [b*h, s] rows (lse, delta) when ``reads`` has them."""
    size = {"q": h, "o": h, "do": h, "dq": h, "k": g, "v": g, "dk": g, "dv": g}
    n = sum(2.0 * b * s * size[t] * d for t in reads + writes if t in size)
    n += sum(4.0 * b * h * s for t in reads if t in ("lse", "delta"))
    return n


def bwd_rows(got, want):
    """Row-by-row check of a gradient ``[b, n, heads, d]`` against the
    plain one: ``(worst err/tol over rows, median row max |want|, floor)``;
    the check passes when the first is <= 1."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1)
    typical = scale.median().item()
    floor = BWD_FLOOR * typical
    return (err / (BWD_ROW_TOL * scale + floor)).max().item(), typical, floor


def phase_bwd(torch, tfa, card):
    """The two backward kernels against the plain backward on the card;
    timed at the training shape (one micro-batch of pipeline-1)."""
    cases = [
        ("main", 2, 32, 8, 1024, 128, None),
        ("window256", 2, 32, 8, 1024, 128, 256),
        ("ragged1000", 2, 32, 8, 1000, 128, None),
        ("d64", 2, 32, 8, 1024, 64, None),
        ("long12288", 1, 4, 1, 12288, 128, None),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    timing = {}
    for name, b, h, g, s, d, window in cases:
        gen = torch.Generator(device="cuda").manual_seed(4)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        scale = d ** -0.5
        kw = dict(causal=True, sm_scale=scale, window=window)
        o, lse = tfa._flash_fwd(q, k, v, True, scale, window)
        delta = tfa._delta(do, o)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        ref = tfa._reference_bwd(q, k, v, o, lse, do, True, scale, window)
        torch.cuda.synchronize()
        if name == "main":
            # No atomics: a second call gives the same bits.
            dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
            dq2 = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail("flash_bwd_dkv: two calls on one input differ")
            if not torch.equal(dq, dq2):
                fail("flash_bwd_dq: two calls on one input differ")
            print(f"flash_bwd main: two flash_bwd_dkv calls and two flash_bwd_dq calls "
                  f"bitwise equal [{card}]", flush=True)
            del dk2, dv2, dq2
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            ratio, typical, floor = bwd_rows(got, want)
            err = (got.float() - want.float()).abs().max().item()
            if not ratio <= 1.0:
                fail(f"flash_bwd {name} {gname}: a row's error is {ratio:.3f} x its "
                     f"tolerance (2^-6 of the row's max |{gname}| + {floor:.3e})")
            errs[gname] = (err, ratio, typical, floor)
        worst["dq"] = max(worst["dq"], errs["dq"][0])
        worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        print(f"flash_bwd {name}: b={b} s={s} h={h} g={g} d={d} window={window} "
              + " ".join(f"{n}: max_abs_err={e:.3e} worst_row_err/tol={r:.3f} "
                         f"(tol 2^-6 of the row max + {f:.2e}; median row max "
                         f"|{n}| {t:.3e})" for n, (e, r, t, f) in errs.items())
              + f" [{card}]", flush=True)
        # The check's reach: the plain backward with one tile's worth of
        # terms left out of the loops must fail it.  At the main shape the
        # last query tile is dropped from dK/dV (its dO rows zeroed, delta
        # recomputed); under the window, the oldest 64 keys of every
        # query's band (the same LSE and delta over a band of 192).
        if name in ("main", "window256"):
            if window is None:
                do0 = do.clone()
                do0[:, -64:] = 0
                cut = tfa._reference_grads(q, k, v, do0, lse, tfa._delta(do0, o),
                                           True, scale, None)
                probes = (("dk", dk, cut[1]), ("dv", dv, cut[2]))
            else:
                cut = tfa._reference_grads(q, k, v, do, lse, delta, True, scale,
                                           window - 64)
                probes = zip(("dq", "dk", "dv"), (dq, dk, dv), cut)
            seen = {n: bwd_rows(got, want)[0] for n, got, want in probes}
            if not all(r > 1.0 for r in seen.values()):
                fail(f"flash_bwd {name}: the row check passes a backward with a "
                     f"tile left out (worst row err/tol {seen})")
            print(f"flash_bwd {name}: a tile left out of the loops fails the check: "
                  f"worst row err/tol {({n: round(r, 2) for n, r in seen.items()})}",
                  flush=True)
            del cut
        if name not in ("main", "long12288"):
            continue
        dq_call = lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)  # noqa: E731
        dkv_call = lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)  # noqa: E731
        call_dq, call_dkv = time_ms(torch, dq_call, 10), time_ms(torch, dkv_call, 10)
        ms_dq, ms_dkv = device_ms(torch, dq_call, 10), device_ms(torch, dkv_call, 10)
        plain_ms = time_ms(torch, lambda: tfa._reference_grads(
            q, k, v, do, lse, delta, True, scale, window), 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_all, lib_best, lib_ms = sdpa_backends(torch, [(qt, kt, vt)], True, 10,
                                                  dout=do.transpose(1, 2))
        pairs = fwd_pairs(s, True, window)
        reads = ["q", "k", "v", "do", "lse", "delta"]
        bq = bound(6.0 * b * h * d * pairs, attn_bytes(b, s, h, g, d, reads=reads,
                                                       writes=["dq"]))
        bkv = bound(8.0 * b * h * d * pairs, attn_bytes(b, s, h, g, d, reads=reads,
                                                        writes=["dk", "dv"]))
        print(f"flash_bwd timing {name}, device time per call (wrapper call time on "
              f"the host clock): dq_ms={ms_dq:.4f} ({call_dq:.4f}; bound {bq[0]:.4f}, "
              f"{bq[1]}) dkv_ms={ms_dkv:.4f} ({call_dkv:.4f}; bound {bkv[0]:.4f}, "
              f"{bkv[1]}) plain_ms={plain_ms:.4f} (all three grads) "
              f"sdpa_bwd_ms={lib_ms:.4f} ({lib_best}; all three grads; by backend "
              f"{lib_all}) [{card}]", flush=True)
        timing[name] = dict(dq=(ms_dq, bq, call_dq), dkv=(ms_dkv, bkv, call_dkv),
                            plain_ms=plain_ms, lib_ms=lib_ms, lib_backend=lib_best,
                            lib_by_backend=lib_all)
    return worst, timing


LLAMA3_8B = dict(vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 mlp_ratio=5.25)
# benchmarks/llama_speed.py preset "1b": the speculative phase's draft.
LLAMA_1B = dict(vocab=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                mlp_ratio=6.0)


def timed_generate(torch, tfa, tg, cfg, model, prompt, new_tokens, reps, **kw):
    """``reps`` calls of ``generate(cfg, model, prompt, new_tokens, **kw)``
    after a short warm-up, each split on the device clock by an event that
    its own prefill records on return (no sync is added): prefill = start
    -> mark, decode = mark -> end.  The first call is the counted run:
    every launch count is 0 just before it and read just after.  Returns
    ``(out, cache, launches, times)`` with the first call's tokens and
    cache and per-call ``prefill_ms``/``decode_ms``/``total_ms`` lists."""
    tg.generate(cfg, model, prompt[:, :128], 2, **kw)   # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real_prefill, marks = tg.prefill, []

    def marked_prefill(*a, **pkw):
        res = real_prefill(*a, **pkw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return res

    tg.prefill = marked_prefill
    times = {"prefill_ms": [], "decode_ms": [], "total_ms": []}
    try:
        for rep in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if rep == 0:
                tfa.reset_launches()
            start.record()
            out, cache = tg.generate(cfg, model, prompt, new_tokens,
                                     return_state=True, **kw)
            end.record()
            end.synchronize()
            if rep == 0:
                launches = kernel_launches(tfa)
                first = (out, cache)
            elif not torch.equal(out, first[0]):
                fail("two greedy generate calls on one input disagree")
            times["prefill_ms"].append(start.elapsed_time(marks[-1]))
            times["decode_ms"].append(marks[-1].elapsed_time(end))
            times["total_ms"].append(start.elapsed_time(end))
    finally:
        tg.prefill = real_prefill
    times["peak"] = torch.cuda.max_memory_allocated()
    return first[0], first[1], launches, times


def kernel_launches(tfa):
    """Every kernel's launch count, the decode kernel's per variant."""
    return {"flash_fwd": tfa.flash_attention.launches,
            "flash_decode": tfa.flash_decode_attention.launches,
            "flash_decode_int8": tfa.flash_decode_attention.launches_int8,
            "flash_bwd_dq": tfa.flash_bwd_dq.launches,
            "flash_bwd_dkv": tfa.flash_bwd_dkv.launches}


def expect_launches(got, want, what):
    full = {k: 0 for k in got}
    full.update(want)
    if got != full:
        fail(f"kernel launches in {what}: {got}, expected {full}")


def teacher_forced(torch, model, prompt, out):
    """A full forward over prompt + generated tokens: the share of
    positions where the generated token is the forward's argmax, and the
    worst gap between the forward's max logit and the generated token's."""
    s = prompt.shape[1]
    with torch.inference_mode():
        seq = torch.cat([prompt, out[:, :-1]], dim=1)
        logits = model(seq)[:, s - 1:].float()
        agree = (logits.argmax(-1) == out).float().mean().item()
        gap = (logits.max(-1).values
               - logits.gather(-1, out[..., None])[..., 0]).max().item()
    return agree, gap


# Teacher forcing: a full forward over prompt + generated tokens must rank
# each generated token at (or, at a bf16 near-tie, next to) the top.  With
# ~128k logits of scale ~1, the top two sit within one bf16 ulp (2^-5 at
# |x| in [4, 8)) at a few percent of positions, and the two paths' logits
# differ by up to ~0.1 (the prefill check of phase 6), so the generated
# token's logit must be within 0.3 of the forward's max everywhere, and be
# its argmax at >= 90% of positions.
TF_AGREE, TF_GAP = 0.9, 0.3
# The int8 cache (phase 6b) moves each cached K/V element by up to half a
# quantization step, amax/254 of its (position, head) row: RMS ~0.7% of
# the row's RMS (amax ~3 RMS over 128 dims; step/sqrt(12)), ~6x the bf16
# cache's own rounding (2^-9/sqrt(3) ~ 0.11%).  Averaged over the keys an
# attention output reads, it moves each layer's output about as much as
# the two bf16 ulps that already separate the paths, so the decode
# logits move by up to ~2x phase 6's 0.1: the gap allowance grows by
# 0.2 to 0.5, and the share of positions within that margin of a tie
# doubles, so the argmax agreement floor falls from 0.9 to 0.85.
TF_AGREE_INT8, TF_GAP_INT8 = 0.85, 0.5


def llama_cfg(tt, torch, preset):
    return tt.TransformerConfig(**preset, dtype=torch.bfloat16)


def phase_slice(torch, tfa, tt, tg, card, seed: int, new_tokens: int = 128,
                reps: int = 3):
    cfg = llama_cfg(tt, torch, LLAMA3_8B)
    b, s = 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = tt.llama(cfg, device="cuda", generator=gen)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: Llama-3-8B width, {n_params / 1e9:.3f}B params random from "
          f"seed {seed}, built in {time.perf_counter() - t0:.1f}s [{card}]", flush=True)

    out, _, launches, times = timed_generate(torch, tfa, tg, cfg, model, prompt,
                                             new_tokens, reps)
    expect_launches(launches, {"flash_fwd": cfg.n_layers,
                               "flash_decode": cfg.n_layers * new_tokens}, "generate")
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
    agree, gap = teacher_forced(torch, model, prompt, out)
    if agree < TF_AGREE or gap > TF_GAP:
        fail(f"greedy tokens vs the teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= {TF_AGREE} needed), worst logit gap {gap:.3f} "
             f"(<= {TF_GAP})")
    print(f"slice: generate b={b} prompt={s} new={new_tokens}, "
          + generate_summary(times, b, new_tokens, reps)
          + f" launches={launches} prefill_logit_max_diff={diff.max().item():.4f} "
          f"rel={rel:.3e} top1_agree={top_agree:.2f} teacher_forced_agree={agree:.4f} "
          f"teacher_forced_max_gap={gap:.4f} [{card}]", flush=True)
    return launches, (cfg, model, prompt, out)


def generate_summary(times, b, new_tokens, reps):
    med = statistics.median
    per_tok = [d / new_tokens for d in times["decode_ms"]]
    return (f"median of {reps} calls (each call: "
            f"{[round(t, 3) for t in times['total_ms']]} ms total, "
            f"{[round(t, 4) for t in per_tok]} decode ms/token): "
            f"total_ms={med(times['total_ms']):.3f} "
            f"prefill_ms={med(times['prefill_ms']):.3f} "
            f"decode_ms_per_token={med(per_tok):.4f} "
            f"tokens_per_s={b * new_tokens * 1e3 / med(times['total_ms']):.2f} "
            f"decode_tokens_per_s={b * 1e3 / med(per_tok):.2f} "
            f"max_memory_allocated={times['peak'] / 2**30:.2f}GiB")


def cache_bytes(cache):
    bufs = [t for name in ("k", "v", "k_scale", "v_scale")
            for t in getattr(cache, name, [])]
    return sum(t.numel() * t.element_size() for t in bufs)


def phase_slice_int8(torch, tfa, tg, card, cfg, model, prompt, bf16_out,
                     new_tokens: int = 128, reps: int = 2):
    """``generate(kv_quant=True)`` on phase 6's model and prompt: launch
    counts, times, cache bytes, the teacher-forced check, token agreement
    with the bf16-cache run, and the decode logits of the two caches
    teacher-forced on the bf16 run's tokens."""
    b, s = prompt.shape
    out, cache, launches, times = timed_generate(
        torch, tfa, tg, cfg, model, prompt, new_tokens, reps, kv_quant=True)
    expect_launches(launches, {"flash_fwd": cfg.n_layers,
                               "flash_decode_int8": cfg.n_layers * new_tokens},
                    "generate(kv_quant=True)")
    if not isinstance(cache, tg.QuantKVCache) or cache.k[0].dtype != torch.int8:
        fail("generate(kv_quant=True) did not keep an int8 cache")
    q_bytes = cache_bytes(cache)
    s_bytes = sum(t.numel() * 4 for t in cache.k_scale + cache.v_scale)
    bf16_bytes = 2 * cfg.n_layers * b * (s + new_tokens) * cfg.kv_heads * cfg.head_dim * 2
    agree, gap = teacher_forced(torch, model, prompt, out)
    same = (out == bf16_out).float().mean().item()
    first_diff = (out != bf16_out).int().argmax(-1).tolist()

    # The int8 cache's effect on the decode logits: the bf16 run's first
    # 16 tokens teacher-forced through a bf16 and an int8 cache.
    embed_p, block_p, head_p = tg._split_params(cfg, model)
    dev_max = 0.0
    with torch.inference_mode():
        caches = [tg.prefill(cfg, model, prompt, s + 16)[1],
                  tg.prefill(cfg, model, prompt, s + 16, kv_quant=True)[1]]
        for t in range(16):
            logits = []
            for c in caches:
                x = tg._embed(cfg, embed_p, bf16_out[:, t:t + 1])
                x, _ = tg._decode_step(cfg, block_p, x, c)
                logits.append(tg._logits(cfg, head_p, x)[:, 0])
            dev_max = max(dev_max, (logits[0] - logits[1]).abs().max().item())
    if agree < TF_AGREE_INT8 or gap > TF_GAP_INT8:
        fail(f"int8-cache tokens vs the teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= {TF_AGREE_INT8} needed), worst logit gap {gap:.3f} "
             f"(<= {TF_GAP_INT8})")
    print(f"slice_int8: generate(kv_quant=True) b={b} prompt={s} new={new_tokens}, "
          + generate_summary(times, b, new_tokens, reps)
          + f" launches={launches} cache_bytes={q_bytes} (int8 K/V "
          f"{(q_bytes - s_bytes) / 1e9:.4f} GB + scales {s_bytes / 1e6:.2f} MB; a bf16 "
          f"cache: {bf16_bytes / 1e9:.4f} GB) teacher_forced_agree={agree:.4f} "
          f"teacher_forced_max_gap={gap:.4f} token_agreement_with_bf16_cache={same:.4f} "
          f"first_divergence_per_row={first_diff} decode_logit_max_diff_int8_vs_bf16"
          f"(16 steps)={dev_max:.4f} [{card}]", flush=True)
    return launches, times


def phase_speculative(torch, tfa, tt, tg, card, seed, cfg, model, prompt,
                      new_tokens: int = 64, gamma: int = 4):
    """``speculative_generate`` with phase 6's model as the target and a
    random ``1b`` draft (b=2, prompt 512, gamma 4, greedy): launch counts
    against ``SpecStats``, the teacher-forced check, agreement with greedy
    ``generate``; then the target as its own draft, whose acceptance must
    be >= 0.8."""
    prompt = prompt[:2, :512].contiguous()
    b, s = prompt.shape
    dcfg = llama_cfg(tt, torch, LLAMA_1B)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    draft = tt.llama(dcfg, device="cuda", generator=gen)
    tg.speculative_generate(cfg, model, dcfg, draft, prompt[:, :64], 6, gamma=gamma)
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.perf_counter()
    out, stats = tg.speculative_generate(cfg, model, dcfg, draft, prompt, new_tokens,
                                         gamma=gamma, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(tfa)
    rounds = int(stats.rounds.sum())
    # Per round and row: gamma + 1 draft decode steps through the draft's
    # blocks (hd 64, r rows) and one verify chunk through the target's
    # blocks (hd 128, (gamma + 1) * r = 20 rows).
    want = {"flash_fwd": cfg.n_layers + dcfg.n_layers,
            "flash_decode": rounds * ((gamma + 1) * dcfg.n_layers + cfg.n_layers)}
    expect_launches(launches, want, "speculative_generate")
    if (stats.drafted != gamma * stats.rounds).any() or \
            int((stats.rounds + stats.accepted).min()) < new_tokens - 1:
        fail(f"SpecStats inconsistent: {stats}")
    agree, gap = teacher_forced(torch, model, prompt, out)
    if agree < TF_AGREE or gap > TF_GAP:
        fail(f"speculative tokens vs the teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= {TF_AGREE} needed), worst logit gap {gap:.3f} "
             f"(<= {TF_GAP})")
    greedy = tg.generate(cfg, model, prompt, new_tokens)
    same = (out == greedy).float().mean().item()
    acc_rate = int(stats.accepted.sum()) / int(stats.drafted.sum())
    print(f"speculative: target Llama-3-8B width, draft 1b ({dcfg.dim} dim, "
          f"{dcfg.n_layers} layers, hd {dcfg.head_dim}, random from seed {seed + 2}), "
          f"b={b} prompt={s} new={new_tokens} gamma={gamma}: wall_s={wall:.3f} "
          f"tokens_per_s={b * new_tokens / wall:.2f} rounds={stats.rounds.tolist()} "
          f"accepted={stats.accepted.tolist()} acceptance={acc_rate:.4f} "
          f"launches={launches} (expected {want}) teacher_forced_agree={agree:.4f} "
          f"teacher_forced_max_gap={gap:.4f} token_agreement_with_generate={same:.4f} "
          f"[{card}]", flush=True)

    # Self-draft: every proposal is the target's own greedy token, so a
    # rejection happens only where the 20-row verify read and the one-row
    # decode read resolve a near-tie differently.  Phase 6 measured the
    # decode path against the full forward at 0.963 argmax agreement: ~4%
    # of positions are near-ties that two summation orders split.  With
    # that rejection rate per proposal, a round of 4 accepts ~3.8 (0.94 of
    # drafted); 0.8 leaves room for 4x as many near-tie flips.
    t0 = time.perf_counter()
    sout, sstats = tg.speculative_generate(cfg, model, cfg, model, prompt, new_tokens,
                                           gamma=gamma, return_stats=True)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    self_rate = int(sstats.accepted.sum()) / int(sstats.drafted.sum())
    self_same = (sout == greedy).float().mean().item()
    if self_rate < 0.8:
        fail(f"self-draft acceptance {self_rate:.3f} < 0.8 ({sstats})")
    print(f"speculative self-draft: wall_s={swall:.3f} "
          f"tokens_per_s={b * new_tokens / swall:.2f} rounds={sstats.rounds.tolist()} "
          f"accepted={sstats.accepted.tolist()} acceptance={self_rate:.4f} (>= 0.8) "
          f"token_agreement_with_generate={self_same:.4f} [{card}]", flush=True)
    del draft
    torch.cuda.empty_cache()
    return launches


def phase_beam(torch, tfa, tg, card, cfg, model, prompt, new_tokens: int = 32,
               beams: int = 4):
    """``beam_search`` of one prompt with 4 beams (launch counts, finite
    score), and ``num_beams=1`` against greedy ``generate``: equal, since
    no kernel on the path uses atomics."""
    prompt = prompt[:1].contiguous()
    tfa.reset_launches()
    t0 = time.perf_counter()
    out, lp = tg.beam_search(cfg, model, prompt, new_tokens, num_beams=beams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(tfa)
    # The seed decode and one per step but the last: new_tokens - 1.
    expect_launches(launches, {"flash_fwd": cfg.n_layers,
                               "flash_decode": cfg.n_layers * (new_tokens - 1)},
                    "beam_search")
    if out.shape != (1, new_tokens) or not torch.isfinite(lp).all():
        fail(f"beam_search returned {tuple(out.shape)}, log-prob {lp}")
    one, _ = tg.beam_search(cfg, model, prompt, new_tokens, num_beams=1)
    greedy = tg.generate(cfg, model, prompt, new_tokens)
    if not torch.equal(one, greedy):
        fail(f"beam_search(num_beams=1) != greedy generate: {one} vs {greedy}")
    print(f"beam: b=1 prompt={prompt.shape[1]} beams={beams} new={new_tokens}: "
          f"wall_s={wall:.3f} log_prob={lp.item():.4f} launches={launches}; "
          f"num_beams=1 equals greedy generate on all {new_tokens} tokens; "
          f"best beam shares {(out == greedy).float().mean().item():.3f} of its "
          f"tokens with greedy [{card}]", flush=True)
    return launches


def profile(torch, card, label, fn, top: int = 12):
    """Device time by kernel and the device's idle share of one call of
    ``fn`` (torch.profiler; one stream, so busy time is the sum of kernel
    times).  Returns ``(wall_s, busy_s)``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    for dev, count, key in rows[:top]:
        print(f"  {dev / 1e3:9.2f}ms {100 * dev / 1e6 / busy:5.1f}% "
              f"x{count:<6d} {key[:90]}")
    return wall, busy


def phase_profile(torch, tg, card, cfg, model, prompt, steps: int = 16) -> None:
    """Profiles of one prefill and of a ``steps``-token generate, with a
    bf16 and with an int8 cache; decode per step is their difference over
    ``steps``."""
    s = prompt.shape[1]
    for kv_quant in (False, True):
        tag = " kv_quant" if kv_quant else ""
        pw, pb = profile(torch, card, f"prefill{tag}", lambda: tg.prefill(
            cfg, model, prompt, s + steps, kv_quant=kv_quant))
        gw, gb = profile(torch, card, f"generate{tag} x{steps}", lambda: tg.generate(
            cfg, model, prompt, steps, kv_quant=kv_quant))
        print(f"profile decode{tag} (generate - prefill) per step: "
              f"wall={(gw - pw) * 1e3 / steps:.2f}ms "
              f"device_busy={(gb - pb) * 1e3 / steps:.2f}ms "
              f"idle_share={1 - (gb - pb) / (gw - pw):.3f} [{card}]", flush=True)


def causal_lm_loss(tt):
    """benchmarks/llama_speed.py's objective: predict token t+1 from the
    prefix <= t (``cross_entropy`` does not shift)."""
    def loss(out, tokens):
        return tt.cross_entropy(out[:, :-1, :], tokens[:, 1:])
    return loss


# SGD rate for the bf16 weights.  run_speed's 1e-4 moves no bf16 weight:
# a projection weight of |w| ~ dim^-1/2 = 0.0156 has a bf16 ulp of 2^-13
# = 1.2e-4, so an update survives rounding only when lr * |g| > 6e-5.
# The train phase prints the step-1 gradients; on an H100 (seed 0) their
# RMS was 3.1e-5 (lm head) to 2.6e-4 (block 0) and their max 1.2e-3 to
# 1.3e-2.  lr = 1.0 moves the larger ones (9% of the head's weights
# changed in step 1) and keeps the typical block update near 2% of |w|.
TRAIN_LR = 1.0


def phase_train(torch, tfa, tt, card, seed: int, steps: int = 3):
    """pipeline-1 at Llama-3-8B width: GPipe(llama, [34], chunks=4,
    checkpoint='except_last'), batch 8, seq 1024, SGD in place."""
    import numpy as np

    from torchgpipe_tpu_torch import GPipe

    cfg = llama_cfg(tt, torch, LLAMA3_8B)
    b, s, chunks = 8, 1024, 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    llama = tt.llama(cfg, device="cuda", generator=gen)
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    ).cuda()
    loss_fn = causal_lm_loss(tt)
    with torch.no_grad():
        plain_loss = loss_fn(llama(tokens), tokens).item()
    model = GPipe(llama, [len(llama)], chunks=chunks, checkpoint="except_last")
    params = list(model.parameters())

    @torch.no_grad()
    def sgd():
        # In place: the reference rebinds its parameter tree (p - lr * g),
        # which would hold a second 16 GB copy of the weights on the card.
        for p in params:
            p.add_(p.grad, alpha=-TRAIN_LR)

    def step(stats=None):
        loss, _, _ = model.value_and_grad(tokens, tokens, loss_fn)
        if stats is not None:
            for name, layer, key in (("head.w", -1, "w"), ("table", 0, "table"),
                                     ("block0.wq", 1, "wq"),
                                     ("block0.w_down", 1, "w_down")):
                g = getattr(model[layer], key).grad.float()
                stats[name] = (g.abs().max().item(), g.square().mean().sqrt().item())
        sgd()
        return loss

    head_w = model[-1].w
    head_before = head_w.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    grad_stats = {}
    losses = [step(grad_stats)]
    torch.cuda.synchronize()
    launches = kernel_launches(tfa)
    n_blocks = cfg.n_layers
    expect_launches(launches, {"flash_fwd": n_blocks * (chunks + chunks - 1),
                               "flash_bwd_dq": n_blocks * chunks,
                               "flash_bwd_dkv": n_blocks * chunks}, "one training step")
    moved = (head_w != head_before).float().mean().item()
    del head_before

    step_ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step())
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    # Step-1 loss against one unpipelined forward on the same weights:
    # the two differ only where cuBLAS picks another summation order for
    # 2048-row micro-batch GEMMs than for the 8192-row batch.  The slice
    # phase's prefill check shows bf16 logits at this width moving by ~0.1
    # when attention sums in another order; per-token NLLs
    # move by at most that, with independent signs over 8184 tokens, so
    # the mean moves by ~1e-3; 2e-2 absolute leaves room for a drift.
    if not all(np.isfinite(losses)) or abs(losses[0] - plain_loss) > 2e-2:
        fail(f"step-1 loss {losses[0]} vs unpipelined {plain_loss} (tol 2e-2)")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on the fixed batch: {losses}")

    n_matmul = sum(p.numel() for n, p in llama.named_parameters() if p.ndim == 2
                   and not n.endswith("table"))
    tok = b * s
    pairs = fwd_pairs(s, True, None)
    flops = 6.0 * n_matmul * tok + 12.0 * n_blocks * b * cfg.n_heads * cfg.head_dim * pairs
    med = statistics.median(step_ms)
    print(f"train: pipeline-1 Llama-3-8B width ({sum(p.numel() for p in params) / 1e9:.3f}B "
          f"params, seed {seed}), batch {b} x seq {s}, chunks {chunks}, except_last, "
          f"SGD lr {TRAIN_LR}: losses {[round(x, 5) for x in losses]} "
          f"(unpipelined step-1 loss {plain_loss:.5f}), head weights moved by step 1: "
          f"{moved:.4f}; step-1 grad (max, rms): "
          + ", ".join(f"{k} ({a:.3e}, {r:.3e})" for k, (a, r) in grad_stats.items())
          + f" [{card}]", flush=True)
    print(f"train: step_ms={med:.3f} (steps {[round(t, 3) for t in step_ms]}) "
          f"tokens_per_s={tok * 1e3 / med:.1f} model_flops_per_step={flops:.4e} "
          f"mfu={flops / (med * 1e-3) / PEAK_BF16_FLOPS:.4f} of 989 TF/s "
          f"max_memory_allocated={peak / 2**30:.2f}GiB launches/step={launches} "
          f"[{card}]", flush=True)
    profile(torch, card, "train step", step, top=16)
    del model, llama, params
    torch.cuda.empty_cache()
    return launches, med


def phase_stages(torch, tt, card, seed: int):
    """A 4-block model at full width: GPipe balance [2, 2, 2] (three
    stages on one card) against [6]: loss and gradients equal up to the
    order of the float atomics in the embedding-gradient scatter."""
    import numpy as np

    from torchgpipe_tpu_torch import GPipe

    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=4))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    layers = list(tt.llama(cfg, device="cuda", generator=gen))
    tokens = torch.from_numpy(
        np.random.default_rng(seed + 1).integers(0, cfg.vocab, (8, 1024))
    ).cuda()
    loss_fn = causal_lm_loss(tt)
    results = []
    for balance in ([6], [2, 2, 2]):
        model = GPipe(layers, balance, chunks=4, checkpoint="except_last")
        loss, grads, _ = model.value_and_grad(tokens, tokens, loss_fn)
        flat = [g.clone() for stage in grads for layer in stage for g in layer.values()]
        results.append((loss.item(), flat))
    (l1, g1), (l3, g3) = results
    bitwise = sum(torch.equal(a, c) for a, c in zip(g1, g3))
    worst = max(((a.float() - c.float()).abs().max() / c.float().abs().max()).item()
                for a, c in zip(g1, g3))
    # The stage boundaries change no operation, so the loss matches to
    # float32 rounding of the mean (1e-6 relative) and each gradient to one
    # bf16 ulp of its largest entry (2^-7 of it), the room the scatter's
    # atomics need.
    if abs(l1 - l3) > 1e-6 * abs(l1) or worst > 2 ** -7:
        fail(f"3-stage vs 1-stage: loss {l3} vs {l1}, worst grad diff {worst:.3e} "
             "of max |grad| (tol 2^-7)")
    print(f"stages: 4 blocks, balance [2, 2, 2] vs [6]: loss {l3:.6f} vs {l1:.6f}, "
          f"{bitwise}/{len(g1)} grad leaves bitwise equal, worst diff {worst:.3e} of "
          f"max |grad| (tol 2^-7) [{card}]", flush=True)


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
    spills, frames, reports, resources = ptxas_report(_build)
    print(f"build: ptxas reports {len(spills)} of {reports} kernel(s) with spills "
          f"and {len(frames)} more with a stack frame"
          + "".join(f"\n  {line}" for line in spills + frames), flush=True)
    if spills or not reports:
        fail(f"ptxas spills registers in {len(spills)} kernel(s) "
             f"({reports} reports read)")
    missing = {f for _, fs in KERNEL_FUNCS.values() for f in fs} - set(resources)
    if missing:
        fail(f"no ptxas register report for {sorted(missing)}")
    print("build: ptxas registers / static smem per kernel function (max over "
          "instantiations): " + ", ".join(f"{k} {r['registers']} / {r['smem_static_bytes']}"
                                          for k, r in sorted(resources.items())), flush=True)
    sass_check(_build)

    def gqa_sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    fwd = phase_fwd(torch, tfa, card, gqa_sdpa)
    dec_err, dec = phase_decode(torch, tfa, tg, card)
    bwd_err, bwd = phase_bwd(torch, tfa, card)
    launches, (cfg, model, prompt, out) = phase_slice(torch, tfa, tt, tg, card, args.seed)
    int8_launches, _ = phase_slice_int8(torch, tfa, tg, card, cfg, model, prompt, out)
    spec_launches = phase_speculative(torch, tfa, tt, tg, card, args.seed, cfg, model,
                                      prompt)
    beam_launches = phase_beam(torch, tfa, tg, card, cfg, model, prompt)
    phase_profile(torch, tg, card, cfg, model, prompt)
    del cfg, model, prompt, out   # the generation model's 16 GB before training
    torch.cuda.empty_cache()
    train_launches, _ = phase_train(torch, tfa, tt, card, args.seed)
    phase_stages(torch, tt, card, args.seed)

    src = "torchgpipe_tpu_torch/csrc/"
    ref = "torchgpipe_tpu/ops/flash_attention.py"
    main_fwd = fwd["main"]

    paths = {"generate": launches, "generate_int8": int8_launches,
             "speculative": spec_launches, "beam_search": beam_launches}

    def decode_entry(name, kind, main_path):
        t, long = dec["main"][kind], dec["long"][kind]
        return {"name": name, "route": "cuda", "source": src + "flash_decode.cu",
                "replaces": f"{ref}:1024", "launches": paths[main_path][name],
                "launches_by_path": {p: n[name] for p, n in paths.items()},
                "max_abs_err": dec_err[kind], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["lib_ms"], "library_backend": t["lib_backend"],
                "library_ms_by_backend": t["lib_by_backend"], "call_ms": t["call_ms"],
                "long_cache": {"ms": long["ms"], "plain_ms": long["plain_ms"],
                               "bound_ms": long["bound_ms"],
                               "library_ms": long["lib_ms"],
                               "library_backend": long["lib_backend"],
                               "library_ms_by_backend": long["lib_by_backend"]}}

    def bwd_entry(name, key, line, also):
        main_bwd, long = bwd["main"], bwd["long12288"]
        ms, (bms, by), call = main_bwd[key]
        return {"name": name, "route": "cuda", "source": src + "flash_bwd.cu",
                "replaces": f"{ref}:{line}", "also_replaces": f"{ref}:{also}",
                "launches": train_launches[name], "max_abs_err": bwd_err[key],
                "ms": ms, "call_ms": call, "plain_ms": main_bwd["plain_ms"],
                "bound_ms": bms, "bound_by": by, "library_ms": main_bwd["lib_ms"],
                "library_backend": main_bwd["lib_backend"],
                "library_ms_by_backend": main_bwd["lib_by_backend"],
                "long_shape": {"ms": long[key][0], "call_ms": long[key][2],
                               "plain_ms": long["plain_ms"], "bound_ms": long[key][1][0],
                               "library_ms": long["lib_ms"],
                               "library_backend": long["lib_backend"],
                               "library_ms_by_backend": long["lib_by_backend"]}}

    def shape_entry(row):
        return {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")} | {
            "library_ms": row["lib_ms"], "library_device_ms": row["lib_device_ms"]}

    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": f"{ref}:69", "also_replaces": f"{ref}:301",
         "launches": launches["flash_fwd"],
         "launches_by_path": dict({p: n["flash_fwd"] for p, n in paths.items()},
                                  train_step=train_launches["flash_fwd"]),
         "max_abs_err": max(r["err"] for r in fwd.values()),
         "ms": main_fwd["ms"], "plain_ms": main_fwd["plain_ms"],
         "bound_ms": main_fwd["bound_ms"], "bound_by": main_fwd["bound_by"],
         "library_ms": main_fwd["lib_ms"],
         "device_ms": main_fwd["device_ms"], "library_device_ms": main_fwd["lib_device_ms"],
         "train_microbatch": shape_entry(fwd["train_microbatch"]),
         "long_shape": shape_entry(fwd["long12288"]),
         "path_shapes": {n: shape_entry(fwd[n])
                         for n in ("spec_draft_d64", "spec_target", "beam_prefill")}},
        decode_entry("flash_decode", "bf16", "generate"),
        decode_entry("flash_decode_int8", "int8", "generate_int8"),
        bwd_entry("flash_bwd_dq", "dq", 538, 411),
        bwd_entry("flash_bwd_dkv", "dkv", 592, 468),
    ]
    smem = smem_dynamic(_build)
    for k in kernels:
        k["ptxas"] = {f: resources[f] for f in KERNEL_FUNCS[k["name"]][1]}
        if k["name"] in smem:
            k["smem_dynamic_bytes"] = smem[k["name"]]
    for k in kernels[-2:]:
        k["bitwise_repeat"] = True   # phase 5 fails otherwise
    for k in kernels[1:3]:
        k["device_pos0_bitwise"] = k["graph_replay"] = True   # phase 4 fails otherwise
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
