#!/usr/bin/env python3
"""Smoke run of torchgpipe_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases 3,9b,mixtral_moe]

Phases, one line each (any failure exits non-zero).  ``--phases`` runs
the phases it names (by number or name, with the phases whose results
they need) and prints no kernels line; by default every phase runs:

1. device: card name and power limit (nvidia-smi); TF32 off.
2. build: every CUDA kernel under torchgpipe_tpu_torch/csrc/ with nvcc; any
   register spill that ptxas reports fails the run; each kernel's
   registers and shared memory from the ptxas report.  SASS check
   (``cuobjdump -sass``, from the CUDA toolkit): flash_fwd, flash_bwd_dq,
   flash_bwd_dkv and the 3xTF32 forward, dQ and dK/dV must hold HGMMA
   (wgmma) and UTMALDG (TMA loads) in every instantiation, the decode
   partial kernel UTMALDG and (bf16 and int8 caches) HMMA.
3. flash_fwd against its plain PyTorch version on the card at every
   shape the later phases launch it at (the generate prefill, b=4; the
   training micro-batch, b=2; the speculative phase's hd-64 draft and
   target prefills; the beam prefill; phase 18's ViT-L/16 micro-batch
   without a causal mask, MHA at d=64; phase 21's GPT-2 XL prefill), and
   at a window, a ragged and a long sequence, each case with its own
   ``causal``; timed at each, through the wrapper and in device time,
   beside SDPA with the same mask.  Two rows run the head dims the kernel
   takes zero-padded (``ops.flash_attention.attention_route``): d=80
   (Phi-2's head, b=4 s=2048 h=g=32) and d=32 (the reference's
   benchmarks/llama_megastep.py config), each one flash_fwd launch and
   no other kernel a call.
4. flash_decode against its plain PyTorch version on the card, with a
   bf16 and an int8 cache, up to 20 query rows per kv head (speculative
   verification's g=5 at r=4), at phase 6c's own shapes too (the hd-64
   draft and the 20-row verify at b=1), each also with pos0 as a device
   int32 (bitwise equal to the host int), one call captured in a CUDA
   graph and replayed at three live lengths written to that scalar (each
   equal to the eager call), timed at the decode run's shape (live 1088)
   and at a long cache (live 32704), SDPA timed under each backend; and
   at phase 21's GPT-2 XL shapes (MHA, 25 kv heads, one query row each,
   hd 64, live 513-576), timed at live 544.
5. flash_bwd: flash_bwd_dq and flash_bwd_dkv against the plain backward,
   row by row, a probe that the check fails a backward with a tile left
   out, two flash_bwd_dkv and two flash_bwd_dq calls at the main shape
   bitwise equal; device time beside SDPA's backward under each backend,
   at the main, the long and phase 18's non-causal ViT-L/16 shape, and
   phase 3's padded d=80 and d=32 rows (the kernels at the padded dim,
   the gradients sliced back and held to the unpadded plain backward).
5b. simt: float32 attention and decode at head dims other than 64 and
   128.  The float32 forward of csrc/flash_fwd_tf32.cu (3xTF32 wgmma)
   with the backward of csrc/flash_bwd_tf32.cu (its prologue bitwise
   equal to its plain version, dQ and dK/dV on 3xTF32 wgmma, bitwise
   equal on a second call) against the plain versions (row by row), and
   flash_decode (csrc/flash_decode.cu at the real head
   dim: bf16, float32 and int8 caches at head dims 32, 80 and 96, a
   device pos0 bitwise equal to the host int), at the path's shapes and
   at edges, timed beside SDPA; flash_simt's CUDA-core forward, dQ, dK/dV
   and decode at shapes TMA cannot map (d=18, an int8 cache at d=24), and
   timed at the path's shapes as the earlier kernels; then the path: a float32
   Llama at the "1b" widths and a bf16 Llama at Phi-2's attention widths
   (d=80), each cut to 2 blocks, take a GPipe step (the float32 one a
   second time under the profiler: device busy time, the attention
   kernels' part of it) and ``generate`` 4 x 512 + 32 tokens, their launches gated (float32: the 3xTF32 forward and
   backward and flash_decode's float32 instantiation; d=80: the
   tensor-core kernels zero-padded and flash_decode at d=80; no CUDA-core
   kernel), tokens teacher-forced.
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
9. serving (run after 7, before 8 frees phase 6's model): the
   continuous-batching ``serving.Engine`` on that model (8 slots, max_len 1152, prefill ladder (8, 64, 256), greedy), its
   programs captured CUDA graphs: graph replays against the eager bodies
   (4 requests, 32 tokens; tokens and cache bytes bitwise equal), decode
   step time at 8 occupied slots both ways and profiles of 8 steady
   steps, the dense cache read's cost per layer (beside the flash_decode
   kernel at one shared frontier), a seeded churn trace (24 requests,
   prompts 32-1024, 16-128 new tokens, 8 at the start and 2 every 16
   engine steps, one cancelled mid-decode, one drain and resume) that
   must add no capture to the warm-up's one per program (one request per
   bucket, served alone), every finished stream held to
   the teacher-forced check (an int8 pool's 4 streams to the int8
   limits), zero launches of the hand-written kernels, and a
   ``{"serving": ...}`` line (tokens/s, TTFT/TPOT p50/p99, occupancy,
   steps by program, capture time, pool bytes, peak memory).
9b. int8_weights (after 9, on phase 6's model): ``quantize_params_int8``,
   its bytes against the bf16 model's 16.06 GB, ``generate`` at phase 6's
   shape (launches, ms/token beside phase 6's, the teacher-forced check
   at the int8 cache's limits, agreement with phase 6's tokens) and the
   Engine's captured decode step at 8 slots beside phase 9's.
8. train: ``GPipe`` training at Llama-3-8B width (benchmarks/llama_speed.py
   ``pipeline-1``: 1 stage, batch 8, 4 micro-batches, seq 1024,
   checkpoint 'except_last'; random weights from the seed), one warm-up
   and three timed steps of ``make_train_step`` with ``torch.optim.SGD``,
   launch counts read around one step, the step-1 loss against the
   unpipelined model's, a falling loss, the peak memory within 1 GiB of
   the stateless SGD's, a profile of one step, and a 3-stage schedule on
   one card against the 1-stage one at 4 blocks.
10. train_1f1b: the same width cut to 2 blocks (``CUT_BLOCKS``), batch 8, seq 1024, 8
   micro-batches, checkpoint 'never', 4 stages on one card at the balance
   ``balance_by_flops`` counts: one fill-drain step and one 1F1B step
   (``loss_reduction='mean'``) from the same weights, their losses and
   gradients against each other, 1F1B's peak memory below fill-drain's,
   launch counts against 2 x 8 per kernel, then three ``make_train_step``
   steps of AdamW under 1F1B with a falling loss.
11. resnet101: ResNet-101 at full width (1000 classes, 224x224, float32),
   benchmarks/resnet101_speed.py's ``pipeline-2`` row (2 stages, batch
   512, 16 micro-batches, 'except_last', deferred batch norm) at the
   balance ``balance_by_time`` measures: one step there and one at a
   forced 3-stage cut inside bottlenecks (skips crossing stages) against
   the 1-stage pipeline (loss, gradients, BatchNorm buffers), bn1's
   deferred commit against the whole batch's statistics, three SGD steps
   (lr 0.1, momentum 0.9) with a falling loss, step ms, samples/s, peak
   memory, a profile, and 0 launches of every hand-written kernel.
12. train_graph: phase 10's model (2 blocks, batch 8, seq 1024, 8
   micro-batches, its 4-stage balance) under 'except_last' as
   ``GPipe(fused=True)``: two eager SGD steps, the fused warm-up and the
   first replay from the same weights, all bitwise equal (loss, every
   .grad, every updated parameter); one capture; replay and eager step
   ms and idle shares; the flash kernels' launches per replay from a
   profile (the wrappers count no launch recorded in a capture) equal to
   the eager step's; then ``make_train_step(AdamW(capturable=True),
   megastep=4)`` replayed with a NaN loss at inner step 1 against four
   replayed single steps with step 1 skipped (finite flags, losses,
   parameters, moments and step counts bitwise).
13. precision: (a) phase 11's ResNet-101 row with
   ``compute_dtype=bfloat16`` over float32 masters against the float32
   step from the same weights (loss within 1e-2; gradients finite
   float32, their distance printed); a witness at batch 64: plain
   float32 against the policy at ``float64`` (1e-3 over all leaves,
   1e-2 the worst leaf) and bf16 1e2 times farther; three SGD steps
   eagerly and as one CUDA graph from the same state, bitwise equal
   step by step; ms, samples/s, peak, profiles; (b) phase 12's Llama
   with float32 masters, bf16 compute, ``fused=True``: the fused
   warm-up's launches and a replay's (CUDA-only profile) equal to
   phase 12's, warm-up and replay bitwise equal to the eager step.
14. offload: phase 10's model at the depth ``/proc/meminfo`` allows,
   ``checkpoint='offload'`` against ``'never'``: loss and gradients
   bitwise, every saved byte moved to pinned host memory, the step's
   peak above its start lower, ms (median of 3 each).
15. lora: LoRA fine-tuning at full Llama-3-8B width (``lora_rank=16``,
   bf16 base, ``llama(cfg, head=False)`` with ``chunked_lm_loss``,
   ``GPipe([33], chunks=4, 'except_last')``, batch 8, seq 1024,
   ``lora_optimizer(AdamW)``): three steps with a falling loss, 224 / 128
   / 128 flash launches a step, every frozen base weight bitwise
   unchanged with no ``.grad``, every adapter and loss-layer tensor
   moved; step ms, tokens/s and peak beside phase 8's; a profile; one
   packed step from ``pack_documents`` over a seeded ragged corpus
   (lengths uniform in [64, 1024]) with 0 flash launches, a finite loss
   and its ``real_token_fraction``; ``generate`` of 32 greedy tokens with
   the adapters unmerged (``flash_decode``), then ``merge_lora`` and
   ``mpmd_params_for_generation``: the unmerged tokens must pass both
   models' teacher-forced check, and the count of equal merged tokens is
   printed.
16. unet: benchmarks/unet_speed.py's row pipeline-2 (its (5, 64) U-Net
   cut to depth 4, 192x192, batch 160, 8 micro-batches, 2 stages, 'except_last',
   float32, cuDNN deterministic) with its Dropout2d(0.1) live: two eager
   steps with one key bitwise equal and another key different, 'never'
   and 'except_last' bitwise equal under one key (at batch 40), the
   ``fused=True`` warm-up and replays bitwise the eager steps of their
   keys with one capture; samples/s eager and replayed, idle shares;
   then VGG16 at 224x224, batch 64: an eager and a replayed step bitwise.
17. timeline: phase 16's U-Net under ``Timeline(sync=False)`` and
   ``Timeline(sync=True)`` (benchmarks/unet_timeline.py's drive):
   samples/s, the per-stage summary, and ``simulate_pipeline``'s makespan
   and bubble against the analytic (n - 1) / (m + n - 1).

18. vit_l16: ViT-L/16 (dim 1024, depth 24, 16 heads, MLP 4096, patch 16,
   224x224, 1000 classes), bf16 weights, benchmarks/vit_speed.py's row
   pipeline-2 (batch 512, 8 micro-batches, 2 stages on one card,
   'except_last'), SGD: block 0's attention of micro-batch 0 at its real
   activations against the plain backward row by row; three steps with a
   falling loss, 360 / 192 / 192 flash launches a step, samples/s, peak,
   a profiled step's idle share.
19. amoebanetd: AmoebaNet-D (18, 256), 224x224, float32, TF32 off,
   benchmarks/amoebanetd_speed.py's row n2m4 (batch 256, 4 micro-batches,
   balance [9, 15], 'except_last'; the batch halved, and the cut printed,
   if it does not fit): the 2-stage step against the 1-stage one (loss,
   gradients, BatchNorm buffers), three SGD steps (momentum; losses
   printed, not gated), samples/s, peak, idle share, no hand-written
   kernel.
20. t5: t5-base width (vocab 32128, dim 768, 12 + 12 layers, 12 heads,
   d_ff 3072, relu, tied), bf16: a 2-stage step (encoder 512, decoder
   128, batch 32, 4 micro-batches) against the unpipelined loss, two SGD
   steps, then greedy ``t5_generate`` (batch 8, 64 tokens) whose tokens
   are the teacher-forced argmax up to bf16 near-ties; no kernel.
21. gpt2_xl_generate: GPT-2 XL as HF gpt2-xl's config gives it (1600
   wide, 48 layers, 25 heads, 1024 positions, vocab 50257, gelu_new,
   tied), bf16: 4 prompts of 512, 64 greedy tokens; 48 flash_fwd and
   3072 flash_decode launches; the teacher-forced check; ms/token.
22. mixtral_moe: Mixtral-8x7B width (dim 4096, 32 heads, 8 kv heads,
   hidden 14336, vocab 32000, rope theta 1e6, 8 experts top-2 dropless,
   balance weight 0.02), bf16, cut to 2 of its 32 blocks: the 2-stage
   GPipe step ([2, 2], batch 8 x seq 1024, 4 micro-batches,
   'except_last') against the 1-stage one, three SGD steps (step ms,
   tokens/s, peak, idle share), dropless against 'sparse' at capacity
   factor E/k (no drop) on block 1's input, ``router_stats``,
   ``generate(moe=)`` (4 x 512, 32 tokens, teacher-forced) and an
   ``Engine(moe=)`` whose graph replays equal its eager bodies bitwise;
   launch counts gated as written before the first run.

Each path's launch counts are set to 0 just before it runs and read just
after.  Then one JSON line per kernel (time, launches, bound, plain and
library yardsticks, the fastest SDPA backend by name; ``launches``
counts one generate call for the forward
and decode kernels, one ``generate(kv_quant=True)`` call for the int8
decode variant, one training step for the backward kernels, phase 5b's
float32 step for the 3xTF32 forward and backward, and 0 for flash_simt's
kernels, which no path reaches; every path's counts are in
``launches_by_path``, flash_simt's and the 3xTF32 kernels' 0 on every
bf16 path at head dims 64 and 128), the card line,
and the
last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import time
import warnings

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 rate outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate (3xTF32: a third of it)
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
    "flash_fwd_tf32": ("flash_fwd_tf32", ("flash_fwd_tf32_kernel", "tf32_split_kernel")),
    "flash_bwd_dq_tf32": ("flash_bwd_tf32", ("flash_bwd_dq_tf32_kernel", "tf32_bwd_split_kernel")),
    "flash_bwd_dkv_tf32": ("flash_bwd_tf32", ("flash_bwd_dkv_tf32_kernel",
                                              "flash_bwd_dkv_tf32_sum_kernel")),
    "flash_fwd_f32": ("flash_simt", ("fwd_f32_kernel",)),
    "flash_bwd_dq_f32": ("flash_simt", ("dq_f32_kernel",)),
    "flash_bwd_dkv_f32": ("flash_simt", ("dkv_f32_kernel",)),
    "flash_decode_simt": ("flash_simt", ("decode_simt_kernel",)),
}
# The redesigned kernels and the instructions their SASS must hold: HGMMA
# (wgmma) and UTMALDG (TMA tensor loads); the decode kernel's scores run on
# mma.sync (HMMA) for bf16 and int8 caches (an f32 cache keeps f32
# products on the CUDA cores: no HMMA there).  SASS_COUNT: instantiations
# each must show (d = 64 and 128, the tile dims; decode: four query/cache
# type pairs x two tile dims x four row counts, any head dim up to 128
# running on one of the two tile dims).
SASS_REQUIRED = {"flash_fwd": {"flash_fwd_kernel": ("HGMMA", "UTMALDG")},
                 "flash_bwd": {"flash_bwd_dkv_kernel": ("HGMMA", "UTMALDG"),
                               "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG")},
                 "flash_decode": {"flash_decode_kernel": ("UTMALDG", "HMMA")},
                 "flash_fwd_tf32": {"flash_fwd_tf32_kernel": ("HGMMA", "UTMALDG")},
                 "flash_bwd_tf32": {"flash_bwd_dq_tf32_kernel": ("HGMMA", "UTMALDG"),
                                    "flash_bwd_dkv_tf32_kernel": ("HGMMA", "UTMALDG")}}
SASS_COUNT = {"flash_fwd_kernel": 2, "flash_bwd_dkv_kernel": 2, "flash_bwd_dq_kernel": 2,
              "flash_decode_kernel": 32, "flash_fwd_tf32_kernel": 2,
              "flash_bwd_dq_tf32_kernel": 2, "flash_bwd_dkv_tf32_kernel": 2}


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
    4 rows a group; the 3xTF32 forward's and backward's at their main
    path's d=64), from their C interfaces."""
    import ctypes

    fwd = build.function("flash_fwd", "tgt_flash_fwd_smem_bytes", [ctypes.c_int])
    dq = build.function("flash_bwd", "tgt_flash_bwd_dq_smem_bytes", [ctypes.c_int])
    dkv = build.function("flash_bwd", "tgt_flash_bwd_dkv_smem_bytes", [ctypes.c_int])
    dec = build.function("flash_decode", "tgt_flash_decode_smem_bytes", [])
    simt = build.function("flash_simt", "tgt_flash_simt_smem_bytes", [ctypes.c_int] * 2)
    tf32 = build.function("flash_fwd_tf32", "tgt_flash_fwd_tf32_smem_bytes", [ctypes.c_int])
    dq_tf32 = build.function("flash_bwd_tf32", "tgt_flash_bwd_dq_tf32_smem_bytes", [ctypes.c_int])
    dkv_tf32 = build.function("flash_bwd_tf32", "tgt_flash_bwd_dkv_tf32_smem_bytes",
                              [ctypes.c_int])
    return {"flash_fwd": fwd(128), "flash_bwd_dq": dq(128), "flash_bwd_dkv": dkv(128),
            "flash_decode": dec(), "flash_decode_int8": dec(),
            "flash_fwd_tf32": tf32(64), "flash_bwd_dq_tf32": dq_tf32(64),
            "flash_bwd_dkv_tf32": dkv_tf32(64), "flash_fwd_f32": simt(0, 128),
            "flash_bwd_dq_f32": simt(1, 128), "flash_bwd_dkv_f32": simt(2, 128)}


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


def device_ms(torch, fn, reps: int, warmup: int = 2, by_kernel: bool = False):
    """Device time per call of ``fn``: the CUDA kernels' own time summed
    by torch.profiler over ``reps`` calls.  Unlike ``time_ms`` it leaves
    out the host's time between launches, which at decode sizes is
    longer than the kernels.  ``by_kernel``: ``(total, {kernel name: ms
    per call})``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev = getattr(e, "self_device_time_total", None)
            per[e.key] = per.get(e.key, 0.0) + (e.self_cuda_time_total if dev is None
                                                else dev) / 1e3 / reps
    total = sum(per.values())
    return (total, per) if by_kernel else total


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
    # (name, b, h, g, s, window, d, causal)
    cases = [
        ("main", 4, 32, 8, 1024, None, 128, True),
        # One micro-batch of phase 8's step (224 launches a step).
        ("train_microbatch", 2, 32, 8, 1024, None, 128, True),
        ("window256", 4, 32, 8, 1024, 256, 128, True),
        ("ragged1000", 4, 32, 8, 1000, None, 128, True),
        # Phase 6c's prefills: the 1b draft's (hd 64) and the target's
        # (also the self-draft's); phase 6d's one prompt.
        ("spec_draft_d64", 2, 32, 8, 512, None, 64, True),
        ("spec_target", 2, 32, 8, 512, None, 128, True),
        ("beam_prefill", 1, 32, 8, 1024, None, 128, True),
        ("long12288", 1, 4, 1, 12288, None, 128, True),
        # Phase 18's micro-batch: ViT-L/16, 196 patches, MHA at d=64, no
        # causal mask; phase 21's prefill: GPT-2 XL, MHA (25 heads) at d=64.
        ("vit_l16", 64, 16, 16, 196, None, 64, False),
        ("gpt2_xl_prefill", 4, 25, 25, 512, None, 64, True),
        # Head dims the kernel takes zero-padded (ops.flash_attention.
        # attention_route): Phi-2's 80 (to 128) and the reference's
        # benchmarks/llama_megastep.py's 32 (dim 256 over 8 heads, to 64).
        ("pad_d80", 4, 32, 32, 2048, None, 80, True),
        ("pad_d32", 4, 8, 4, 2048, None, 32, True),
    ]
    import torch.nn.functional as F

    rows = {}
    for name, b, h, g, s, window, d, causal in cases:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window)
        route = tfa.attention_route(q.shape, k.shape, q.dtype, window=window)
        if route.kind != ("kernel" if d in tfa.FWD_HEAD_DIMS else "pad"):
            fail(f"flash_fwd {name}: attention_route answers {route}")
        # The padded rows run the routed call (pad, kernel, slice) whole.
        call = (lambda: tfa.flash_attention(q, k, v, **kw)) if route.kind == "kernel" \
            else (lambda: tfa.attention(q, k, v, **kw))
        tfa.reset_launches()
        o = call()
        torch.cuda.synchronize()
        got = kernel_launches(tfa)
        if got["flash_fwd"] != 1 or sum(got.values()) != 1:
            fail(f"flash_fwd {name}: one call launched {got}")
        ro = tfa.flash_attention_reference(q, k, v, **kw)
        # LSE, the tight check at long s, through the kernel's (o, lse) entry
        # (at the padded dim with the real dim's scale for a padded row).
        pad = (0, route.head_dim - d)
        _, lse = tfa._flash_fwd(*(F.pad(x, pad) for x in (q, k, v)), causal, d ** -0.5,
                                window)
        _, rlse = tfa._reference_fwd(q, k, v, causal, d ** -0.5, window)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lerr = (lse - rlse).abs().max().item()
        if not (err <= FWD_TOL and lerr <= LSE_TOL):
            fail(f"flash_fwd {name}: max abs err {err} (tol {FWD_TOL}), "
                 f"lse err {lerr} (tol {LSE_TOL})")
        ms = time_ms(torch, call, 10)
        plain_ms = time_ms(
            torch, lambda: tfa.flash_attention_reference(q, k, v, **kw), 3, 1
        )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = lib_dev = None
        if window is None:
            lib_ms = time_ms(torch, lambda: gqa_sdpa(qt, kt, vt, causal), 10)
            lib_dev = device_ms(torch, lambda: gqa_sdpa(qt, kt, vt, causal), 10)
        # Device time apart from the host's: at the short prefills the
        # wrapper's host time per call can exceed the kernel's.
        dev = device_ms(torch, call, 10)
        flops = 4.0 * b * h * d * fwd_pairs(s, causal, window)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * b * h * s
        bms, by = bound(flops, nbytes)
        print(f"flash_fwd {name}: b={b} s={s} h={h} g={g} d={d} window={window} "
              f"causal={causal} route={route.kind}@{route.head_dim} "
              f"max_abs_err={err:.3e} (tol {FWD_TOL}) lse_err={lerr:.3e} (tol {LSE_TOL}) "
              f"ms={ms:.4f} (device {dev:.4f}) plain_ms={plain_ms:.4f} sdpa_ms={lib_ms} "
              f"(device {lib_dev}) bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
        rows[name] = dict(err=err, ms=ms, device_ms=dev, plain_ms=plain_ms, lib_ms=lib_ms,
                          lib_device_ms=lib_dev, bound_ms=bms, bound_by=by,
                          route=f"{route.kind}@{route.head_dim}")
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
        # Phase 21 (GPT-2 XL, prompt 512, 64 new: buffers of 576): MHA, one
        # query row per kv head (25 heads) at hd 64, 513..576 live keys.
        ("gpt2_xl_len513", 4, 25, 25, 64, 1, 512, None, 576),
        ("gpt2_xl_len576", 4, 25, 25, 64, 1, 575, None, 576),
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
    gpt2 = decode_path_timing(torch, tfa, card, "gpt2_xl", 4, 25, 25, 64, 544, 576)

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
    timing["gpt2_xl"] = gpt2
    return worst, timing


def decode_path_timing(torch, tfa, card, name, b, nh, nkv, hd, live, max_len):
    """The bf16 decode kernel at one path's shape (g=1, cycling four
    caches as the layers' caches cycle): device ms beside the plain
    version's, the fastest SDPA backend's and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    sets = []
    for _ in range(4):
        q = torch.randn(b, 1, nh, hd, generator=gen, device="cuda").bfloat16()
        ck = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        cv = torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").bfloat16()
        sets.append((q, ck, cv))
    pos0, it = live - 1, {"i": 0}

    def cycle(fn):
        def run():
            it["i"] = (it["i"] + 1) % len(sets)
            fn(*sets[it["i"]])
        return run

    ms = device_ms(torch, cycle(lambda q, ck, cv: tfa.flash_decode_attention(
        q, ck, cv, pos0)), 40)
    plain_ms = device_ms(torch, cycle(lambda q, ck, cv: tfa.flash_decode_reference(
        q, ck, cv, pos0)), 10, 1)
    lib_all, lib_best, lib_ms = sdpa_backends(
        torch, [(q.transpose(1, 2), ck[:, :live].transpose(1, 2),
                 cv[:, :live].transpose(1, 2)) for q, ck, cv in sets], False, 40)
    bms, by = decode_bound(b, nh, nkv, hd, live, 1, 2, False)
    print(f"flash_decode timing {name}: cache=[{b},{max_len},{nkv},{hd}] live={live} g=1 "
          f"rows/kv head={nh // nkv}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={lib_ms:.4f} ({lib_best}; by backend {lib_all}) bound_ms={bms:.4f} "
          f"({by}) [{card}]", flush=True)
    del sets
    return dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, lib_backend=lib_best,
                bound_ms=bms, bound_by=by)


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
    # (name, b, h, g, s, d, window, causal)
    cases = [
        ("main", 2, 32, 8, 1024, 128, None, True),
        ("window256", 2, 32, 8, 1024, 128, 256, True),
        ("ragged1000", 2, 32, 8, 1000, 128, None, True),
        ("d64", 2, 32, 8, 1024, 64, None, True),
        ("long12288", 1, 4, 1, 12288, 128, None, True),
        # Phase 18's micro-batch: ViT-L/16, MHA at d=64, no causal mask.
        ("vit_l16", 64, 16, 16, 196, 64, None, False),
        # Phase 3's padded head dims: the kernels at the padded dim (128,
        # 64) with the real dim's scale, the gradients sliced back.
        ("pad_d80", 4, 32, 32, 2048, 80, None, True),
        ("pad_d32", 4, 8, 4, 2048, 32, None, True),
    ]
    import torch.nn.functional as F

    worst = {"dq": 0.0, "dkv": 0.0}
    timing = {}
    for name, b, h, g, s, d, window, causal in cases:
        gen = torch.Generator(device="cuda").manual_seed(4)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        scale = d ** -0.5
        kw = dict(causal=causal, sm_scale=scale, window=window)
        D = tfa.attention_route(q.shape, k.shape, q.dtype, window=window).head_dim
        qk, kk, vk, dok = (F.pad(x, (0, D - d)) for x in (q, k, v, do))
        o, lse = tfa._flash_fwd(qk, kk, vk, causal, scale, window)
        delta = tfa._delta(dok, o)
        dq = tfa.flash_bwd_dq(qk, kk, vk, dok, lse, delta, **kw)[..., :d]
        dk, dv = (x[..., :d] for x in tfa.flash_bwd_dkv(qk, kk, vk, dok, lse, delta, **kw))
        o = o[..., :d].contiguous()
        ref = tfa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
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
              f"causal={causal} "
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
                                           causal, scale, None)
                probes = (("dk", dk, cut[1]), ("dv", dv, cut[2]))
            else:
                cut = tfa._reference_grads(q, k, v, do, lse, delta, causal, scale,
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
        if name not in ("main", "long12288", "vit_l16", "pad_d80", "pad_d32"):
            continue
        # (At the padded dims: the kernels on the padded operands.)
        dq_call = lambda: tfa.flash_bwd_dq(qk, kk, vk, dok, lse, delta, **kw)  # noqa: E731
        dkv_call = lambda: tfa.flash_bwd_dkv(qk, kk, vk, dok, lse, delta, **kw)  # noqa: E731
        call_dq, call_dkv = time_ms(torch, dq_call, 10), time_ms(torch, dkv_call, 10)
        ms_dq, ms_dkv = device_ms(torch, dq_call, 10), device_ms(torch, dkv_call, 10)
        plain_ms = time_ms(torch, lambda: tfa._reference_grads(
            q, k, v, do, lse, delta, causal, scale, window), 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_all, lib_best, lib_ms = sdpa_backends(torch, [(qt, kt, vt)], causal, 10,
                                                  dout=do.transpose(1, 2))
        pairs = fwd_pairs(s, causal, window)
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
    """Every kernel's launch count, the decode kernel's per variant (the
    CUDA-core kernels of flash_simt.cu too: 0 wherever a gate does not say
    otherwise, so no bf16 path at head dim 64 or 128 takes another route
    unseen)."""
    return {"flash_fwd": tfa.flash_attention.launches,
            "flash_decode": tfa.flash_decode_attention.launches,
            "flash_decode_int8": tfa.flash_decode_attention.launches_int8,
            "flash_bwd_dq": tfa.flash_bwd_dq.launches,
            "flash_bwd_dkv": tfa.flash_bwd_dkv.launches,
            "flash_fwd_tf32": tfa.flash_attention_tf32.launches,
            "flash_bwd_split_tf32": tfa.tf32_bwd_split.launches,
            "flash_bwd_dq_tf32": tfa.flash_bwd_dq_tf32.launches,
            "flash_bwd_dkv_tf32": tfa.flash_bwd_dkv_tf32.launches,
            "flash_fwd_f32": tfa.flash_attention_f32.launches,
            "flash_bwd_dq_f32": tfa.flash_bwd_dq_f32.launches,
            "flash_bwd_dkv_f32": tfa.flash_bwd_dkv_f32.launches,
            "flash_decode_simt": tfa.flash_decode_simt.launches}


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
    return launches, (cfg, model, prompt, out, times)


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


def profile(torch, card, label, fn, top: int = 12, cuda_only: bool = False):
    """Device time by kernel and the device's idle share of one call of
    ``fn`` (torch.profiler; one stream, so busy time is the sum of kernel
    times).  Returns ``(wall_s, busy_s, [(device_us, count, name)] of
    every kernel, longest first)``; prints the top ``top``.  ``cuda_only``
    records the device's activity alone."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
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
    return wall, busy, rows


def phase_profile(torch, tg, card, cfg, model, prompt, steps: int = 16) -> None:
    """Profiles of one prefill and of a ``steps``-token generate, with a
    bf16 and with an int8 cache; decode per step is their difference over
    ``steps``."""
    s = prompt.shape[1]
    for kv_quant in (False, True):
        tag = " kv_quant" if kv_quant else ""
        pw, pb, _ = profile(torch, card, f"prefill{tag}", lambda: tg.prefill(
            cfg, model, prompt, s + steps, kv_quant=kv_quant))
        gw, gb, _ = profile(torch, card, f"generate{tag} x{steps}", lambda: tg.generate(
            cfg, model, prompt, steps, kv_quant=kv_quant))
        print(f"profile decode{tag} (generate - prefill) per step: "
              f"wall={(gw - pw) * 1e3 / steps:.2f}ms "
              f"device_busy={(gb - pb) * 1e3 / steps:.2f}ms "
              f"idle_share={1 - (gb - pb) / (gw - pw):.3f} [{card}]", flush=True)


# Phase 9: the serving Engine on phase 6's model.  ``Engine(cfg, model,
# num_slots=8, max_len=1152, prefill_chunk=(8, 64, 256))``, greedy: a bf16
# pool of 32 layers x K and V x [8, 1152, 8, 128] = 1.21 GB.
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_LADDER = 8, 1152, (8, 64, 256)
SERVE_STATS = {"prefill@8": 1, "prefill@64": 1, "prefill@256": 1, "decode": 1}


def serving_trace(np, seed: int, vocab: int, n: int = 24):
    """The churn trace: ``n`` requests, prompt lengths uniform in 32-1024
    and ``max_new_tokens`` uniform in 16-128, from ``seed``."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, int(rng.randint(32, 1025))).astype(np.int32),
             int(rng.randint(16, 129))) for _ in range(n)]


def drive_trace(Engine, eng, trace, first: int = 8, every: int = 16,
                cancel_at: int = 40, drain_at: int = 120):
    """Serve ``trace`` on ``eng`` as a continuous-batching server sees
    it: ``first`` requests at the start, then two more every ``every``
    engine steps; the first request decoding its 4th token at or after
    step ``cancel_at`` is cancelled; at step ``drain_at`` the engine is
    drained (``request_drain``), reopened (``resume_serving``) and the
    snapshot's requests resubmitted to it (``restore_requests``).  Device
    agnostic: no synchronisation here.  Returns the trace's log."""
    log = {"prompts": {}, "steps_by_program": {}, "cancelled": None, "drained": None,
           "engine_steps": 0}
    real_run = eng._run_program

    def counted(name, *args):
        log["steps_by_program"][name] = log["steps_by_program"].get(name, 0) + 1
        return real_run(name, *args)

    eng._run_program = counted
    snaps = []
    eng.drain_hooks.append(snaps.append)

    def submit(i):
        log["prompts"][eng.submit(trace[i][0], trace[i][1])] = trace[i][0]

    for i in range(first):
        submit(i)
    nxt, steps = first, 0
    try:
        while True:
            if nxt < len(trace) and steps >= every * ((nxt - first) // 2 + 1):
                for i in range(nxt, min(nxt + 2, len(trace))):
                    submit(i)
                nxt += 2
            if log["cancelled"] is None and steps >= cancel_at:
                live = [r for r in eng.scheduler.decode_ready() if len(r.generated) >= 4]
                if live:
                    log["cancelled"] = live[0].rid
                    eng.cancel(live[0].rid)
            if log["drained"] is None and steps >= drain_at:
                eng.request_drain()
                if eng.run() != "preempted":
                    fail("serving: request_drain() did not drain the engine")
                restored = Engine.restore_requests(snaps[-1])
                log["drained"] = len(restored)
                eng.resume_serving()
                for kw in restored:
                    eng.submit(kw.pop("prompt"), kw.pop("max_new_tokens"), **kw)
            if eng.step():
                steps += 1
            elif nxt >= len(trace):
                break
            else:       # idle before the next arrival: it comes now
                steps = every * ((nxt - first) // 2 + 1)
    finally:
        del eng._run_program    # back to the class's method (no cycle holding eng)
    log["engine_steps"] = steps
    return log


def pool_buffers(eng):
    c = eng.pool.cache
    return [t for name in ("k", "v", "k_scale", "v_scale") for t in getattr(c, name, [])]


def serve_all(eng, reqs):
    rids = [eng.submit(p, n) for p, n in reqs]
    eng.run()
    return {r: eng.result(r).tolist() for r in rids}


def stream_check(torch, model, streams, agree_min, gap_max, what):
    """The teacher-forced check of phase 6 over finished streams
    (``[(prompt, tokens)]``, one forward each): the argmax agreement is
    pooled over every stream's positions (a 16-token stream alone cannot
    resolve a 0.9 share), the logit gap must hold at every position of
    every stream."""
    hits = n = 0
    gap = 0.0
    for prompt, toks in streams:
        p = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
        o = torch.as_tensor(toks, dtype=torch.int64, device="cuda")[None]
        a, g = teacher_forced(torch, model, p, o)
        hits += a * o.shape[1]
        n += o.shape[1]
        gap = max(gap, g)
    agree = hits / n
    if agree < agree_min or gap > gap_max:
        fail(f"{what}: streams vs the teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= {agree_min} needed), worst logit gap {gap:.3f} "
             f"(<= {gap_max})")
    return {"streams": len(streams), "positions": n, "agree": agree, "max_gap": gap}


def step_ms(torch, eng, steps: int):
    """Host-clock ms of each of ``steps`` calls of ``eng.step()`` (each
    ends in the step's token fetch, a synchronisation), every one a
    decode step."""
    if eng.scheduler.queue or eng.scheduler.prefill_pending():
        fail("serving: a prompt is still pending in a timed decode window")
    torch.cuda.synchronize()
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        if not eng.step():
            fail("serving: the engine went idle inside a timed decode window")
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_serving(torch, tfa, tg, card, seed, cfg, model):
    """The continuous-batching Engine at Llama-3-8B width on phase 6's
    model: captured graphs against the eager bodies (bitwise), decode
    step time both ways and a profile of steady replays, the dense cache
    read's cost, the churn trace with a cancellation and a drain/resume
    (one capture per program), teacher-forced streams (bf16 and int8
    pools), and zero hand-written kernel launches throughout.  The launch
    gate reads the wrappers' counts, which move where a wrapper's Python
    runs: in the eager bodies and in the captures (each program is
    captured inside a gated window, 9a and 9d's warm-up).  A replay runs
    no Python and cannot add to them, so a kernel a graph replays would
    have been counted at its capture."""
    import numpy as np

    from torchgpipe_tpu_torch.serving import Engine, ServingMetrics

    def engine(**kw):
        return Engine(cfg, model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prefill_chunk=SERVE_LADDER, **kw)

    def no_launches(what):
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        expect_launches(counts, {}, what)
        return counts

    trace = serving_trace(np, seed, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card, "model": f"Llama-3-8B width, {cfg.n_layers} layers, bf16, "
                                  f"random from seed {seed}",
           "engine": {"num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                      "prefill_chunk": list(SERVE_LADDER), "greedy": True}}

    # 9a. Graph replays against the eager bodies: 4 requests, 32 tokens.
    short = [(p, 32) for p, _ in trace[:4]]
    graph_eng, eager_eng = engine(), engine(cuda_graph=False)
    tfa.reset_launches()
    got, want = serve_all(graph_eng, short), serve_all(eager_eng, short)
    no_launches("the serving engine (graph against eager)")
    same_cache = all(torch.equal(a, b) for a, b in zip(pool_buffers(graph_eng),
                                                        pool_buffers(eager_eng)))
    if got != want or not same_cache:
        fail(f"serving: graph replays against the eager bodies: tokens equal "
             f"{got == want}, cache bytes equal {same_cache}")
    out["graph_equals_eager"] = {"requests": len(short), "tokens": 32, "bitwise": True}

    # 9b. Decode step at 8 occupied slots, graph against eager, in turns;
    # then profiles of 8 steady decode steps each way.
    for eng in (graph_eng, eager_eng):
        for p, _ in trace[:SERVE_SLOTS]:
            eng.submit(p, 100)
        while eng.scheduler.queue or eng.scheduler.prefill_pending():
            eng.step()
    times = {"graph": [], "eager": []}
    tfa.reset_launches()
    for order in (("graph", "eager"), ("eager", "graph")) * 2:
        for name in order:
            times[name].append(step_ms(torch, graph_eng if name == "graph" else eager_eng, 6))
    prof = {}
    for name, eng in (("graph", graph_eng), ("eager", eager_eng)):
        wall, busy, rows = profile(torch, card, f"serving decode x8 ({name})",
                                   lambda eng=eng: [eng.step() for _ in range(8)])
        prof[name] = {"wall_ms_per_step": wall * 1e3 / 8, "busy_ms_per_step": busy * 1e3 / 8,
                      "idle_share": 1 - busy / wall,
                      "top": [[k[:80], c, round(d / 1e3 / 8, 4)] for d, c, k in rows[:8]]}
    no_launches("the serving engine (decode timing and profiles)")
    out["decode_step_ms"] = {
        k: {"median": statistics.median(sum(v, [])), "window_medians": [
            statistics.median(w) for w in v], "steps": [[round(t, 3) for t in w] for w in v]}
        for k, v in times.items()}
    out["decode_step_ms"]["graph_over_eager"] = (out["decode_step_ms"]["graph"]["median"]
                                                 / out["decode_step_ms"]["eager"]["median"])
    out["profile_decode_x8"] = prof
    del graph_eng, eager_eng
    torch.cuda.empty_cache()

    # 9c. What the dense read costs: the slot step's attention read of one
    # layer (flash_decode_reference, per-row frontiers) at the decode
    # step's shape, beside the flash_decode kernel reading the same cache
    # at one shared frontier (the kernel takes one scalar position).
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    q = torch.randn(SERVE_SLOTS, 1, cfg.n_heads, cfg.head_dim, generator=gen,
                    device="cuda").bfloat16()
    ck, cv = (torch.randn(SERVE_SLOTS, SERVE_MAX_LEN, cfg.kv_heads, cfg.head_dim,
                          generator=gen, device="cuda").bfloat16() for _ in range(2))
    lengths = torch.arange(1090, 1090 + SERVE_SLOTS, device="cuda")
    dense = device_ms(torch, lambda: tfa.flash_decode_reference(q, ck, cv, lengths), 20)
    kern = device_ms(torch, lambda: tfa.flash_decode_attention(q, ck, cv, 1097), 20)
    busy = prof["graph"]["busy_ms_per_step"]
    out["dense_read"] = {"ms_per_layer": dense, "ms_per_step": dense * cfg.n_layers,
                         "share_of_graph_step_busy": dense * cfg.n_layers / busy,
                         "flash_decode_kernel_ms_per_layer_one_frontier": kern,
                         "shape": f"cache [{SERVE_SLOTS}, {SERVE_MAX_LEN}, {cfg.kv_heads}, "
                                  f"{cfg.head_dim}] bf16, g=1, frontiers 1090-1097"}
    del q, ck, cv

    # 9d. The churn trace on a fresh engine, warmed up first as a server
    # is: one request per ladder bucket, served alone (prompts of 8, 64 and
    # 256 tokens, 2 new tokens each), captures every program once.  The
    # seeded trace alone need not use every bucket (seed 0's never leaves
    # a remainder of <= 8 prompt tokens pending by itself); after the
    # warm-up it must capture nothing more.  The trace's metrics are its
    # own: a fresh ServingMetrics after the warm-up.
    eng = engine()
    capture_s = []
    real_build = eng._build

    def timed_build(prog):
        if prog.built:
            return real_build(prog)
        t0 = time.perf_counter()
        real_build(prog)
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)

    eng._build = timed_build
    warm = np.random.RandomState(seed + 1)
    tfa.reset_launches()
    for g in SERVE_LADDER:
        serve_all(eng, [(warm.randint(0, cfg.vocab, g).astype(np.int32), 2)])
    no_launches("the serving engine (warm-up)")
    if eng.compile_stats != SERVE_STATS:
        fail(f"serving: captures after the warm-up {eng.compile_stats}, expected "
             f"{SERVE_STATS}")
    eng.metrics = ServingMetrics()
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = drive_trace(Engine, eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace_launches = no_launches("the serving engine (churn trace)")
    del eng._build, timed_build, real_build   # nothing but `eng` holds the engine
    if eng.compile_stats != SERVE_STATS:
        fail(f"serving: captures after the warm-up, the trace, the drain and the "
             f"resume {eng.compile_stats}, expected {SERVE_STATS}")
    snap = eng.metrics.snapshot()
    finished = [(log["prompts"][r], eng.result(r).tolist()) for r in log["prompts"]
                if eng.status(r) == "finished"]
    if len(finished) != len(trace) - 1 or eng.status(log["cancelled"]) != "cancelled":
        fail(f"serving: {len(finished)} of {len(trace)} streams finished, cancelled "
             f"{log['cancelled']}")
    want_len = {r: n for r, (_, n) in zip(log["prompts"], trace)}
    short_streams = [r for r in log["prompts"] if eng.status(r) == "finished"
                     and len(eng.result(r)) != want_len[r]]
    if short_streams:
        fail(f"serving: streams of the wrong length {short_streams}")
    out["trace"] = {
        "requests": len(trace), "first": 8, "arrivals": "2 every 16 engine steps",
        "cancelled": log["cancelled"], "drained_requests": log["drained"],
        "engine_steps": log["engine_steps"], "steps_by_program": log["steps_by_program"],
        "wall_s": wall, "tokens": snap["tokens_out"],
        "tokens_per_s": snap["tokens_out"] / wall, "occupancy": snap["occupancy"],
        "ttft_p50_s": snap["ttft_p50"], "ttft_p99_s": snap["ttft_p99"],
        "tpot_p50_s": snap["tpot_p50"], "tpot_p99_s": snap["tpot_p99"],
        "queue_wait_p50_s": snap["queue_wait_p50"]}
    out["compile_stats"] = eng.compile_stats
    out["capture_s"] = {"total": sum(capture_s), "each": capture_s}
    out["pool_bytes"] = eng.pool.bytes()
    out["teacher_forced"] = stream_check(torch, model, finished, TF_AGREE, TF_GAP,
                                         "serving (bf16 pool)")
    del eng
    torch.cuda.empty_cache()

    # 9e. An int8 pool: 4 requests, 32 tokens.
    q_eng = engine(kv_quant=True)
    tfa.reset_launches()
    q_got = serve_all(q_eng, short)
    no_launches("the serving engine (int8 pool)")
    q_streams = [(p, q_got[r]) for (p, _), r in zip(short, q_got)]
    out["int8"] = dict(stream_check(torch, model, q_streams, TF_AGREE_INT8, TF_GAP_INT8,
                                    "serving (int8 pool)"),
                       pool_bytes=q_eng.pool.bytes(),
                       token_agreement_with_bf16_pool=float(np.mean(
                           [a == b for r, s in zip(q_got, got) for a, b in
                            zip(q_got[r], got[s])])))
    del q_eng
    torch.cuda.empty_cache()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["kernel_launches"] = trace_launches
    t, d = out["trace"], out["decode_step_ms"]
    print(f"serving: {t['requests']} requests, {t['engine_steps']} engine steps "
          f"{t['steps_by_program']}, {t['tokens']} tokens in {t['wall_s']:.3f}s = "
          f"{t['tokens_per_s']:.2f} tokens/s, occupancy {t['occupancy']:.4f}, "
          f"TTFT p50/p99 {t['ttft_p50_s']:.4f}/{t['ttft_p99_s']:.4f}s, TPOT p50/p99 "
          f"{t['tpot_p50_s']:.5f}/{t['tpot_p99_s']:.5f}s; captures {out['compile_stats']} "
          f"in {out['capture_s']['total']:.2f}s; decode step graph "
          f"{d['graph']['median']:.3f}ms vs eager {d['eager']['median']:.3f}ms; "
          f"teacher_forced {out['teacher_forced']}; int8 {out['int8']} [{card}]", flush=True)
    print(json.dumps({"serving": out}), flush=True)
    return out


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
# Phase 8's peak memory with the hand-written in-place SGD it had before
# make_train_step (NVIDIA H100 80GB HBM3, 700 W; PERF.md): torch.optim.SGD
# without momentum keeps no state, so the peak stays within 1 GiB of it.
TRAIN_PEAK_GIB = 50.01


def phase_train(torch, tfa, tt, card, seed: int, steps: int = 3):
    """pipeline-1 at Llama-3-8B width: GPipe(llama, [34], chunks=4,
    checkpoint='except_last'), batch 8, seq 1024, trained by
    ``make_train_step`` with SGD (in place, no state)."""
    import functools

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
    train_step = model.make_train_step(
        functools.partial(torch.optim.SGD, lr=TRAIN_LR), loss_fn)

    def step(stats=None):
        loss, _ = train_step(tokens, tokens)
        if stats is not None:
            # SGD leaves the step's gradients in .grad.
            for name, layer, key in (("head.w", -1, "w"), ("table", 0, "table"),
                                     ("block0.wq", 1, "wq"),
                                     ("block0.w_down", 1, "w_down")):
                g = getattr(model[layer], key).grad.float()
                stats[name] = (g.abs().max().item(), g.square().mean().sqrt().item())
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
    if abs(peak / 2**30 - TRAIN_PEAK_GIB) > 1.0:
        fail(f"train step peak memory {peak / 2**30:.2f} GiB, not within 1 GiB of "
             f"{TRAIN_PEAK_GIB} GiB (the hand-written SGD's; SGD keeps no state)")
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
          f"make_train_step(SGD lr {TRAIN_LR}): losses {[round(x, 5) for x in losses]} "
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
    del model, llama, params, train_step
    torch.cuda.empty_cache()
    return launches, (med, peak / 2**30)


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


# Phases 10, 12, 13 (b) and 14 run Llama-3-8B width cut to this many
# blocks, so that the whole run stays within half its time limit: 8 at
# first, 4 once phases 15-17 joined, 2 once phases 18-21 joined (with 4,
# the run took 632.9 s on an NVIDIA H100 80GB HBM3 at 700 W).
CUT_BLOCKS = 2

# Phase 10: AdamW's rate for the bf16 weights.  Adam moves an entry by
# ~lr whatever its gradient (m / sqrt(v) ~ +-1 in the first steps); a
# projection weight of |w| ~ dim^-1/2 = 0.0156 has a bf16 ulp of 2^-13 =
# 1.2e-4, so a move survives rounding only when lr > 6e-5.  lr = 1e-3 moves
# such a weight by ~8 ulps a step (6% of |w|), large weights by fewer, and
# the decay (lr * 0.01 = 1e-5 of |w|) by none: too small for bf16.
ADAMW_LR = 1e-3


def grad_leaves(model):
    return [p.grad for p in model.parameters()]


def grad_witness(torch, model, fn):
    """``fn()`` with a hook on every parameter that adds each gradient it
    receives (one per cell backward) into float32: ``{name: (sum, sum of
    |g|, [count])}``.  The hooks change no gradient."""
    acc, handles = {}, []
    for name, p in model.named_parameters():
        s, a, n = torch.zeros_like(p, dtype=torch.float32), \
            torch.zeros_like(p, dtype=torch.float32), [0]

        def hook(g, s=s, a=a, n=n):
            s.add_(g)
            a.add_(g.abs())
            n[0] += 1

        handles.append(p.register_hook(hook))
        acc[name] = (s, a, n)
    for p in model.parameters():
        p.grad = None
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    return acc


def step_with_peak(torch, tfa, model, fn):
    """``fn()`` with the card's peak memory above what was allocated just
    before it (old gradients dropped first) and the kernels' launches."""
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tfa.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "step_peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                 "ms": start.elapsed_time(end), "launches": kernel_launches(tfa)}


def phase_1f1b(torch, tfa, tt, card, seed: int):
    """Llama-3-8B width cut to ``CUT_BLOCKS`` blocks, batch 8, seq 1024, chunks 8,
    checkpoint 'never', 4 stages on one card at the balance
    ``balance_by_flops`` gives: one step of the fill-drain schedule and
    one of 1F1B from the same weights (loss, gradients, launches, peak
    memory), then three ``make_train_step`` steps of AdamW under 1F1B."""
    import functools

    import numpy as np

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.balance import balance_by_flops

    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=CUT_BLOCKS))
    b, s, chunks, n_stages = 8, 1024, 8, 4
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    layers = list(tt.llama(cfg, device="cuda", generator=gen))
    tokens = torch.from_numpy(
        np.random.default_rng(seed + 3).integers(0, cfg.vocab, (b, s))).cuda()
    loss_fn = causal_lm_loss(tt)
    t0 = time.perf_counter()
    balance = balance_by_flops(n_stages, layers, tokens[: b // chunks])
    flops_s = time.perf_counter() - t0
    # No recompute under 'never': each block runs the forward kernel once
    # per micro-batch and each backward kernel once per micro-batch, in
    # either schedule (balance_by_flops counted on the meta device and
    # launched nothing).
    want = {k: cfg.n_layers * chunks for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # One untimed fill-drain step first: cuBLAS and the allocator warm up
    # outside the two steps compared.
    GPipe(layers, balance, chunks=chunks, checkpoint="never").value_and_grad(
        tokens, tokens, loss_fn)

    def pipe(schedule):
        kw = dict(loss_reduction="mean") if schedule == "1f1b" else {}
        return GPipe(layers, balance, chunks=chunks, checkpoint="never",
                     schedule=schedule, **kw)

    runs = {}
    for schedule in ("gpipe", "1f1b"):
        model = pipe(schedule)
        (loss, _, _), stats = step_with_peak(
            torch, tfa, model, lambda: model.value_and_grad(tokens, tokens, loss_fn))
        expect_launches(stats["launches"], want, f"one {schedule} step ({cfg.n_layers} blocks, {chunks} chunks)")
        runs[schedule] = (loss.item(), stats)
        del model
    (lg, sg), (lf, sf) = runs["gpipe"], runs["1f1b"]
    # Loss: fill-drain takes one mean over the gathered 8 x 1023 token
    # losses, 1F1B sums eight per-micro-batch means weighted 1/8: the
    # same float32 terms in another order, ~1e-7 relative.
    if abs(lf - lg) > 1e-5 * abs(lg):
        fail(f"1F1B vs fill-drain: loss {lf} vs {lg} (tol 1e-5 relative)")
    if not sf["step_peak_gib"] < sg["step_peak_gib"]:
        fail(f"1F1B step peak {sf['step_peak_gib']:.2f} GiB is not below fill-drain's "
             f"{sg['step_peak_gib']:.2f} GiB")
    # Gradients, on a second step of each schedule (the hooks' float32
    # sums would distort the peaks above).  The two schedules add the
    # same eight micro-batch gradients into the bf16 .grad in opposite
    # orders (7 -> 0 against 0 -> 7), so their .grad part by rounding
    # alone; a bound on that, not one reading, decides:
    # * every leaf receives exactly `chunks` gradients (a micro-batch lost
    #   or counted twice fails here);
    # * each .grad equals the float32 sum S of what it received within
    #   the bf16 rounding of n - 1 adds: each rounds by at most 2^-8 of
    #   its result, and every partial sum is at most A = sum |g| (times
    #   (1 + 2^-8)^7), so |.grad - S| <= n 2^-8 A elementwise (S's own
    #   float32 error, n 2^-24 A, fits in the ~0.8 x 2^-8 A left over, and
    #   2^-130 covers subnormal sums, which round by up to 2^-134 an add);
    # * the two schedules' S, which no longer depend on the order, agree
    #   within 2^-7 of a leaf's max |S| (phase_stages' one bf16 ulp).
    sums, bound_use, s_diff = {}, {}, 0.0
    for schedule in ("gpipe", "1f1b"):
        model = pipe(schedule)
        acc = grad_witness(torch, model, lambda: model.value_and_grad(tokens, tokens, loss_fn))
        bound_use[schedule] = 0.0
        for name, p in model.named_parameters():
            total, absum, n = acc.pop(name)
            if n[0] != chunks:
                fail(f"{schedule}: {name} received {n[0]} gradients, not {chunks}")
            err = (p.grad.float() - total).abs_()
            tol = absum.mul_(n[0] * 2 ** -8).add_(2 ** -130)
            if bool((err > tol).any()):
                fail(f"{schedule}: {name}'s bf16 .grad is off the float32 sum of its "
                     f"{n[0]} micro-batch gradients beyond the rounding bound")
            bound_use[schedule] = max(bound_use[schedule], err.div_(tol).max().item())
            if schedule == "gpipe":
                sums[name] = total
                continue
            ref = sums.pop(name)
            d = ((total - ref).abs().max() / ref.abs().max()).item()
            if not d <= 2 ** -7:
                fail(f"1F1B vs fill-drain: {name}'s float32 gradient sums part by {d:.3e} "
                     f"of max |S| (tol 2^-7)")
            s_diff = max(s_diff, d)
            del total, absum, err, tol, ref
        del model, acc
    torch.cuda.empty_cache()
    print(f"train_1f1b: Llama-3-8B width, {cfg.n_layers} blocks, batch {b} x seq {s}, "
          f"chunks {chunks}, "
          f"'never', balance_by_flops({n_stages}) = {balance} ({flops_s:.2f}s on the meta "
          f"device); loss gpipe {lg:.6f} vs 1f1b {lf:.6f}; every leaf got {chunks} "
          f"micro-batch gradients, .grad within the bf16 bound of their float32 sum (worst "
          f"use of the bound: gpipe {bound_use['gpipe']:.3f}, 1f1b {bound_use['1f1b']:.3f}), "
          f"float32 sums of the two schedules part by {s_diff:.3e} of max |S| at worst "
          f"(tol 2^-7); step peak above start: fill-drain "
          f"{sg['step_peak_gib']:.2f} GiB vs 1F1B {sf['step_peak_gib']:.2f} GiB (ratio "
          f"{sf['step_peak_gib'] / sg['step_peak_gib']:.3f}; absolute "
          f"{sg['peak_gib']:.2f} vs {sf['peak_gib']:.2f}); step ms {sg['ms']:.1f} vs "
          f"{sf['ms']:.1f}; launches/step {sf['launches']} = {cfg.n_layers} blocks x "
          f"{chunks} [{card}]", flush=True)

    model = GPipe(layers, balance, chunks=chunks, checkpoint="never", schedule="1f1b",
                  loss_reduction="mean")
    step = model.make_train_step(functools.partial(torch.optim.AdamW, lr=ADAMW_LR),
                                 loss_fn)
    losses, ms = [], []
    for _ in range(3):
        (loss, _), stats = step_with_peak(torch, tfa, model, lambda: step(tokens, tokens))
        expect_launches(stats["launches"], want, "one 1F1B AdamW step")
        losses.append(loss.item())
        ms.append(stats["ms"])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"AdamW under 1F1B: loss did not fall on the fixed batch: {losses}")
    print(f"train_1f1b: make_train_step(AdamW lr {ADAMW_LR}) x3 under 1F1B: losses "
          f"{[round(x, 5) for x in losses]}, step ms {[round(t, 1) for t in ms]}, peak "
          f"{stats['peak_gib']:.2f} GiB [{card}]", flush=True)
    del model, step, layers
    torch.cuda.empty_cache()
    return {"balance": balance, "launches": sf["launches"],
            "gpipe_step_peak_gib": sg["step_peak_gib"],
            "1f1b_step_peak_gib": sf["step_peak_gib"]}


# Phase 11: benchmarks/resnet101_speed.py's pipeline-2 row: 2 stages,
# batch 512, chunks 16, 'except_last', deferred batch norm, at 224x224.
RESNET_BATCH, RESNET_CHUNKS, RESNET_STAGES, RESNET_IMAGE = 512, 16, 2, 224
# SGD as the torchgpipe ResNet-101 recipe: lr 0.1, momentum 0.9.
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9


def phase_resnet(torch, tfa, card, seed: int):
    """ResNet-101 at full width (1000 classes, float32 weights drawn as
    the reference's init draws them) through ``GPipe`` with deferred
    batch norm on one card: the balance from ``balance_by_time``, one
    step there and at a forced 3-stage cut inside bottlenecks against the
    1-stage pipeline, the deferred commit of bn1, three SGD steps."""
    import functools

    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.balance import balance_by_time
    from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
    from torchgpipe_tpu_torch.models.resnet import resnet101

    b, chunks = RESNET_BATCH, RESNET_CHUNKS
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    layers = convert_deferred_batch_norm(
        list(resnet101(device="cuda", generator=gen)), chunks)
    n = len(layers)
    x = torch.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE, device="cuda", generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (b,), device="cuda", generator=gen)

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float(), tgt)

    t0 = time.perf_counter()
    balance = balance_by_time(RESNET_STAGES, layers, x[: b // chunks], timeout=1.0)
    time_s = time.perf_counter() - t0
    names = [layer.name for layer in layers]
    forced = [names.index("layer2_b1_bn1"), names.index("layer3_b12_conv3")]
    forced = [forced[0], forced[1] - forced[0], n - forced[1]]
    snapshot = [{k: v.clone() for k, v in layer.state_dict().items()} for layer in layers]

    def restore():
        for layer, state in zip(layers, snapshot):
            layer.load_state_dict(state)

    results = {}
    for tag, bal in (("balance", balance), ("forced", forced), ("one_stage", [n])):
        restore()
        model = GPipe(layers, bal, chunks=chunks, checkpoint="except_last",
                      deferred_batch_norm=True)
        crossing = sum(src != dst for src, dst in model.skip_layout.by_key.values())
        (loss, _, _), stats = step_with_peak(
            torch, tfa, model, lambda: model.value_and_grad(x, y, loss_fn))
        expect_launches(stats["launches"], {}, f"a ResNet-101 step at {bal}")
        results[tag] = (loss.item(), [g.clone() for g in grad_leaves(model)],
                        [t.clone() for t in model.buffers()], crossing, stats)
        del model
    l1, g1, b1, _, s1 = results["one_stage"]
    # The stage boundaries change no operation: the loss is one float32
    # mean either way (1e-6 relative), and each gradient leaf may differ
    # only by the order in which cuDNN's weight-gradient kernels add with
    # atomics, ~2^-24 x sqrt(terms) of the terms, far inside 1e-4 of the
    # leaf's max |grad|.  Buffers come from the forward alone (the same
    # reductions): 1e-6 of max(|value|, 1).
    for tag in ("balance", "forced"):
        loss, grads, bufs, crossing, _ = results[tag]
        gworst = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                     for a, c in zip(grads, g1))
        bworst = max(((a.double() - c.double()).abs().max()
                      / c.double().abs().max().clamp_min(1.0)).item()
                     for a, c in zip(bufs, b1))
        if abs(loss - l1) > 1e-6 * abs(l1) or gworst > 1e-4 or bworst > 1e-6:
            fail(f"ResNet-101 at {tag} balance vs one stage: loss {loss} vs {l1}, worst "
                 f"grad diff {gworst:.3e} (tol 1e-4), worst buffer diff {bworst:.3e} "
                 "(tol 1e-6)")
        results[tag] = (loss, gworst, bworst, crossing, results[tag][4])
    del g1, b1

    # Deferred BN: bn1's running statistics after the one-stage step are
    # one 0.9-momentum commit, from (mean 0, var 1), of the whole batch's
    # biased statistics of conv1's output.  From the same conv1 on the
    # same 512 images, the per-micro-batch sums (16 x 401k terms) and
    # var_mean over all 6.4M agree to ~1e-6 of the statistics; the
    # commit's ssq/count - mean^2 cancels little here (|mean| < std), so
    # 1e-4 of max(|stat|, 1) leaves room.
    with torch.no_grad():
        h = layers[0](x)
        var, mean = torch.var_mean(h, dim=(0, 2, 3), correction=0)
        del h
    restore()
    model = GPipe(layers, [n], chunks=chunks, checkpoint="except_last",
                  deferred_batch_norm=True)
    model.value_and_grad(x, y, loss_fn)
    bn1 = layers[1]
    dmean = (bn1.mean - 0.1 * mean).abs().max().item()
    dvar = (bn1.var - (0.9 + 0.1 * var)).abs().max().item()
    if dmean > 1e-4 * max(mean.abs().max().item(), 1.0) or \
            dvar > 1e-4 * max(var.abs().max().item(), 1.0) or bn1._tracked != 0:
        fail(f"deferred bn1 commit: mean off by {dmean:.3e}, var by {dvar:.3e} "
             f"(tracked {bn1._tracked})")
    del model

    restore()
    model = GPipe(layers, balance, chunks=chunks, checkpoint="except_last",
                  deferred_batch_norm=True)
    step = model.make_train_step(functools.partial(
        torch.optim.SGD, lr=RESNET_LR, momentum=RESNET_MOMENTUM), loss_fn)
    losses, ms = [], []
    for _ in range(3):
        (loss, _), stats = step_with_peak(torch, tfa, model, lambda: step(x, y))
        expect_launches(stats["launches"], {}, "a ResNet-101 SGD step")
        losses.append(loss.item())
        ms.append(stats["ms"])
    if not all(l == l for l in losses) or not losses[-1] < losses[0]:
        fail(f"ResNet-101 SGD: loss did not fall on the fixed batch: {losses}")
    tfa.reset_launches()
    profile(torch, card, "resnet101 step", lambda: step(x, y), top=10)
    expect_launches(kernel_launches(tfa), {}, "the profiled ResNet-101 step")
    med = statistics.median(ms)
    lb, gb, bb, cb, _ = results["balance"]
    _, gf, bf, cf, _ = results["forced"]
    print(f"resnet101: {n} layers, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
          f"params float32, batch {b} x {RESNET_IMAGE}^2, chunks {chunks}, except_last, "
          f"deferred BN, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; "
          f"balance_by_time({RESNET_STAGES}) = {balance} ({time_s:.1f}s, {cb} skips cross "
          f"the boundary): loss {lb:.6f} vs one stage {l1:.6f}, "
          f"grad diff {gb:.2e}, buffer diff {bb:.2e}; forced {forced} ({cf} skips cross): "
          f"grad diff {gf:.2e}, buffer diff {bf:.2e}; bn1 commit off by {dmean:.2e} / "
          f"{dvar:.2e} [{card}]", flush=True)
    print(f"resnet101: make_train_step(SGD lr {RESNET_LR} momentum {RESNET_MOMENTUM}) x3: "
          f"losses {[round(v, 5) for v in losses]}; step_ms={med:.1f} (steps "
          f"{[round(t, 1) for t in ms]}) samples_per_s={b * 1e3 / med:.1f} "
          f"max_memory_allocated={stats['peak_gib']:.2f}GiB (one-stage step "
          f"{s1['peak_gib']:.2f}GiB) [{card}]", flush=True)
    del model, step, layers, snapshot, x
    torch.cuda.empty_cache()
    return {"balance": balance, "step_ms": med, "samples_per_s": b * 1e3 / med,
            "launches": stats["launches"]}


# Phases 12-14: the eighth slice's training options at phase 10's width.
FLASH_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def profile_launches(rows):
    """Launches of the flash training kernels in a profile's rows (what a
    graph replay runs without passing through the wrappers)."""
    return {k: sum(n for _, n, key in rows if name in key)
            for k, name in FLASH_KERNELS.items()}


def clone_all(tensors):
    return [t.detach().clone() for t in tensors]


def load_all(torch, dst, src):
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s, non_blocking=True)


def to_host(tensors):
    return [t.detach().to("cpu") for t in tensors]


def bitwise(torch, got, want):
    """Indices of the tensors of ``got`` that differ from ``want`` in any
    bit (NaN where NaN), ``want`` on the host or the card."""
    bad = []
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.to(a.device, non_blocking=True)
        if a.shape != b.shape or not (torch.equal(a.nan_to_num(), b.nan_to_num())
                                      and torch.equal(a.isnan(), b.isnan())):
            bad.append(i)
    return bad if len(got) == len(want) else ["count"]


def opt_tensors(optimizers):
    return [v for opt in optimizers for st in opt.state.values()
            for v in st.values() if hasattr(v, "is_cuda")]


def timed_steps(torch, fn, n):
    ms = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def phase_train_graph(torch, tfa, tt, card, seed: int, balance):
    """Phase 10's model (Llama-3-8B width, ``CUT_BLOCKS`` blocks, batch 8, seq 1024,
    8 micro-batches, 4 stages on one card at ``balance``) under
    ``checkpoint='except_last'`` as ``GPipe(fused=True)``: one SGD step
    eagerly (per cell) twice and as a replayed CUDA graph from the same
    weights, all bitwise equal; replay and eager step times and idle
    shares; then ``make_train_step(AdamW(capturable=True), megastep=4)``
    with a NaN loss at inner step 1, against four replayed single steps
    in which this phase skips step 1."""
    import functools

    import numpy as np

    from torchgpipe_tpu_torch import GPipe

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=CUT_BLOCKS))
    b, s, chunks = 8, 1024, 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    layers = list(tt.llama(cfg, device="cuda", generator=gen))
    rng = np.random.default_rng(seed + 5)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda() for _ in range(4)]
    base_loss = causal_lm_loss(tt)

    def loss_fn(out, target):
        tokens, scale = target if isinstance(target, tuple) else (target, None)
        loss = base_loss(out, tokens)
        return loss if scale is None else loss * scale

    def pipe(**kw):
        return GPipe(layers, balance, chunks=chunks, checkpoint="except_last", **kw)

    eager, fused = pipe(), pipe(fused=True)
    params = list(eager.parameters())
    w0 = to_host(params)     # on the host: the megastep below needs the card's memory
    sgd = functools.partial(torch.optim.SGD, lr=TRAIN_LR)
    estep = eager.make_train_step(sgd, loss_fn)
    fstep = fused.make_train_step(sgd, loss_fn)
    want_launches = {"flash_fwd": cfg.n_layers * (2 * chunks - 1),
                     "flash_bwd_dq": cfg.n_layers * chunks,
                     "flash_bwd_dkv": cfg.n_layers * chunks}

    def run(step, what):
        load_all(torch, params, w0)
        tfa.reset_launches()
        loss, _ = step(toks[0], toks[0])
        torch.cuda.synchronize()
        return loss, [p.grad for p in params], kernel_launches(tfa)

    loss1, grads1, l1 = run(estep, "eager")
    expect_launches(l1, want_launches, "an eager step")
    ref = ([loss1.clone()], clone_all(grads1), clone_all(params))
    results = {}
    for what, step in (("eager again", estep), ("fused warm-up", fstep),
                       ("replay", fstep)):
        loss, grads, launches = run(step, what)
        want = want_launches if what != "replay" else {}
        expect_launches(launches, want, f"the {what} step (wrapper counts)")
        bad = [bitwise(torch, [loss], ref[0]), bitwise(torch, grads, ref[1]),
               bitwise(torch, params, ref[2])]
        if any(bad):
            fail(f"train_graph: the {what} step differs from the eager step: loss "
                 f"{loss.item()} vs {loss1.item()}, grads {bad[1][:8]}, params {bad[2][:8]}")
        results[what] = launches
    stats = dict(fused.graph_stats)
    if stats["captures"] != 1 or stats["replays"] != 1:
        fail(f"train_graph: graph stats {stats}, expected one capture and one replay")
    del ref, grads1, loss, grads   # the replay's outputs hold the graph's pool
    # Times: three replays with new tokens each, two eager steps.
    replay_ms = timed_steps(torch, lambda: fstep(toks[1], toks[1]), 3)
    eager_ms = timed_steps(torch, lambda: estep(toks[1], toks[1]), 2)
    rw, rb, rows = profile(torch, card, "train_graph replay", lambda: fstep(toks[2], toks[2]),
                           top=6)
    per_replay = profile_launches(rows)
    if per_replay != want_launches:
        fail(f"train_graph: flash kernels per replay (profile) {per_replay}, expected "
             f"{want_launches} (the eager step's)")
    ew, eb, _ = profile(torch, card, "train_graph eager step", lambda: estep(toks[2], toks[2]),
                        top=6)
    if fused.graph_stats["captures"] != 1:
        fail(f"train_graph: new tokens added a capture: {fused.graph_stats}")
    print(f"train_graph: Llama-3-8B width, {cfg.n_layers} blocks, batch {b} x seq {s}, "
          f"chunks {chunks}, "
          f"except_last, balance {balance}, fused=True, SGD lr {TRAIN_LR}: two eager steps, "
          f"the fused warm-up and the first replay from the same weights bitwise equal "
          f"(loss {loss1.item():.6f}, every .grad, every updated parameter); captures "
          f"{fused.graph_stats['captures']} in {stats['capture_s']:.2f}s (warm-up step "
          f"included); step_ms replay {statistics.median(replay_ms):.1f} "
          f"({[round(t, 1) for t in replay_ms]}) vs eager {statistics.median(eager_ms):.1f} "
          f"({[round(t, 1) for t in eager_ms]}); idle_share replay {1 - rb / rw:.3f} vs eager "
          f"{1 - eb / ew:.3f}; flash launches per replay (profile) {per_replay} = the eager "
          f"step's [{card}]", flush=True)
    del estep, fstep, eager, fused
    for p in params:
        p.grad = None
    torch.cuda.empty_cache()

    # The megastep: K=4 with a NaN loss at inner step 1.
    k = 4
    adamw = functools.partial(torch.optim.AdamW, lr=ADAMW_LR, capturable=True)
    xs = torch.stack(toks)
    nan = torch.ones(k, device="cuda")
    nan[1] = float("nan")

    def fresh(optimizers):
        """Back to w0 and to the state a new AdamW starts from."""
        load_all(torch, params, w0)
        with torch.no_grad():
            for t in opt_tensors(optimizers):
                t.zero_()

    mpipe = pipe(fused=True, megastep=k)
    mstep = mpipe.make_train_step(adamw, loss_fn)
    mstep(xs, (xs, torch.ones(k, device="cuda")))        # warm-up and capture
    fresh(mstep.optimizers)
    tfa.reset_launches()
    t0 = time.perf_counter()
    losses, _, finite = mstep(xs, (xs, nan))              # replay
    torch.cuda.synchronize()
    mega_s = time.perf_counter() - t0
    expect_launches(kernel_launches(tfa), {}, "a megastep replay (wrapper counts)")
    flags = finite.tolist()
    if flags != [True, False, True, True]:
        fail(f"train_graph megastep: finite {flags}, expected [True, False, True, True]")
    mega = ([x.clone() for x in losses], to_host(params), to_host(opt_tensors(mstep.optimizers)))
    mcaptures = mpipe.graph_stats["captures"]
    del mstep, mpipe, losses, finite
    for p in params:
        p.grad = None
    torch.cuda.empty_cache()

    spipe = pipe(fused=True)
    sstep = spipe.make_train_step(adamw, loss_fn)
    sstep(toks[0], (toks[0], nan[0]))                     # warm-up and capture
    fresh(sstep.optimizers)
    single = []
    for i in range(k):
        if i == 1:
            before = to_host(params + opt_tensors(sstep.optimizers))
        loss, _ = sstep(toks[i], (toks[i], nan[i]))       # replays
        single.append(loss.clone())
        if i == 1:
            load_all(torch, params + opt_tensors(sstep.optimizers), before)
            del before
    bad = [bitwise(torch, mega[0], single), bitwise(torch, params, mega[1]),
           bitwise(torch, opt_tensors(sstep.optimizers), mega[2])]
    if any(bad) or spipe.graph_stats["captures"] != 1 or mcaptures != 1:
        fail(f"train_graph megastep vs single replayed steps with step 1 skipped: losses "
             f"{bad[0]}, params {bad[1][:8]}, AdamW state {bad[2][:8]}; captures "
             f"{mcaptures} / {spipe.graph_stats['captures']}")
    print(f"train_graph: make_train_step(AdamW lr {ADAMW_LR} capturable, megastep={k}) "
          f"replayed with a NaN loss at inner step 1: finite {flags}, losses "
          f"{[round(x.item(), 5) for x in mega[0]]} bitwise those of {k} replayed single "
          f"steps with step 1 skipped, parameters, moments and step counts bitwise "
          f"({len(mega[1])} + {len(mega[2])} tensors); the megastep replay took "
          f"{mega_s * 1e3:.1f}ms wall [{card}]", flush=True)
    del sstep, spipe, mega, layers, params, w0
    torch.cuda.empty_cache()
    return {"launches": results["fused warm-up"], "per_replay": per_replay, "balance": balance,
            "replay_ms": statistics.median(replay_ms),
            "eager_ms": statistics.median(eager_ms), "replay_idle": 1 - rb / rw,
            "eager_idle": 1 - eb / ew, "capture_s": stats["capture_s"]}


# Phase 13 (a)'s witness, at phase 11's row: plain float32 and the policy
# at compute_dtype=float64 (its norms in float32) against a plain
# float64 copy of the model.  No policy code runs in plain float32, so
# its distance from float64 is what float32's roundings (2^-24) become
# in the gradients of this randomly initialised ResNet-101: the
# BatchNorm backwards amplify them (~5e-2 read on the card).  The
# float64 policy rounds only its norms to float32, so it may stand no
# farther from float64 than that, with a factor of 2 for the spread
# (over all leaves and at the worst leaf: a cast whose gradient is
# dropped puts its leaf at 1.0).  bf16 rounds 2^15 times coarser and
# must stand 10 times farther: a policy that did not compute in bf16
# would sit as close as float32.
WITNESS_FACTOR, WITNESS_BF16_RATIO = 2.0, 10.0


def grad_distance(F, got, want):
    """Relative L2 of all leaves together, the worst leaf's, the worst
    leaf's cosine."""
    diff = num = 0.0
    worst, cos = 0.0, 1.0
    for a, c in zip(got, want):
        a, c = a.double(), c.double()
        diff += (a - c).square().sum().item()
        num += c.square().sum().item()
        worst = max(worst, ((a - c).norm() / c.norm()).item())
        cos = min(cos, F.cosine_similarity(a.flatten(), c.flatten(), dim=0).item())
    return (diff / num) ** 0.5, worst, cos


def phase_precision(torch, tfa, tt, card, seed: int, resnet_balance, graph,
                    f32_samples_per_s=None):
    """(a) ResNet-101 at phase 11's row with ``compute_dtype=bfloat16``
    over float32 masters against phase 11's float32 step from the same
    weights, and plain float32 and the policy at ``float64`` against a
    plain float64 copy (the witness above ``grad_distance``); three SGD
    steps eagerly and as a CUDA graph from the same
    state, bitwise equal, their time and profiles; (b) phase 12's Llama
    with float32 masters and bf16 compute under ``fused=True``: the
    fused warm-up's flash launches and a replay's equal phase 12's, both
    bitwise its eager step."""
    import copy
    import functools

    import numpy as np
    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
    from torchgpipe_tpu_torch.models.resnet import resnet101

    b, chunks = RESNET_BATCH, RESNET_CHUNKS
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)    # phase 11's weights
    layers = convert_deferred_batch_norm(
        list(resnet101(device="cuda", generator=gen)), chunks)
    x = torch.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE, device="cuda", generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (b,), device="cuda", generator=gen)

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float(), tgt)

    def state(mods):
        return [{k: v.clone() for k, v in m.state_dict().items()} for m in mods]

    def restore(mods, saved):
        for m, st in zip(mods, saved):
            m.load_state_dict(st)

    def resnet(mods, **kw):
        return GPipe(mods, resnet_balance, chunks=chunks, checkpoint="except_last",
                     deferred_batch_norm=True, **kw)

    snapshot = state(layers)
    f32 = resnet(layers)
    (l32, _, _), s32 = step_with_peak(torch, tfa, f32, lambda: f32.value_and_grad(x, y, loss_fn))
    g32 = [p.grad.clone() for p in f32.parameters()]
    del f32

    # The witness: a plain float64 copy and the policy at float64 (on a
    # copy, so that `layers` takes bf16's below), the loss in float64.
    def loss64(out, tgt):
        return F.cross_entropy(out.double(), tgt)

    wit = {}
    for what in ("float64", "policy float64"):
        restore(layers, snapshot)
        if what == "float64":
            m = resnet([layer.double() for layer in copy.deepcopy(layers)])
            wl, _, _ = m.value_and_grad(x.double(), y, loss64)
        else:
            m = resnet(copy.deepcopy(layers), compute_dtype=torch.float64)
            wl, _, _ = m.value_and_grad(x, y, loss64)
        wit[what] = (wl.item(), [p.grad for p in m.parameters()])
        del m, wl
    (l64, g64), lpol = wit["float64"], wit["policy float64"][0]
    w32 = grad_distance(F, g32, g64)
    wpol = grad_distance(F, wit["policy float64"][1], g64)
    del wit["policy float64"]
    restore(layers, snapshot)
    model = resnet(layers, compute_dtype=torch.bfloat16)
    snapshot = state(layers)                  # the wrapped layers' keys
    (l16, _, _), s16 = step_with_peak(torch, tfa, model,
                                      lambda: model.value_and_grad(x, y, loss_fn))
    expect_launches(s16["launches"], {}, "a bf16 ResNet-101 step")
    g16 = [p.grad.clone() for p in model.parameters()]
    # bf16 keeps 8 bits: each rounding moves a value by up to 2^-9 of
    # itself.  The loss is a mean over 512 x 1000 log-probabilities, so
    # the roundings of ~300 layers average out in it: within 1e-2
    # relative.  The gradients pass through 104 BatchNorms, each of which
    # subtracts per-channel means of nearly cancelling terms and scales
    # by 1/std, so a rounding comes out amplified by orders of magnitude
    # (the witness): bf16's distance from float32 is printed.
    bad = [i for i, (a, c) in enumerate(zip(g16, g32))
           if a.dtype != torch.float32 or a.shape != c.shape or not bool(a.isfinite().all())]
    head = [i for i, p in enumerate(model.parameters()) if p.ndim == 2]
    head_l2 = max(grad_distance(F, [g16[i]], [g32[i]])[0] for i in head)
    rel_l2, _, worst_cos = grad_distance(F, g16, g32)
    lrel = abs(l16.item() - l32.item()) / abs(l32.item())
    if bad or not lrel <= 1e-2:
        fail(f"precision: bf16 ResNet-101 vs float32: loss {l16.item()} vs {l32.item()} "
             f"({lrel:.3e} relative, tol 1e-2), gradient leaves not finite float32 of "
             f"the masters' shapes: {bad[:8]}")
    w16 = grad_distance(F, g16, g64)
    del g32, g64, wit
    print(f"precision: ResNet-101 witness, gradients against a plain float64 copy (loss "
          f"{l64:.7f}; float32 {l32.item():.7f}, policy float64 {lpol:.7f}): plain float32 "
          f"{w32[0]:.3e} over all leaves, worst leaf {w32[1]:.3e}, worst cosine "
          f"{w32[2]:.6f}; the policy at float64 {wpol[0]:.3e}, worst leaf {wpol[1]:.3e}, "
          f"worst cosine {wpol[2]:.6f} (tol {WITNESS_FACTOR:g} times float32's); the policy at bf16 {w16[0]:.3e}, worst leaf {w16[1]:.3e}, "
          f"worst cosine {w16[2]:.4f}: {w16[0] / w32[0]:.3g} times float32's (at least "
          f"{WITNESS_BF16_RATIO:g}) [{card}]", flush=True)
    if not (wpol[0] <= WITNESS_FACTOR * w32[0] and wpol[1] <= WITNESS_FACTOR * w32[1]
            and w16[0] >= WITNESS_BF16_RATIO * w32[0]):
        fail("precision: the ResNet-101 witness failed (the line above): the policy at "
             "float64 must stand within twice float32's distance from float64, bf16 ten "
             "times farther than float32")

    # Three SGD steps eagerly, then as one CUDA graph from the same state
    # (weights, BN buffers, fresh momentum): loss, gradients, parameters
    # and buffers bitwise equal at every step, the first eager step's
    # also the value_and_grad's above.
    sgd = functools.partial(torch.optim.SGD, lr=RESNET_LR, momentum=RESNET_MOMENTUM)

    def taken(loss):
        return ([loss.clone()], clone_all(p.grad for p in model.parameters()),
                clone_all(model.parameters()), clone_all(model.buffers()))

    restore(layers, snapshot)
    step = model.make_train_step(sgd, loss_fn)
    eager, ms = [], []
    for _ in range(3):
        (loss, _), stats = step_with_peak(torch, tfa, model, lambda: step(x, y))
        eager.append(taken(loss))
        ms.append(stats["ms"])
    losses = [t[0][0].item() for t in eager]
    first = [bitwise(torch, eager[0][0], [l16]), bitwise(torch, eager[0][1], g16)]
    if any(first):
        fail(f"precision: two eager bf16 ResNet-101 steps differ: loss {losses[0]} vs "
             f"{l16.item()}, gradient leaves {first[1][:8]}")
    if not all(v == v for v in losses) or not losses[-1] < losses[0]:
        fail(f"precision: bf16 ResNet-101 SGD loss did not fall: {losses}")
    del g16
    rw, rb, _ = profile(torch, card, "resnet101 bf16 step", lambda: step(x, y), top=10)
    med = statistics.median(ms)
    print(f"precision: ResNet-101 compute_dtype=bfloat16 (float32 masters), batch {b}, "
          f"chunks {chunks}, balance {resnet_balance}, except_last, deferred BN: loss "
          f"{l16.item():.6f} vs float32 {l32.item():.6f} ({lrel:.2e} relative), gradients "
          f"float32 and finite, the classifier's {head_l2:.3e} from float32 (relative L2), "
          f"all leaves {rel_l2:.3e}, worst leaf cosine {worst_cos:.4f}; SGD x3 losses "
          f"{[round(v, 5) for v in losses]}, the first step's loss and gradients bitwise "
          f"value_and_grad's; step_ms={med:.1f} ({[round(t, 1) for t in ms]}) "
          f"samples_per_s={b * 1e3 / med:.1f} (phase 11's float32: {f32_samples_per_s}; "
          f"here float32 value_and_grad {s32['ms']:.1f}ms, "
          f"bf16 {s16['ms']:.1f}ms); max_memory_allocated={stats['peak_gib']:.2f}GiB "
          f"(float32 step {s32['peak_gib']:.2f}GiB); idle_share {1 - rb / rw:.3f} "
          f"[{card}]", flush=True)
    del step

    # The same three steps as one CUDA graph: the warm-up, then replays.
    restore(layers, snapshot)
    fmodel = resnet(layers, compute_dtype=torch.bfloat16, fused=True)
    fstep = fmodel.make_train_step(sgd, loss_fn)
    t0 = time.perf_counter()
    for i, want in enumerate(eager):
        loss, _ = fstep(x, y)
        torch.cuda.synchronize()
        if i == 0:
            capture_s = time.perf_counter() - t0
        bad = [bitwise(torch, got, w) for got, w in zip(taken(loss), want)]
        if any(bad):
            what = "warm-up" if i == 0 else "replay"
            fail(f"precision: fused bf16 ResNet-101 step {i + 1} ({what}) "
                 f"differs from the eager step: loss {loss.item()} vs {losses[i]}, grads "
                 f"{bad[1][:8]}, params {bad[2][:8]}, buffers {bad[3][:8]}")
    del eager
    fms = timed_steps(torch, lambda: fstep(x, y), 3)
    fw, fb, _ = profile(torch, card, "resnet101 bf16 replay", lambda: fstep(x, y), top=6)
    fmed = statistics.median(fms)
    if fmodel.graph_stats["captures"] != 1:
        fail(f"precision: fused bf16 ResNet-101: {fmodel.graph_stats}, expected one capture")
    print(f"precision: ResNet-101 bf16 fused=True: the warm-up and two replays from the "
          f"same state bitwise the three eager SGD steps (loss, every .grad, parameter and "
          f"buffer); capture {capture_s:.2f}s (warm-up step included), step_ms={fmed:.1f} "
          f"({[round(t, 1) for t in fms]}) samples_per_s={b * 1e3 / fmed:.1f}, idle_share "
          f"{1 - fb / fw:.3f} [{card}]", flush=True)
    del fmodel, fstep
    resnet_out = {"step_ms": med, "samples_per_s": b * 1e3 / med,
                  "launches": s16["launches"], "fused_step_ms": fmed}
    del model, layers, snapshot, x
    torch.cuda.empty_cache()

    # (b) Llama, float32 masters, bf16 compute, fused.
    cfg = tt.TransformerConfig(**dict(LLAMA3_8B, n_layers=CUT_BLOCKS), dtype=torch.float32)
    bsz, s, chunks = 8, 1024, 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    llama = list(tt.llama(cfg, device="cuda", generator=gen))
    tokens = torch.from_numpy(
        np.random.default_rng(seed + 6).integers(0, cfg.vocab, (bsz, s))).cuda()
    loss_fn = causal_lm_loss(tt)

    def pipe(**kw):
        return GPipe(llama, graph["balance"], chunks=chunks, checkpoint="except_last",
                     compute_dtype=torch.bfloat16, **kw)

    eager = pipe()
    tfa.reset_launches()
    loss_e, grads, _ = eager.value_and_grad(tokens, tokens, loss_fn)
    torch.cuda.synchronize()
    expect_launches(kernel_launches(tfa), graph["launches"],
                    "the float32-master Llama's eager step (phase 12's counts)")
    want = ([loss_e.clone()], to_host(g for st in grads for d in st for g in d.values()))
    if any(g.dtype != torch.float32 for g in want[1]):
        fail("precision: a float32 master's gradient is not float32")
    for p in eager.parameters():
        p.grad = None
    del eager, grads
    fused = pipe(fused=True)
    for call in ("warm-up", "replay"):
        tfa.reset_launches()
        loss, grads, _ = fused.value_and_grad(tokens, tokens, loss_fn)
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        if call == "warm-up":
            launches = counts
        expect_launches(counts, graph["launches"] if call == "warm-up" else {},
                        f"the fused float32-master Llama's {call} (wrapper counts)")
        got = [g for st in grads for d in st for g in d.values()]
        bad = [bitwise(torch, [loss], want[0]), bitwise(torch, got, want[1])]
        if any(bad):
            fail(f"precision: fused float32-master Llama {call} differs from its eager "
                 f"step: loss {loss.item()} vs {loss_e.item()}, grads {bad[1][:8]}")
        del grads, got
    # A replay runs no wrapper: its launches are read from a profile of
    # the device's activity alone (whose kernel times summed to half the
    # busy time in one run, so the idle share comes from a second).
    _, _, rows = profile(torch, card, "float32-master Llama replay (CUDA only)",
                         lambda: fused.value_and_grad(tokens, tokens, loss_fn), top=0,
                         cuda_only=True)
    per_replay = profile_launches(rows)
    if per_replay != graph["per_replay"]:
        fail(f"precision: flash kernels per float32-master replay (profile) {per_replay}, "
             f"expected phase 12's {graph['per_replay']}")
    rw, rb, _ = profile(torch, card, "float32-master Llama replay",
                        lambda: fused.value_and_grad(tokens, tokens, loss_fn), top=6)
    print(f"precision: Llama-3-8B width {cfg.n_layers} blocks, float32 masters "
          f"({sum(p.numel() for p in fused.parameters()) / 1e9:.3f}B params), "
          f"compute_dtype=bfloat16, fused=True: warm-up launches {launches} and per replay "
          f"(profile) {per_replay} = phase 12's; warm-up and replay bitwise equal to the "
          f"eager step (loss {loss_e.item():.6f}, every float32 .grad); replay idle_share "
          f"{1 - rb / rw:.3f} [{card}]", flush=True)
    del fused, llama, want
    torch.cuda.empty_cache()
    return resnet_out, launches


def host_available_gib():
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) / 2**20


# Phase 14: pinned host memory per block for 'offload' at batch 8, seq
# 1024, 8 micro-batches (phase 10's 'never' step holds ~2.7 GiB of
# residuals a block), with room for the caching host allocator's
# power-of-two blocks.
OFFLOAD_GIB_PER_BLOCK = 5.5


def phase_offload(torch, tfa, tt, card, seed: int, balance):
    """Phase 10's model under ``checkpoint='offload'`` against ``'never'``
    at the depth host memory allows: loss and gradients bitwise, every
    saved byte moved, the step's peak above its start, ms (median of 3)."""
    import numpy as np

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.balance import balance_by_flops

    avail = host_available_gib()
    blocks = max(1, min(CUT_BLOCKS, int(avail // OFFLOAD_GIB_PER_BLOCK)))
    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=blocks))
    b, s, chunks = 8, 1024, 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    layers = list(tt.llama(cfg, device="cuda", generator=gen))
    tokens = torch.from_numpy(
        np.random.default_rng(seed + 7).integers(0, cfg.vocab, (b, s))).cuda()
    loss_fn = causal_lm_loss(tt)
    if blocks != CUT_BLOCKS:
        balance = balance_by_flops(4, layers, tokens[: b // chunks])
    never = GPipe(layers, balance, chunks=chunks, checkpoint="never")
    (ln, gn, _), sn = step_with_peak(torch, tfa, never,
                                     lambda: never.value_and_grad(tokens, tokens, loss_fn))
    want = ([ln.clone()], clone_all(g for st in gn for d in st for g in d.values()))
    del gn
    never_ms = timed_steps(torch, lambda: never.value_and_grad(tokens, tokens, loss_fn), 3)
    off = GPipe(layers, balance, chunks=chunks, checkpoint="offload")
    t0 = time.perf_counter()
    off.value_and_grad(tokens, tokens, loss_fn)        # pins the host buffers
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (lo, go, _), so = step_with_peak(torch, tfa, off,
                                     lambda: off.value_and_grad(tokens, tokens, loss_fn))
    moved = dict(off.offload_stats)
    bad = [bitwise(torch, [lo], want[0]),
           bitwise(torch, [g for st in go for d in st for g in d.values()], want[1])]
    if any(bad):
        fail(f"offload: loss {lo.item()} vs never {ln.item()}, grads {bad[1][:8]}")
    del go
    off_ms = timed_steps(torch, lambda: off.value_and_grad(tokens, tokens, loss_fn), 3)
    if not 0 < moved["moved_bytes"] == moved["saved_bytes"]:
        fail(f"offload: {moved}: every saved byte must move to the host")
    if not so["step_peak_gib"] < sn["step_peak_gib"]:
        fail(f"offload: step peak {so['step_peak_gib']:.2f} GiB is not below 'never''s "
             f"{sn['step_peak_gib']:.2f} GiB")
    print(f"offload: Llama-3-8B width, {blocks} blocks (host MemAvailable {avail:.1f} GiB), "
          f"batch {b} x seq {s}, chunks {chunks}, balance {balance}: 'offload' loss and "
          f"every gradient bitwise 'never''s (loss {ln.item():.6f}); moved "
          f"{moved['moved_bytes'] / 2**30:.3f} GiB to pinned host memory = every saved byte; "
          f"step peak above start {so['step_peak_gib']:.2f} GiB vs 'never' "
          f"{sn['step_peak_gib']:.2f} GiB ({sn['step_peak_gib'] - so['step_peak_gib']:.3f} GiB "
          f"lower; absolute {so['peak_gib']:.2f} vs {sn['peak_gib']:.2f}); step_ms offload "
          f"{statistics.median(off_ms):.1f} ({[round(t, 1) for t in off_ms]}) vs never "
          f"{statistics.median(never_ms):.1f} ({[round(t, 1) for t in never_ms]}) (first "
          f"offload step {first_s * 1e3:.0f}ms wall, pinning included) [{card}]", flush=True)
    del never, off, layers, want
    torch.cuda.empty_cache()
    return {"launches": so["launches"], "blocks": blocks,
            "ms": statistics.median(off_ms), "never_ms": statistics.median(never_ms)}



# Phase 15: LoRA at full Llama-3-8B width.  The adapters (rank 16, alpha
# 16) and the chunked loss layer's head train with AdamW at phase 10's
# rate; the base weights are frozen.
LORA_RANK = 16


def phase_lora(torch, tfa, tt, tg, card, seed: int, train_ms: float, train_peak: float):
    """LoRA fine-tuning of the headless Llama-3-8B-width model with the
    chunked loss layer (``GPipe([33], chunks=4, 'except_last')``, batch 8,
    seq 1024, ``lora_optimizer(AdamW)``): three steps, then one packed
    step, then ``generate`` with the adapters unmerged, ``merge_lora`` and
    ``generate`` again."""
    import functools

    import numpy as np

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models import lora
    from torchgpipe_tpu_torch.utils import data as tdata

    gc.collect()
    torch.cuda.empty_cache()
    cfg = tt.TransformerConfig(**LLAMA3_8B, dtype=torch.bfloat16, lora_rank=LORA_RANK)
    b, s, chunks, new_tokens = 8, 1024, 4, 32
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    t0 = time.perf_counter()
    model = tt.llama(cfg, head=False, device="cuda", generator=gen)
    loss_layer = tt.chunked_lm_loss(cfg, device="cuda", generator=gen)
    pipe = GPipe(list(model), [cfg.n_layers + 1], chunks=chunks, checkpoint="except_last")
    opt = lora.lora_optimizer(functools.partial(torch.optim.AdamW, lr=ADAMW_LR), pipe)(
        list(pipe.parameters()) + list(loss_layer.parameters()))
    base = [p for n, p in pipe.named_parameters() if "lora" not in n.split(".")]
    moving = [p for n, p in pipe.named_parameters() if "lora" in n.split(".")] + \
        list(loss_layer.parameters())
    base0, moving0 = to_host(base), clone_all(moving)
    n_adapt = sum(p.numel() for p in moving[:-len(list(loss_layer.parameters()))])
    rng = np.random.default_rng(seed + 15)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1))).cuda()
    x, y = tokens[:, :-1], tokens[:, 1:]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def step(xx, yy):
        loss, _, _, _ = pipe.value_and_grad_with_loss_params(xx, yy, loss_layer)
        opt.step()
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], None
    for i in range(3):
        tfa.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(x, y))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        if i == 0:
            launches = kernel_launches(tfa)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.n_layers
    expect_launches(launches, {"flash_fwd": n * (2 * chunks - 1), "flash_bwd_dq": n * chunks,
                               "flash_bwd_dkv": n * chunks}, "a LoRA step")
    losses = [v.item() for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"lora: the loss did not fall on the fixed batch: {losses}")
    if any(p.grad is not None for p in base):
        fail("lora: a frozen base weight holds a .grad")
    bad = bitwise(torch, base, base0)
    if bad:
        fail(f"lora: {len(bad)} frozen base weights changed (first {bad[:4]})")
    unmoved = [i for i, (a, w) in enumerate(zip(moving, moving0)) if torch.equal(a, w)]
    if unmoved:
        fail(f"lora: {len(unmoved)} of {len(moving)} adapter / loss-layer tensors did not move")
    del base0, moving0
    med = statistics.median(step_ms[1:])
    profile(torch, card, "lora step", lambda: step(x, y), top=8)
    print(f"lora: Llama-3-8B width, lora_rank {LORA_RANK}, llama(head=False) + "
          f"chunked_lm_loss, GPipe([{n + 1}], chunks={chunks}, except_last), batch {b} x "
          f"seq {s}, lora_optimizer(AdamW lr {ADAMW_LR}): losses "
          f"{[round(v, 5) for v in losses]}; {len(base)} base tensors bitwise unchanged "
          f"with no .grad, {n_adapt / 1e6:.2f}M adapter and "
          f"{sum(p.numel() for p in loss_layer.parameters()) / 1e6:.1f}M loss-layer "
          f"parameters moved; launches/step={launches}; step_ms={med:.3f} (steps "
          f"{[round(t, 3) for t in step_ms]}, the first creates AdamW's state) "
          f"tokens_per_s={b * s * 1e3 / med:.1f} peak={peak:.2f}GiB against phase 8's "
          f"full-parameter step {train_ms:.3f} ms, {train_peak:.2f}GiB; built in "
          f"{build_s:.1f}s [{card}]", flush=True)

    # One packed step: a seeded ragged corpus (lengths uniform in
    # [64, 1024], as benchmarks/packing_speed.py draws them).
    lens = rng.integers(64, s + 1, 24)
    docs = [rng.integers(0, cfg.vocab, int(k)) for k in lens]
    pk = tdata.pack_documents(docs, s)
    px, py = next(tdata.packed_batches(pk, b))
    frac = tdata.real_token_fraction(px)
    px, py = next(tdata.prefetch_to_device([(px, py)]))
    tfa.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    packed_loss = step(px, py)
    end.record()
    end.synchronize()
    packed_ms = start.elapsed_time(end)
    packed_launches = kernel_launches(tfa)
    expect_launches(packed_launches, {}, "a packed LoRA step (dense segment attention)")
    if not bool(torch.isfinite(packed_loss)):
        fail(f"lora: packed step loss {packed_loss.item()}")
    print(f"lora: packed step over {len(docs)} documents ({pk.n_blocks} blocks of {s}; "
          f"first {b} rows): loss {packed_loss.item():.5f}, real_token_fraction "
          f"{frac:.4f}, {packed_ms:.1f} ms, flash launches {packed_launches} (packed "
          f"attention is the dense masked path, as in the reference) [{card}]", flush=True)
    del px, py, packed_loss
    opt.zero_grad(set_to_none=True)
    for p in pipe.parameters():
        p.grad = None
    del opt
    torch.cuda.empty_cache()

    # Decode with the adapters unmerged, then merged.
    prompt = x[:4].contiguous()
    gen_model = tg.mpmd_params_for_generation(pipe, head=loss_layer)
    tfa.reset_launches()
    t0 = time.perf_counter()
    out = tg.generate(cfg, gen_model, prompt, new_tokens)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = kernel_launches(tfa)
    expect_launches(gen_launches, {"flash_fwd": n, "flash_decode": n * new_tokens},
                    "LoRA generate (adapters unmerged)")
    agree_u, gap_u = teacher_forced(torch, gen_model, prompt, out)
    mcfg, merged = lora.merge_lora(cfg, gen_model)
    out_m = tg.generate(mcfg, merged, prompt, new_tokens)
    same = int((out_m == out).sum())
    # Merging rounds w + (A @ B) alpha/r to bf16 once (half an ulp of w,
    # 2^-9 relative), where the unmerged path rounds h @ w and the
    # adapter's product separately: perturbations of the size of the two
    # attention paths' in phase 6 (~0.1 of the logits), so every unmerged
    # token must stand within phase 6's 0.3 of the merged forward's max
    # logit too, and the greedy streams may part at a near-tie.  The
    # trained head's logits reach |x| >= 8, where a bf16 ulp is 2^-4,
    # twice phase 6's: about twice as many positions sit within one ulp
    # of a tie, so the argmax agreement floor falls as the int8 cache's
    # does, to 0.85.
    agree_m, gap_m = teacher_forced(torch, merged, prompt, out)
    with torch.inference_mode():
        top = merged(torch.cat([prompt, out[:, :-1]], 1))[:, s - 1:].float().amax(-1)
        top = (top.min().item(), top.max().item())
    if min(agree_u, agree_m) < TF_AGREE_INT8 or max(gap_u, gap_m) > TF_GAP:
        fail(f"lora generate: teacher-forced agreement unmerged {agree_u:.3f} / merged "
             f"{agree_m:.3f} (>= {TF_AGREE_INT8}), worst gap {gap_u:.3f} / {gap_m:.3f} "
             f"(<= {TF_GAP})")
    print(f"lora: generate 4 x prompt {s}, {new_tokens} greedy tokens with the adapters "
          f"unmerged in {gen_s:.2f}s, launches {gen_launches}; merge_lora + "
          f"mpmd_params_for_generation: {same} of {out.numel()} merged tokens equal the "
          f"unmerged ones; the unmerged tokens under the unmerged / merged model's "
          f"teacher-forced forward: argmax agreement {agree_u:.4f} / {agree_m:.4f}, "
          f"worst gap {gap_u:.4f} / {gap_m:.4f} (bounds {TF_AGREE_INT8}, {TF_GAP}); the "
          f"merged forward's max logit per position {top[0]:.2f}-{top[1]:.2f} "
          f"[{card}]",
          flush=True)
    del merged, gen_model, pipe, model, loss_layer, base, moving, out, out_m
    torch.cuda.empty_cache()
    return {"launches": launches, "packed_launches": packed_launches,
            "generate_launches": gen_launches, "step_ms": med, "peak_gib": peak,
            "packed_ms": packed_ms}


# Phases 16-17: benchmarks/unet_speed.py's row pipeline-2 (192x192, batch
# 160, 8 micro-batches, 2 stages, 'except_last'), float32; the spatial
# dropouts (0.1) live.  Its (5, 64) U-Net is cut to depth 4 (the widths
# of the levels kept are the row's), so that the whole run stays within
# half its time limit as phases 18-21 joined.
UNET_ROW = dict(depth=4, num_convs=5, base_channels=64)


def unet_loss(out, target):
    return (out - target).square().mean()


def phase_unet(torch, tfa, card, seed: int):
    """U-Net and VGG16 with dropout: eager steps bitwise repeatable under
    one key, 'never' and 'except_last' bitwise equal under one key, and
    ``fused=True`` replays bitwise the eager steps of their keys with a
    new key on each replay and one capture."""
    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models.unet import unet
    from torchgpipe_tpu_torch.models.vgg import vgg16

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    layers = list(unet(**UNET_ROW, device="cuda", generator=gen))
    n_layers = len(layers)
    balance = [n_layers // 2, n_layers - n_layers // 2]
    b, chunks, size = 160, 8, 192
    x = torch.randn(b, 3, size, size, device="cuda", generator=gen)
    y = torch.zeros(b, 1, size, size, device="cuda")
    n_params = sum(p.numel() for layer in layers for p in layer.parameters())

    def grads_of(pipe, rng, xx=x, yy=y, loss_fn=unet_loss):
        loss, _, _ = pipe.value_and_grad(xx, yy, loss_fn, rng=rng)
        return [loss.detach().clone()] + clone_all([p.grad for p in pipe.parameters()])

    pipe = GPipe(layers, balance, chunks=chunks, checkpoint="except_last")
    tfa.reset_launches()
    r1 = grads_of(pipe, 1)
    torch.cuda.synchronize()
    launches = kernel_launches(tfa)
    expect_launches(launches, {}, "a U-Net step (cuDNN convolutions)")
    r1b, r2 = grads_of(pipe, 1), grads_of(pipe, 2)
    if bitwise(torch, r1b, r1) or not bitwise(torch, r2, r1):
        fail(f"unet: two eager steps with one key differ ({bitwise(torch, r1b, r1)[:4]}) or "
             f"another key draws the same (loss {r2[0].item()} vs {r1[0].item()})")
    del r1b
    # 'never' keeps every cell's graph: at batch 40 (8 micro-batches of 5).
    sub = {}
    for mode in ("never", "except_last"):
        p = GPipe(layers, balance, chunks=chunks, checkpoint=mode)
        sub[mode] = grads_of(p, 1, x[:40], y[:40])
        del p
    bad = bitwise(torch, sub["except_last"], sub["never"])
    if bad:
        fail(f"unet: 'except_last' differs from 'never' under one key at batch 40: {bad[:8]}")
    del sub
    fpipe = GPipe(layers, balance, chunks=chunks, checkpoint="except_last", fused=True)
    for what, key, want in (("warm-up", 1, r1), ("replay", 2, r2), ("replay", 1, r1)):
        got = grads_of(fpipe, key)
        bad = bitwise(torch, got, want)
        if bad:
            fail(f"unet: the fused {what} with key {key} differs from the eager step: "
                 f"{bad[:8]} (loss {got[0].item()} vs {want[0].item()})")
        del got
    stats = dict(fpipe.graph_stats)
    if stats["captures"] != 1 or stats["replays"] != 2:
        fail(f"unet: graph stats {stats}, expected one capture and two replays")
    del r1, r2
    for p in pipe.parameters():
        p.grad = None
    eager_ms = timed_steps(torch, lambda: pipe.value_and_grad(x, y, unet_loss, rng=3), 1)
    replay_ms = timed_steps(torch, lambda: fpipe.value_and_grad(x, y, unet_loss, rng=4), 1)
    ew, eb, _ = profile(torch, card, "unet eager step",
                        lambda: pipe.value_and_grad(x, y, unet_loss, rng=5), top=6)
    rw, rb, _ = profile(torch, card, "unet replay",
                        lambda: fpipe.value_and_grad(x, y, unet_loss, rng=6), top=6)
    if fpipe.graph_stats["captures"] != 1:
        fail(f"unet: new keys added a capture: {fpipe.graph_stats}")
    e_ms, r_ms = statistics.median(eager_ms), statistics.median(replay_ms)
    print(f"unet: unet_speed.py pipeline-2 ({n_params / 1e6:.1f}M params, {n_layers} "
          f"layers, balance {balance}, batch {b} x {size}x{size}, chunks {chunks}, "
          f"except_last, float32, Dropout2d(0.1) live, cuDNN deterministic): two eager "
          f"steps with one key bitwise equal, another key differs; 'never' and "
          f"'except_last' bitwise equal under one key (batch 40); fused warm-up (key 1) and "
          f"replays (keys 2, 1) bitwise the eager steps, captures {stats['captures']} in "
          f"{stats['capture_s']:.2f}s; step_ms eager {e_ms:.1f} "
          f"({[round(t, 1) for t in eager_ms]}) = {b * 1e3 / e_ms:.1f} samples/s, replay "
          f"{r_ms:.1f} ({[round(t, 1) for t in replay_ms]}) = {b * 1e3 / r_ms:.1f} "
          f"samples/s; idle_share eager {1 - eb / ew:.3f}, replay {1 - rb / rw:.3f}; "
          f"launches {launches} [{card}]", flush=True)
    out = {"launches": launches, "eager_ms": e_ms, "replay_ms": r_ms,
           "eager_idle": 1 - eb / ew, "replay_idle": 1 - rb / rw,
           "layers": layers, "balance": balance, "x": x, "y": y}
    del fpipe, pipe
    torch.cuda.empty_cache()

    # VGG16 at 224x224, batch 64: one eager step and one replayed step.
    vlayers = vgg16(1000, device="cuda", generator=gen)
    vb = 64
    vx = torch.randn(vb, 3, 224, 224, device="cuda", generator=gen)
    vy = torch.randint(0, 1000, (vb,), device="cuda", generator=gen)
    ce = lambda o, t: F.cross_entropy(o, t)  # noqa: E731
    vbal = [len(vlayers) // 2, len(vlayers) - len(vlayers) // 2]
    veager = GPipe(vlayers, vbal, chunks=4, checkpoint="except_last")
    vfused = GPipe(vlayers, vbal, chunks=4, checkpoint="except_last", fused=True)
    tfa.reset_launches()
    vref = grads_of(veager, 7, vx, vy, ce)
    torch.cuda.synchronize()
    vlaunches = kernel_launches(tfa)
    expect_launches(vlaunches, {}, "a VGG16 step")
    grads_of(vfused, 7, vx, vy, ce)                       # warm-up and capture
    t0 = time.perf_counter()
    vgot = grads_of(vfused, 7, vx, vy, ce)                # replay
    torch.cuda.synchronize()
    v_ms = (time.perf_counter() - t0) * 1e3
    bad = bitwise(torch, vgot, vref)
    if bad or vfused.graph_stats["replays"] != 1:
        fail(f"vgg16: the replayed step differs from the eager step: {bad[:8]}; "
             f"{vfused.graph_stats}")
    print(f"vgg16: 224x224, batch {vb}, chunks 4, balance {vbal}, except_last, dropout 0.5 "
          f"live: eager step and replayed step (key 7) bitwise equal (loss "
          f"{vref[0].item():.5f}, {len(vref) - 1} gradients); replay {v_ms:.1f} ms wall "
          f"({vb * 1e3 / v_ms:.1f} samples/s); launches {vlaunches} [{card}]", flush=True)
    out["vgg_launches"] = vlaunches
    del veager, vfused, vlayers, vref, vgot, vx, vy
    torch.cuda.empty_cache()
    return out


def phase_timeline(torch, card, unet_row):
    """The U-Net of phase 16 under ``Timeline(sync=False)`` and
    ``Timeline(sync=True)``, as benchmarks/unet_timeline.py drives them:
    samples/s each way, the per-stage summary, and ``simulate_pipeline``'s
    makespan and bubble against the analytic (n - 1) / (m + n - 1)."""
    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.utils.tracing import Timeline, simulate_pipeline

    layers, balance, x, y = (unet_row[k] for k in ("layers", "balance", "x", "y"))
    chunks, steps, n = 8, 2, len(balance)
    rates, sim = {}, None
    for mode in ("pipelined", "serialized"):
        tracer = Timeline(sync=mode == "serialized")
        pipe = GPipe(layers, balance, chunks=chunks, checkpoint="except_last", tracer=tracer)
        torch.cuda.synchronize()   # phase 16 ran these shapes: no warm-up step
        t0 = time.perf_counter()
        for k in range(steps):
            pipe.value_and_grad(x, y, unet_loss, rng=2 + k)
        torch.cuda.synchronize()
        rates[mode] = x.shape[0] * steps / (time.perf_counter() - t0)
        want = steps * (2 * chunks * n + 1)
        if len(tracer.events) != want:
            fail(f"timeline: {len(tracer.events)} events in {mode} mode, expected {want}")
        print(f"timeline ({mode}): {rates[mode]:.1f} samples/s [{card}]\n"
              + tracer.summary(), flush=True)
        if mode == "serialized":
            sim = simulate_pipeline(tracer.events, n)
        del pipe
    if sim is None:
        fail("timeline: simulate_pipeline found no cells")
    makespan, busy, bubble = sim
    analytic = (n - 1) / (chunks + n - 1)
    print(f"timeline: simulate_pipeline fill_drain makespan {makespan * 1e3:.1f} ms a "
          f"step, busy {busy:.3f}, bubble {bubble:.3f} against the analytic "
          f"(n-1)/(m+n-1) = {analytic:.3f} (n={n}, m={chunks}); overlap speedup "
          f"{rates['pipelined'] / rates['serialized']:.2f}x [{card}]", flush=True)
    return {"makespan_ms": makespan * 1e3, "bubble": bubble, "analytic": analytic,
            "samples_per_s": rates}


# Phase 18: ViT-L/16 (Dosovitskiy et al. 2020, Table 1), bf16 weights,
# benchmarks/vit_speed.py row pipeline-2: batch 512, 8 micro-batches, 2
# stages on one card, 'except_last', SGD.  A step launches 8 x 24 forward
# kernels, 7 x 24 again in the checkpointed cells' recompute, and 8 x 24
# of each backward kernel.  lr 0.25 for bf16 weights: at 1.0 (TRAIN_LR,
# whose updates survive bf16 rounding more often) the first step took the
# loss from 7.280 to 6.991 and the second overshot to 7.415 (NVIDIA H100
# 80GB HBM3, 700 W, seed 0).
VIT_L16 = dict(image_size=224, patch_size=16, dim=1024, depth=24, n_heads=16,
               num_classes=1000)
VIT_BATCH, VIT_CHUNKS, VIT_LR = 512, 8, 0.25
VIT_LAUNCHES = {"flash_fwd": 8 * 24 + 7 * 24, "flash_bwd_dq": 8 * 24, "flash_bwd_dkv": 8 * 24}


def phase_vit(torch, tfa, card, seed: int):
    """ViT-L/16 training through the non-causal flash kernels: the
    attention of one micro-batch's first block, at its real activations,
    held against the plain backward row by row; then three SGD steps of
    the 2-stage pipeline with their launch counts, samples/s, peak and a
    profiled step's idle share."""
    import functools

    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.models.vit import vit

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    layers = list(vit(**VIT_L16, dtype=torch.bfloat16, device="cuda", generator=gen))
    b, chunks, mb = VIT_BATCH, VIT_CHUNKS, VIT_BATCH // VIT_CHUNKS
    x = torch.randn(b, 3, 224, 224, device="cuda", generator=gen)
    y = torch.randint(0, 1000, (b,), device="cuda", generator=gen)

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float(), tgt)

    with torch.no_grad():
        blk = layers[1]
        q, k, v = (t.contiguous() for t in tt._block_qkv(
            blk.cfg, blk.params(), layers[0](x[:mb]), 0))
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    scale = q.shape[-1] ** -0.5
    kw = dict(causal=False, sm_scale=scale, window=None)
    o, lse = tfa._flash_fwd(q, k, v, False, scale, None)
    ro = tfa.flash_attention_reference(q, k, v, causal=False)
    delta = tfa._delta(do, o)
    got = (tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    want = tfa._reference_bwd(q, k, v, o, lse, do, False, scale, None)
    err = (o.float() - ro.float()).abs().max().item()
    rows = {n: bwd_rows(g, w)[0] for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    if not err <= FWD_TOL or not all(r <= 1.0 for r in rows.values()):
        fail(f"vit_l16 block-0 attention at micro-batch 0: forward err {err} (tol "
             f"{FWD_TOL}), worst row err/tol {rows}")
    print(f"vit_l16: block-0 attention of micro-batch 0 ({tuple(q.shape)}, no causal mask) "
          f"against the plain version: forward max_abs_err={err:.3e} (tol {FWD_TOL}), "
          f"gradients worst row err/tol {({n: round(r, 3) for n, r in rows.items()})} "
          f"[{card}]", flush=True)
    del q, k, v, do, o, lse, ro, delta, got, want

    pipe = GPipe(layers, [13, 13], chunks=chunks, checkpoint="except_last")
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=VIT_LR), loss_fn)
    losses, ms = [], []
    for _ in range(3):
        (loss, _), stats = step_with_peak(torch, tfa, pipe, lambda: step(x, y))
        expect_launches(stats["launches"], VIT_LAUNCHES, "a ViT-L/16 step")
        losses.append(loss.item())
        ms.append(stats["ms"])
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"ViT-L/16 SGD: loss did not fall on the fixed batch: {losses}")
    wall, busy, _ = profile(torch, card, "vit_l16 step", lambda: step(x, y), top=8)
    med = statistics.median(ms)
    n_params = sum(p.numel() for p in pipe.parameters())
    print(f"vit_l16: {len(layers)} layers, {n_params / 1e6:.2f}M params bf16, batch {b} x "
          f"224^2 (196 patches), chunks {chunks}, balance [13, 13] on one card, "
          f"except_last, SGD lr {VIT_LR}: losses {[round(v, 5) for v in losses]}; "
          f"launches a step {stats['launches']} (predicted {VIT_LAUNCHES}); "
          f"step_ms={med:.1f} (steps {[round(t, 1) for t in ms]}) "
          f"samples_per_s={b * 1e3 / med:.1f} max_memory_allocated="
          f"{stats['peak_gib']:.2f}GiB idle_share={1 - busy / wall:.3f} [{card}]", flush=True)
    del pipe, step, layers, x
    torch.cuda.empty_cache()
    return {"launches": stats["launches"], "step_ms": med, "samples_per_s": b * 1e3 / med,
            "peak_gib": stats["peak_gib"], "idle_share": 1 - busy / wall,
            "row_check": rows}


# Phase 19: AmoebaNet-D (18, 256), benchmarks/amoebanetd_speed.py row n2m4:
# batch 256, 4 micro-batches, balance [9, 15], 'except_last', float32, TF32
# off, SGD with momentum 0.9.  Halved (and the cut printed) if it does not
# fit.  The loss of the fixed batch is printed, not gated: at this init the
# 18-cell BatchNorm stack's first steps move it either way (NVIDIA H100
# 80GB HBM3, 700 W, seed 0: 7.009 -> 7.268 -> 7.465 at lr 0.1, 7.009 ->
# 7.184 -> 7.128 at 0.01; on the CPU at 96x96, batch 8, it rose at 1e-3 as
# well), while the cut-down model's falls (tests/test_torch_amoebanet.py
# holds its gradients to the reference's).  The gate is the 2-stage step
# against the 1-stage one.
AMOEBA = dict(num_classes=1000, num_layers=18, num_filters=256)
AMOEBA_BATCH, AMOEBA_CHUNKS, AMOEBA_BALANCE, AMOEBA_LR = 256, 4, [9, 15], 0.01


def phase_amoebanet(torch, tfa, card, seed: int):
    """AmoebaNet-D (18, 256) at 224x224 through the 2-stage pipeline on
    one card: its step (loss, every gradient, every BatchNorm buffer)
    against the 1-stage pipeline's from the same weights (the ``(x,
    skip)`` tuple crosses the cut), three SGD steps, samples/s, peak, a
    profiled step's idle share, and no hand-written kernel launched."""
    import functools

    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models.amoebanet import amoebanetd

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    layers = amoebanetd(**AMOEBA, device="cuda", generator=gen)
    n = len(layers)
    snapshot = [{k: v.clone() for k, v in layer.state_dict().items()} for layer in layers]

    def restore():
        for layer, state in zip(layers, snapshot):
            layer.load_state_dict(state)

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float(), tgt)

    def run(b):
        x = torch.randn(b, 3, 224, 224, device="cuda", generator=gen)
        x = x.contiguous(memory_format=torch.channels_last)
        y = torch.randint(0, 1000, (b,), device="cuda", generator=gen)
        res = {}
        for tag, bal in (("two_stage", AMOEBA_BALANCE), ("one_stage", [n])):
            restore()
            pipe = GPipe(layers, bal, chunks=AMOEBA_CHUNKS, checkpoint="except_last")
            (loss, _, _), stats = step_with_peak(
                torch, tfa, pipe, lambda: pipe.value_and_grad(x, y, loss_fn))
            expect_launches(stats["launches"], {}, f"an AmoebaNet-D step at {bal}")
            res[tag] = (loss.item(), [p.grad.clone() for p in pipe.parameters()],
                        [t.clone() for t in pipe.buffers()], stats)
            del pipe
        restore()
        pipe = GPipe(layers, AMOEBA_BALANCE, chunks=AMOEBA_CHUNKS, checkpoint="except_last")
        step = pipe.make_train_step(functools.partial(
            torch.optim.SGD, lr=AMOEBA_LR, momentum=RESNET_MOMENTUM), loss_fn)
        losses, ms = [], []
        for _ in range(3):
            (loss, _), stats = step_with_peak(torch, tfa, pipe, lambda: step(x, y))
            expect_launches(stats["launches"], {}, "an AmoebaNet-D SGD step")
            losses.append(loss.item())
            ms.append(stats["ms"])
        return x, y, res, pipe, step, losses, ms, stats

    b = AMOEBA_BATCH
    while True:
        try:
            x, y, res, pipe, step, losses, ms, stats = run(b)
            break
        except torch.cuda.OutOfMemoryError:
            for p in (q for layer in layers for q in layer.parameters()):
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            if b <= AMOEBA_BATCH // 8:
                fail(f"AmoebaNet-D (18, 256) does not fit at batch {b}")
            print(f"amoebanetd: batch {b} exceeds the card; cut to {b // 2}", flush=True)
            b //= 2
    # As phase 11: the stage cut changes no operation, so the loss agrees
    # to float32 rounding (1e-6 relative), each gradient leaf to 1e-4 of
    # its max |grad| (cuDNN's weight-gradient kernels add with atomics in
    # any order), the buffers to 1e-6 of max(|value|, 1).
    (l2, g2, b2, _), (l1, g1, b1, s1) = res["two_stage"], res["one_stage"]
    gworst = max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
                 for a, c in zip(g2, g1))
    bworst = max(((a.double() - c.double()).abs().max()
                  / c.double().abs().max().clamp_min(1.0)).item() for a, c in zip(b2, b1))
    if not math.isfinite(l2) or abs(l2 - l1) > 1e-6 * abs(l1) or gworst > 1e-4 \
            or bworst > 1e-6:
        fail(f"AmoebaNet-D at {AMOEBA_BALANCE} vs one stage: loss {l2} vs {l1}, worst grad "
             f"diff {gworst:.3e} (tol 1e-4), worst buffer diff {bworst:.3e} (tol 1e-6)")
    del res, g1, g2, b1, b2
    if not all(math.isfinite(v) for v in losses):
        fail(f"AmoebaNet-D SGD: a loss is not finite: {losses}")
    tfa.reset_launches()
    wall, busy, _ = profile(torch, card, "amoebanetd step", lambda: step(x, y), top=8)
    expect_launches(kernel_launches(tfa), {}, "the profiled AmoebaNet-D step")
    med = statistics.median(ms)
    n_params = sum(p.numel() for p in pipe.parameters())
    print(f"amoebanetd: (18, 256), {n} layers, {n_params / 1e6:.2f}M params float32, "
          f"batch {b} (n2m4's {AMOEBA_BATCH}) x 224^2, chunks {AMOEBA_CHUNKS}, balance "
          f"{AMOEBA_BALANCE} on one card, except_last, TF32 off: loss {l2:.6f} vs one "
          f"stage {l1:.6f}, grad diff {gworst:.2e}, buffer diff {bworst:.2e}; SGD lr "
          f"{AMOEBA_LR} momentum {RESNET_MOMENTUM} x3: losses {[round(v, 5) for v in losses]} "
          f"(not gated); step_ms={med:.1f} (steps {[round(t, 1) for t in ms]}) "
          f"samples_per_s={b * 1e3 / med:.1f} max_memory_allocated="
          f"{stats['peak_gib']:.2f}GiB (one-stage step {s1['peak_gib']:.2f}GiB) "
          f"idle_share={1 - busy / wall:.3f} [{card}]", flush=True)
    del pipe, step, layers, x, snapshot
    torch.cuda.empty_cache()
    return {"launches": stats["launches"], "batch": b, "step_ms": med,
            "samples_per_s": b * 1e3 / med, "peak_gib": stats["peak_gib"],
            "idle_share": 1 - busy / wall}


# Phase 20: t5-base width (Raffel et al. 2020; HF t5-base config.json:
# vocab 32128, d_model 768, 12 + 12 layers, 12 heads, d_ff 3072, relu,
# tied), bf16: a 2-stage training step (encoder 512 / decoder 128 tokens,
# batch 32, 4 micro-batches, cut at the encoder's end), then greedy
# t5_generate (batch 8, 64 tokens).
T5_BASE = dict(vocab=32128, dim=768, n_enc_layers=12, n_dec_layers=12, n_heads=12,
               mlp_hidden=3072, act="relu", tie_word_embeddings=True)
T5_BATCH, T5_CHUNKS, T5_SE, T5_SD, T5_LR = 32, 4, 512, 128, 0.1


def phase_t5(torch, tfa, card, seed: int):
    """T5 through the pipeline (the tuple carrier and the batch-1 bias
    carriers across the cut), its step-1 loss against the unpipelined
    forward, two SGD steps; greedy ``t5_generate`` whose tokens must be
    the teacher-forced forward's argmax (up to bf16 near-ties)."""
    import functools

    import torch.nn.functional as F

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models import t5

    cfg = t5.T5Config(**T5_BASE, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    layers = t5.t5_layers(cfg, device="cuda", generator=gen)
    enc = torch.randint(0, cfg.vocab, (T5_BATCH, T5_SE), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab, (T5_BATCH, T5_SD), device="cuda", generator=gen)
    dec = t5.t5_shift_right(cfg, labels)

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float().flatten(0, 1), tgt.flatten())

    with torch.no_grad():
        h = (enc, dec)
        for layer in layers:
            h = layer(h)
        plain_loss = loss_fn(h, labels).item()
        del h
    cut = 2 + cfg.n_enc_layers    # embed, encoder, enc_final | decoder, final
    pipe = GPipe(layers, [cut, len(layers) - cut], chunks=T5_CHUNKS,
                 checkpoint="except_last")
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=T5_LR), loss_fn)
    losses, ms, launches = [], [], {}
    for _ in range(2):
        (loss, _), stats = step_with_peak(torch, tfa, pipe, lambda: step((enc, dec), labels))
        expect_launches(stats["launches"], {}, "a T5 step")
        losses.append(loss.item())
        ms.append(stats["ms"])
    # bf16 logits of scale ~0.05 (the tied head's dim^-1/2): the pipeline
    # changes no operation, only the micro-batch split of the loss's mean.
    if not all(math.isfinite(v) for v in losses) or abs(losses[0] - plain_loss) > 1e-2:
        fail(f"T5 step-1 loss {losses[0]} vs unpipelined {plain_loss} (tol 1e-2)")
    tokens = T5_BATCH * (T5_SE + T5_SD)
    print(f"t5: t5-base width, {sum(p.numel() for p in pipe.parameters()) / 1e6:.2f}M "
          f"params bf16, batch {T5_BATCH} x (enc {T5_SE} + dec {T5_SD}), chunks {T5_CHUNKS}, "
          f"balance {pipe.balance}, except_last, SGD lr {T5_LR}: losses "
          f"{[round(v, 5) for v in losses]} (unpipelined {plain_loss:.5f}); step_ms="
          f"{ms[-1]:.1f} tokens_per_s={tokens * 1e3 / ms[-1]:.0f} max_memory_allocated="
          f"{stats['peak_gib']:.2f}GiB [{card}]", flush=True)
    launches["train_step"] = stats["launches"]
    del pipe, step

    src = enc[:8]
    t5.t5_generate(cfg, layers, src[:, :64], 2)   # warm-up
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.perf_counter()
    out = t5.t5_generate(cfg, layers, src, 64)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches["generate"] = kernel_launches(tfa)
    expect_launches(launches["generate"], {}, "t5_generate")
    with torch.no_grad():
        h = (src, t5.t5_shift_right(cfg, out))
        for layer in layers:
            h = layer(h)
        logits = h.float()
    agree = (logits.argmax(-1) == out).float().mean().item()
    gap = logits.max(-1).values - logits.gather(-1, out[..., None])[..., 0]
    # A position where the two differ must be a bf16 near-tie: the final
    # product rounds each logit once (2^-9 of |x|), and the decoder's bf16
    # states differ by a few roundings between the cached and the full
    # path: 2^-6 of the position's max |logit| (two to four bf16 ulps).
    tie = 2.0 ** -6 * logits.abs().amax(-1)
    if agree < TF_AGREE or not bool((gap <= tie).all()):
        fail(f"t5_generate vs teacher forcing: argmax agreement {agree:.3f} (floor "
             f"{TF_AGREE}), worst gap/tie {(gap / tie).max().item():.3f}")
    print(f"t5: greedy t5_generate batch 8 x enc {T5_SE}, 64 tokens in {gen_s:.2f}s "
          f"({gen_s * 1e3 / 64:.2f} ms/token); tokens equal the teacher-forced argmax at "
          f"{agree:.4f} of positions, worst gap {gap.max().item():.3e} (<= 2^-6 of the "
          f"max |logit| everywhere) [{card}]", flush=True)
    del layers, logits
    torch.cuda.empty_cache()
    return {"launches": {k: sum(v[k] for v in launches.values())
                         for k in launches["train_step"]},
            "step_ms": ms[-1], "agree": agree}


# Phase 21: GPT-2 XL as HF gpt2-xl's config.json gives it (n_embd 1600,
# n_layer 48, n_head 25, n_positions 1024, vocab 50257, gelu_new, tied,
# layer_norm_epsilon 1e-5), transcribed as models/hf_interop.py maps it,
# bf16, random weights: 4 prompts of 512, 64 greedy tokens.
GPT2_XL = dict(vocab=50257, dim=1600, n_layers=48, n_heads=25, mlp_ratio=4.0,
               norm_eps=1e-5, norm="layernorm", pos_emb="learned", max_pos=1024,
               mlp_impl="classic", act="gelu_tanh", attn_bias=True, attn_out_bias=True,
               tie_embeddings=True)
GPT2_PROMPT, GPT2_NEW = 512, 64


def phase_gpt2_xl(torch, tfa, tt, tg, card, seed: int):
    """Greedy ``generate`` on the tied, learned-position GPT-2 XL: one
    ``flash_fwd`` a layer in the prefill and one ``flash_decode`` a layer
    a token at MHA (one query row per kv head), the tokens against a
    teacher-forced forward, ms/token."""
    cfg = tt.TransformerConfig(**GPT2_XL, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    model = tt.llama_tied(cfg, device="cuda", generator=gen)
    prompt = torch.randint(0, cfg.vocab, (4, GPT2_PROMPT), device="cuda", generator=gen)
    out, _, launches, times = timed_generate(torch, tfa, tg, cfg, model, prompt,
                                             GPT2_NEW, 2)
    expect_launches(launches, {"flash_fwd": cfg.n_layers,
                               "flash_decode": cfg.n_layers * GPT2_NEW},
                    "GPT-2 XL generate")
    agree, gap = teacher_forced(torch, model, prompt, out)
    if agree < TF_AGREE or gap > TF_GAP:
        fail(f"GPT-2 XL generate vs teacher forcing: agreement {agree:.3f} (floor "
             f"{TF_AGREE}), gap {gap:.3f} (tol {TF_GAP})")
    dec_ms = statistics.median(times["decode_ms"]) / GPT2_NEW
    print(f"gpt2_xl_generate: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params bf16 (tied), batch 4 x prompt {GPT2_PROMPT}, {GPT2_NEW} greedy tokens: "
          f"launches {launches}; prefill_ms={statistics.median(times['prefill_ms']):.1f} "
          f"decode ms/token={dec_ms:.2f} tokens_per_s={4 * 1e3 / dec_ms:.1f} "
          f"max_memory_allocated={times['peak'] / 2**30:.2f}GiB; teacher-forced argmax "
          f"agreement {agree:.4f}, gap {gap:.4f} (floor {TF_AGREE}, tol {TF_GAP}) "
          f"[{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "decode_ms_per_token": dec_ms}



# Phase 9b: weight-only int8 on phase 6's model (models.quant).  The
# dequantize-then-GEMM path reads the int8 bytes and writes and reads a
# bf16 copy of every matrix a step, so it may be slower than bf16: the
# times are what the card shows, not a gate.  The tokens are held to the
# bf16 model's teacher-forced forward with the int8 cache's limits: a
# weight's error is at most half a quantization step (amax/254 of its
# output channel), RMS ~0.9% of the channel's RMS (amax ~3.9 RMS over
# 4096 inputs), close to the int8 cache's ~0.7% per cached row.
def phase_int8_weights(torch, tfa, tg, card, seed, cfg, model, prompt, bf16_out,
                       bf16_times, serving, new_tokens: int = 128):
    """``quantize_params_int8`` of phase 6's model: its bytes against the
    bf16 model's 16.06 GB, ``generate`` at phase 6's shape (launches,
    ms/token beside phase 6's, the teacher-forced check, agreement with
    phase 6's tokens), and the serving Engine's captured decode step at 8
    slots beside phase 9's bf16 step."""
    import numpy as np

    from torchgpipe_tpu_torch.models import quant as tq
    from torchgpipe_tpu_torch.serving import Engine

    b, s = prompt.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = tq.quantize_params_int8(cfg, model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qb, fb = tq.quantized_bytes(qmodel, torch.bfloat16)
    bf16_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rest = sum(p.numel() * p.element_size() for p in qmodel.parameters())
    channels = sum(v["sc"].numel() for layer in qmodel for v in layer.params().values()
                   if tq.is_quantized(v))
    # Exact byte identities: the quantized leaves' bf16 bytes and the rest
    # make the bf16 model; int8 is half of bf16 plus a float32 per channel.
    if fb + rest != bf16_bytes or 2 * (qb - 4 * channels) != fb:
        fail(f"int8_weights: bytes {qb} int8 / {fb} as bf16 / {rest} unquantized do not "
             f"add up to the bf16 model's {bf16_bytes}")
    out, _, launches, times = timed_generate(torch, tfa, tg, cfg, qmodel, prompt,
                                             new_tokens, 1)
    expect_launches(launches, {"flash_fwd": cfg.n_layers,
                               "flash_decode": cfg.n_layers * new_tokens},
                    "generate with int8 weights")
    agree, gap = teacher_forced(torch, model, prompt, out)
    if agree < TF_AGREE_INT8 or gap > TF_GAP_INT8:
        fail(f"int8-weight tokens vs the bf16 teacher-forced forward: argmax agreement "
             f"{agree:.3f} (>= {TF_AGREE_INT8} needed), worst logit gap {gap:.3f} "
             f"(<= {TF_GAP_INT8})")
    same = (out == bf16_out).float().mean().item()
    dec = statistics.median(times["decode_ms"]) / new_tokens
    bf16_dec = statistics.median(times_b / new_tokens for times_b in bf16_times["decode_ms"])

    # The Engine's captured decode step at phase 9's shape (8 slots, max_len
    # 1152, ladder (8, 64, 256), phase 9's first 8 trace prompts).
    eng = Engine(cfg, qmodel, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 prefill_chunk=SERVE_LADDER)
    tfa.reset_launches()
    for p, _ in serving_trace(np, seed, cfg.vocab)[:SERVE_SLOTS]:
        eng.submit(p, 100)
    while eng.scheduler.queue or eng.scheduler.prefill_pending():
        eng.step()
    steps = step_ms(torch, eng, 6) + step_ms(torch, eng, 6)
    wall, busy, _ = profile(torch, card, "int8-weight serving decode x8",
                            lambda: [eng.step() for _ in range(8)], top=6)
    torch.cuda.synchronize()
    expect_launches(kernel_launches(tfa), {}, "the int8-weight serving engine")
    eng_ms = statistics.median(steps)
    row = {"quantize_s": quant_s, "quantized_bytes": qb, "quantized_leaves_bf16_bytes": fb,
           "unquantized_bytes": rest, "bf16_model_bytes": bf16_bytes,
           "int8_model_bytes": qb + rest, "launches": launches,
           "prefill_ms": statistics.median(times["prefill_ms"]),
           "decode_ms_per_token": dec, "bf16_decode_ms_per_token": bf16_dec,
           "teacher_forced_agree": agree, "teacher_forced_max_gap": gap,
           "token_agreement_with_bf16": same,
           "engine_decode_step_ms": eng_ms,
           "engine_decode_step_ms_bf16": serving["decode_step_ms"]["graph"]["median"],
           "engine_idle_share": 1 - busy / wall, "engine_compile_stats": eng.compile_stats,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card}
    print(f"int8_weights: quantize_params_int8 in {quant_s:.2f}s: {qb / 1e9:.4f} GB int8 "
          f"leaves with scales ({fb / 1e9:.4f} GB as bf16) + {rest / 1e9:.4f} GB "
          f"unquantized = {(qb + rest) / 1e9:.4f} GB against the bf16 model's "
          f"{bf16_bytes / 1e9:.4f} GB; generate b={b} prompt={s} new={new_tokens}: "
          f"launches {launches}, decode ms/token {dec:.3f} (bf16 {bf16_dec:.3f}), "
          f"teacher_forced_agree={agree:.4f} max_gap={gap:.4f} (floor {TF_AGREE_INT8}, "
          f"tol {TF_GAP_INT8}), token agreement with bf16 {same:.4f}; Engine captured "
          f"decode step at {SERVE_SLOTS} slots {eng_ms:.3f}ms (bf16, phase 9: "
          f"{row['engine_decode_step_ms_bf16']:.3f}ms), idle_share "
          f"{row['engine_idle_share']:.3f} [{card}]", flush=True)
    print(json.dumps({"int8_weights": row}), flush=True)
    del eng, qmodel, out
    torch.cuda.empty_cache()
    return row


# Phase 22: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
# config.json: hidden_size 4096, 32 attention heads, 8 key-value heads,
# intermediate_size 14336, vocab_size 32000, rope_theta 1e6, 8 local
# experts, 2 per token, router_aux_loss_coef 0.02), bf16, cut to 2 of its
# 32 blocks: 32 blocks are ~46.7B parameters (93 GB in bf16), 2 are ~3.2B.
# 4 blocks (6.1B) at first; the full run then took 647.7 s of its 600, on
# an NVIDIA H100 80GB HBM3 at 700 W.  mlp_ratio 5.25 gives the 14336
# hidden.  Dispatch 'dropless' as the reference's config_from_hf_mixtral
# chooses.
MIXTRAL = dict(vocab=32000, dim=4096, n_layers=2, n_heads=32, n_kv_heads=8,
               mlp_ratio=5.25, rope_theta=1e6)
MIXTRAL_MOE = dict(n_experts=8, top_k=2, dispatch="dropless", balance_weight=0.02)
MIXTRAL_BATCH, MIXTRAL_SEQ, MIXTRAL_CHUNKS = 8, 1024, 4
MIXTRAL_BALANCE = [2, 2]
MIXTRAL_PROMPT, MIXTRAL_NEW = 512, 32
# Launch gates, written before the phase first ran: a training step under
# except_last runs each block's forward once per micro-batch and again
# for the recomputed ones (chunks - 1), and one backward per micro-batch;
# generate runs one flash_fwd a block in the prefill and one flash_decode
# a block a token; the Engine's slot step reads its cache densely.
MIXTRAL_TRAIN_LAUNCHES = {"flash_fwd": 2 * (4 + 3), "flash_bwd_dq": 2 * 4,
                          "flash_bwd_dkv": 2 * 4}
MIXTRAL_GENERATE_LAUNCHES = {"flash_fwd": 2, "flash_decode": 2 * 32}
MIXTRAL_SERVE_LAUNCHES = {}
# Dropless against 'sparse' at capacity factor E/k (capacity = tokens: no
# drop): the same routing, gates and bf16 products, summed by another
# GEMM tiling (grouped products against batched ones).  The float32
# accumulators differ by ~1e-6 relative, which moves a bf16 rounding of a
# gate/up/down product by one ulp (2^-8 relative) at worst; the two
# choices' sum keeps that: 2^-6 of max |y| leaves a factor of 4.
MIXTRAL_DISPATCH_TOL = 2 ** -6
# Teacher forcing of the MoE generate: phase 6's limits, except that a
# token whose top-2 routing sits on a near-tie can take another expert in
# the cached path than in the full forward (their hidden states differ by
# bf16 roundings), which moves that position's logits by O(1): the gap
# must hold at 95% of the positions, the agreement floor is phase 6's.
MIXTRAL_GAP_SHARE = 0.95


def phase_mixtral(torch, tfa, tt, tg, card, seed: int):
    """Mixtral-8x7B width cut to 2 blocks: the 2-stage GPipe step against
    the 1-stage one (loss, every gradient), three SGD steps (step ms,
    tokens/s, peak, a profiled step's idle share), dropless against
    'sparse' at capacity factor E/k on block 1's real input (no drop),
    ``router_stats``, ``generate(moe=)`` and an ``Engine(moe=)`` whose
    captured replays equal its eager bodies; launch counts gated."""
    import functools

    import numpy as np

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.models import moe as tm
    from torchgpipe_tpu_torch.serving import Engine

    cfg = tt.TransformerConfig(**MIXTRAL, dtype=torch.bfloat16)
    moe = tm.MoEConfig(**MIXTRAL_MOE)
    if cfg.mlp_hidden != 14336 or cfg.head_dim != 128:
        fail(f"mixtral: hidden {cfg.mlp_hidden}, head dim {cfg.head_dim}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    t0 = time.perf_counter()
    layers = list(tm.llama_moe(cfg, moe, device="cuda", generator=gen))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for layer in layers for p in layer.parameters())
    build_s = time.perf_counter() - t0
    b, s, chunks = MIXTRAL_BATCH, MIXTRAL_SEQ, MIXTRAL_CHUNKS
    tokens = torch.from_numpy(
        np.random.default_rng(seed + 22).integers(0, cfg.vocab, (b, s))).cuda()
    loss_fn = causal_lm_loss(tt)
    out = {"card": card, "params": n_params, "build_s": build_s}

    # 22a. Two stages against one (phase 8b's check: the cut changes no
    # operation), each step's launches gated.
    res = {}
    for tag, bal in (("one_stage", [len(layers)]), ("two_stage", MIXTRAL_BALANCE)):
        pipe = GPipe(layers, bal, chunks=chunks, checkpoint="except_last")
        (loss, _, _), stats = step_with_peak(
            torch, tfa, pipe, lambda: pipe.value_and_grad(tokens, tokens, loss_fn))
        expect_launches(stats["launches"], MIXTRAL_TRAIN_LAUNCHES, f"a Mixtral step at {bal}")
        res[tag] = (loss.item(), [p.grad.clone() for p in pipe.parameters()], stats)
        del pipe
    (l1, g1, s1), (l2, g2, s2) = res["one_stage"], res["two_stage"]
    same = sum(torch.equal(a, c) for a, c in zip(g1, g2))
    worst = max(((a.float() - c.float()).abs().max()
                 / c.float().abs().max().clamp_min(1e-30)).item() for a, c in zip(g2, g1))
    if not math.isfinite(l2) or abs(l2 - l1) > 1e-6 * abs(l1) or worst > 2 ** -7:
        fail(f"mixtral at {MIXTRAL_BALANCE} vs one stage: loss {l2} vs {l1}, worst grad "
             f"diff {worst:.3e} of max |grad| (tol 2^-7)")
    router_grad = max(layer.mlp.router.grad.abs().max().item() for layer in layers[1:-1])
    del res, g1, g2
    for p in (q for layer in layers for q in layer.parameters()):
        p.grad = None
    torch.cuda.empty_cache()

    # 22b. make_train_step with SGD, three steps on the fixed batch.
    pipe = GPipe(layers, MIXTRAL_BALANCE, chunks=chunks, checkpoint="except_last")
    step = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=TRAIN_LR), loss_fn)
    losses, ms = [], []
    for _ in range(3):
        (loss, _), stats = step_with_peak(torch, tfa, pipe, lambda: step(tokens, tokens))
        expect_launches(stats["launches"], MIXTRAL_TRAIN_LAUNCHES, "a Mixtral SGD step")
        losses.append(loss.item())
        ms.append(stats["ms"])
    if not all(math.isfinite(v) for v in losses):
        fail(f"mixtral SGD: a loss is not finite: {losses}")
    wall, busy, _ = profile(torch, card, "mixtral step", lambda: step(tokens, tokens), top=8)
    train_launches = stats["launches"]
    med = statistics.median(ms)
    out["train"] = {"loss_one_stage": l1, "loss_two_stage": l2, "grad_leaves_bitwise": same,
                    "grad_leaves": len(list(pipe.parameters())),
                    "worst_grad_diff": worst, "router_grad_max": router_grad,
                    "sgd_losses": losses, "step_ms": med, "steps_ms": ms,
                    "tokens_per_s": b * s * 1e3 / med, "peak_gib": stats["peak_gib"],
                    "one_stage_peak_gib": s1["peak_gib"], "idle_share": 1 - busy / wall,
                    "launches": train_launches}
    del pipe, step
    for p in (q for layer in layers for q in layer.parameters()):
        p.grad = None
    torch.cuda.empty_cache()

    # 22c. Dropless against 'sparse' at capacity factor E/k on block 1's
    # input (block 0's output of micro-batch 0 through block 1's ln2),
    # and router_stats there.
    model = torch.nn.Sequential(*layers).eval()
    with torch.inference_mode():
        x1 = model[1](model[0](tokens[:b // chunks]))
        h = tt._block_norm(cfg, model[2].params(), "ln2", x1)
        p2 = model[2].mlp.params()
        y_drop = tm.moe_forward(moe, p2, h, train=False)
        sparse = dataclasses.replace(moe, dispatch="sparse",
                                     capacity_factor=moe.n_experts / moe.top_k)
        y_sparse = tm.moe_forward(sparse, p2, h, train=False)
        t = h.shape[0] * h.shape[1]
        probs = torch.softmax(h.reshape(t, -1).float() @ p2["router"], dim=-1)
        _, _, keep, _ = tm._sparse_assignment(probs, moe.top_k, tm.capacity_of(sparse, t))
        load, importance, balance = tm.router_stats(p2["router"], h, moe)
    derr = (y_drop.float() - y_sparse.float()).abs().max().item()
    dscale = y_sparse.float().abs().max().item()
    if not bool(keep.all()) or derr > MIXTRAL_DISPATCH_TOL * dscale:
        fail(f"mixtral: dropless vs sparse at capacity factor E/k: {int(keep.sum())} of "
             f"{keep.numel()} assignments kept, max diff {derr:.3e} of max |y| {dscale:.3e} "
             f"(tol {MIXTRAL_DISPATCH_TOL})")
    out["dispatch"] = {"tokens": t, "kept": int(keep.sum()), "assignments": keep.numel(),
                       "max_abs_diff": derr, "max_abs_y": dscale,
                       "router_stats": {"load": load.tolist(),
                                        "importance": importance.tolist(),
                                        "balance": balance.item()}}
    del x1, h, y_drop, y_sparse, probs, keep

    # 22d. generate(moe=): prefill one flash_fwd a block, decode one
    # flash_decode a block a token; the teacher-forced check.
    prompt = torch.randint(0, cfg.vocab, (4, MIXTRAL_PROMPT), device="cuda", generator=gen)
    gout, _, gen_launches, times = timed_generate(torch, tfa, tg, cfg, model, prompt,
                                                  MIXTRAL_NEW, 1, moe=moe)
    expect_launches(gen_launches, MIXTRAL_GENERATE_LAUNCHES, "Mixtral generate(moe=)")
    sq = torch.cat([prompt, gout[:, :-1]], dim=1)
    with torch.inference_mode():
        logits = model(sq)[:, MIXTRAL_PROMPT - 1:].float()
    agree = (logits.argmax(-1) == gout).float().mean().item()
    gaps = logits.max(-1).values - logits.gather(-1, gout[..., None])[..., 0]
    gap_share = (gaps <= TF_GAP).float().mean().item()
    if agree < TF_AGREE or gap_share < MIXTRAL_GAP_SHARE:
        fail(f"mixtral generate vs teacher forcing: agreement {agree:.3f} (floor "
             f"{TF_AGREE}), share of positions within {TF_GAP} of the max {gap_share:.3f} "
             f"(floor {MIXTRAL_GAP_SHARE})")
    dec = statistics.median(times["decode_ms"]) / MIXTRAL_NEW
    out["generate"] = {"batch": 4, "prompt": MIXTRAL_PROMPT, "new": MIXTRAL_NEW,
                       "launches": gen_launches,
                       "prefill_ms": statistics.median(times["prefill_ms"]),
                       "decode_ms_per_token": dec, "teacher_forced_agree": agree,
                       "gap_share": gap_share, "max_gap": gaps.max().item()}
    del logits, sq

    # 22e. Engine(moe=): captured programs against the eager bodies.
    short = [(prompt[i, :64 + 64 * i].cpu().numpy().astype(np.int32), 16) for i in range(4)]
    kw = dict(num_slots=4, max_len=MIXTRAL_PROMPT, prefill_chunk=(8, 64, 256), moe=moe)
    graph_eng, eager_eng = Engine(cfg, model, **kw), Engine(cfg, model, cuda_graph=False, **kw)
    tfa.reset_launches()
    got, want = serve_all(graph_eng, short), serve_all(eager_eng, short)
    torch.cuda.synchronize()
    serve_launches = kernel_launches(tfa)
    expect_launches(serve_launches, MIXTRAL_SERVE_LAUNCHES, "the Mixtral Engine")
    same_cache = all(torch.equal(a, c) for a, c in zip(pool_buffers(graph_eng),
                                                        pool_buffers(eager_eng)))
    if got != want or not same_cache or any(len(v) != 16 for v in got.values()):
        fail(f"mixtral Engine(moe=): graph against eager: tokens equal {got == want}, "
             f"cache bytes equal {same_cache}")
    out["serve"] = {"requests": len(short), "tokens": 16, "bitwise": True,
                    "compile_stats": graph_eng.compile_stats, "launches": serve_launches}
    tr = out["train"]
    print(f"mixtral_moe: Mixtral-8x7B width cut to {cfg.n_layers} blocks "
          f"({n_params / 1e9:.3f}B params bf16, built in {build_s:.1f}s), 8 experts top-2 "
          f"dropless, balance_weight 0.02; train batch {b} x seq {s}, chunks {chunks}, "
          f"except_last: {MIXTRAL_BALANCE} loss {l2:.6f} vs one stage {l1:.6f}, "
          f"{same}/{len(list(model.parameters()))} grad leaves bitwise, worst diff "
          f"{worst:.3e} (tol 2^-7); SGD lr {TRAIN_LR} x3 losses "
          f"{[round(v, 5) for v in losses]}; step_ms={med:.1f} tokens_per_s="
          f"{tr['tokens_per_s']:.1f} peak {tr['peak_gib']:.2f}GiB idle_share "
          f"{tr['idle_share']:.3f} launches/step {train_launches}; dropless vs sparse(cf=E/k) "
          f"max diff {derr:.3e} of {dscale:.3e}, {out['dispatch']['kept']}/"
          f"{out['dispatch']['assignments']} kept; router_stats balance "
          f"{balance.item():.4f} load {[round(v, 4) for v in load.tolist()]}; generate "
          f"4 x {MIXTRAL_PROMPT} + {MIXTRAL_NEW}: launches {gen_launches} decode ms/token "
          f"{dec:.3f} teacher_forced_agree {agree:.4f} gap_share {gap_share:.4f}; Engine "
          f"graph == eager (4 requests, 16 tokens) captures {graph_eng.compile_stats} "
          f"[{card}]", flush=True)
    print(json.dumps({"mixtral_moe": out}), flush=True)
    del graph_eng, eager_eng, model, layers
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": train_launches, "generate": gen_launches, "serve": serve_launches,
            "row": out}


# Phase 5b: float32 attention and decode at head dims other than 64 and
# 128.  Its main path is two models the bf16 kernels at 64/128 do not
# take whole: a float32 Llama at benchmarks/llama_speed.py's "1b" widths
# (head dim 64), and a bf16 Llama at Phi-2's attention widths (dim 2560,
# 32 heads of 80, Phi-2's 51200 vocab and 10240 hidden), each cut to 2
# blocks.
SIMT_F32 = dict(LLAMA_1B, n_layers=2)
SIMT_D80 = dict(vocab=51200, dim=2560, n_layers=2, n_heads=32, n_kv_heads=32,
                mlp_ratio=4.0)
SIMT_BATCH, SIMT_SEQ, SIMT_CHUNKS = 4, 1024, 2
SIMT_PROMPT, SIMT_NEW = 512, 32
# Launch gates, as phase 22's: under except_last each block's forward
# runs once per micro-batch and again for the recomputed ones, one
# backward per micro-batch; generate runs one forward a block in the
# prefill and one decode a block a token.  float32 takes the 3xTF32
# forward (csrc/flash_fwd_tf32.cu), the 3xTF32 backward (csrc/
# flash_bwd_tf32.cu: its prologue, dQ and dK/dV once a backward) and the
# tensor-core decode's float32 instantiation (d=64); d=80 takes the
# tensor-core forward and backward zero-padded to 128 and flash_decode at
# d=80 (a cache is never padded).  flash_simt's kernels take only rows TMA
# cannot map: 0 on both paths.
SIMT_F32_TRAIN = {"flash_fwd_tf32": 2 * (2 + 1), "flash_bwd_split_tf32": 2 * 2,
                  "flash_bwd_dq_tf32": 2 * 2, "flash_bwd_dkv_tf32": 2 * 2}
SIMT_F32_GENERATE = {"flash_fwd_tf32": 2, "flash_decode": 2 * SIMT_NEW}
SIMT_D80_TRAIN = {"flash_fwd": 2 * (2 + 1), "flash_bwd_dq": 2 * 2, "flash_bwd_dkv": 2 * 2}
SIMT_D80_GENERATE = {"flash_fwd": 2, "flash_decode": 2 * SIMT_NEW}
# flash_simt.cu keeps every product in float32 FMAs, as the plain versions
# do: the two differ only in summation order, ~1e-6 of O(1) outputs over
# <= 1024 keys and <= 128 dims.  The 3xTF32 forward and backward keep ~22
# bits a product (the dropped small x small term and the tf32 read of each small
# part, ~2^-21 relative) and float32 sums: ~1e-6 as well (tests/
# test_torch_tf32_split.py measures it against float64), so the same
# tolerance holds both.  Forward 1e-4 absolute; gradients row by row,
# 1e-4 of the row's max plus a floor of 1e-4 of the median row's max for
# rows that are zero in exact arithmetic (query 0's dQ: p = 1, dS = dP -
# delta = 0), where each side keeps the float32 noise of dP - delta (~1e-6
# of |dP| ~ sqrt(d)) times |k| * scale: a few 1e-7 absolute, ~1e-5 of a
# median row's max.  The decode's output: DECODE_TOL.
SIMT_F32_TOL = 1e-4
SIMT_ROW_TOL, SIMT_FLOOR = 1e-4, 1e-4


def simt_rows(got, want):
    scale = want.abs().amax(-1)
    tol = SIMT_ROW_TOL * scale + SIMT_FLOOR * scale.median()
    return ((got - want).abs().amax(-1) / tol).max().item()


def f32_bytes(b, s, h, g, d, *, reads, writes):
    """attn_bytes for float32 tensors (twice the bf16 bytes of q/k/v/o/
    do/dq/dk/dv; lse and delta are float32 in both)."""
    rows = attn_bytes(b, s, h, g, d, reads=[t for t in reads if t not in ("lse", "delta")],
                      writes=writes)
    return 2 * rows + attn_bytes(b, s, h, g, d, reads=[t for t in reads if t in
                                                         ("lse", "delta")], writes=[])


def simt_kernels(torch, tfa, tg, card):
    """The 3xTF32 forward and backward, and flash_decode at other head
    dims, against the plain versions at the shapes phase 5b's path gives
    them and at edges (other head dims, a window, no causal mask, an int8
    cache, a device pos0); flash_simt's forward, dQ, dK/dV and decode at
    shapes TMA cannot map; timed at the path's shapes beside SDPA and
    beside flash_simt's kernels, the earlier route."""
    # (name, b, h, g, s, d, window, causal): the float32 Llama's training
    # micro-batch and prefill, then edges; the last (d=18: 72-byte rows,
    # which TMA cannot stride) stays on flash_simt's forward and backward.
    cases = [("train_microbatch", 2, 32, 8, 1024, 64, None, True),
             ("prefill", 4, 32, 8, 512, 64, None, True),
             ("d80_nocausal", 2, 8, 2, 333, 80, None, False),
             ("d32_window", 2, 8, 4, 700, 32, 100, True),
             ("d128_ragged", 1, 8, 8, 129, 128, None, True),
             ("d18_simt", 2, 8, 2, 257, 18, None, True)]
    worst = {"fwd": 0.0, "fwd_simt": 0.0, "dq": 0.0, "dkv": 0.0, "dq_simt": 0.0,
             "dkv_simt": 0.0, "decode": 0.0, "decode_simt": 0.0}
    rows = {}
    for name, b, h, g, s, d, window, causal in cases:
        route = tfa.attention_route((b, s, h, d), (b, s, g, d), torch.float32,
                                    window=window).kind
        if route != ("simt" if name.endswith("_simt") else "f32"):
            fail(f"float32 attention {name}: routed to {route}")
        sfx = {"f32": "", "simt": "_simt"}[route]
        fwd_fn = tfa.flash_attention_tf32 if route == "f32" else tfa.flash_attention_f32
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").requires_grad_()
                   for n in (h, g, g))
        do = torch.randn(b, s, h, d, generator=gen, device="cuda")
        kw = dict(causal=causal, window=window)
        tfa.reset_launches()
        out = fwd_fn(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        launched = (("flash_fwd_tf32", "flash_bwd_split_tf32", "flash_bwd_dq_tf32",
                     "flash_bwd_dkv_tf32") if route == "f32" else
                    ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"))
        if counts != {key: int(key in launched) for key in counts}:
            fail(f"float32 attention {name}: one forward and backward launched {counts}, "
                 f"expected one each of {launched}")
        if name == "train_microbatch":
            again = fwd_fn(q, k, v, **kw)
            twice = torch.autograd.grad(again, (q, k, v), do)
            if not all(torch.equal(a, c) for a, c in zip(got, twice)):
                fail(f"float32 attention {name}: two backward calls disagree bitwise")
        ref = tfa.flash_attention_reference(q, k, v, **kw)
        want = torch.autograd.grad(ref, (q, k, v), do)
        err = (out - ref).abs().max().item()
        ratios = [simt_rows(a, c) for a, c in zip(got, want)]
        if not (err <= SIMT_F32_TOL and max(ratios) <= 1.0):
            fail(f"float32 attention {name}: forward err {err:.3e} (tol {SIMT_F32_TOL}), "
                 f"dq/dk/dv worst row err/tol {ratios}")
        worst["fwd" + sfx] = max(worst["fwd" + sfx], err)
        worst["dq" + sfx] = max(worst["dq" + sfx], (got[0] - want[0]).abs().max().item())
        worst["dkv" + sfx] = max(worst["dkv" + sfx], *((a - c).abs().max().item()
                                                      for a, c in zip(got[1:], want[1:])))
        print(f"float32 attention {name} ({', '.join(launched)}): b={b} s={s} h={h} g={g} "
              f"d={d} window={window} causal={causal} fwd max_abs_err={err:.3e} (tol "
              f"{SIMT_F32_TOL}) dq/dk/dv worst row err/tol {[round(x, 4) for x in ratios]}"
              f"{'; backward bitwise equal on a second call' if name == 'train_microbatch' else ''}"
              f" [{card}]", flush=True)
        if name != "train_microbatch":
            continue
        qd, kd, vd = (x.detach() for x in (q, k, v))
        scale = d ** -0.5
        o, lse = tfa._flash_fwd_tf32(qd, kd, vd, causal, scale, window)
        delta = tfa._delta(do, o)
        split = tfa.tf32_bwd_split(qd, kd, vd, do)
        if not torch.equal(split, tfa._tf32_bwd_split_reference(qd, kd, vd, do)):
            fail("tf32_bwd_split: the prologue's buffer differs from its plain version")
        bkw = dict(causal=causal, sm_scale=scale, window=window)
        calls = (("fwd", lambda: tfa._flash_fwd_tf32(qd, kd, vd, causal, scale, window)),
                 ("fwd_simt", lambda: tfa._flash_fwd_f32(qd, kd, vd, causal, scale, window)),
                 ("split", lambda: tfa.tf32_bwd_split(qd, kd, vd, do)),
                 ("dq", lambda: tfa.flash_bwd_dq_tf32(qd, kd, vd, do, lse, delta, split=split,
                                                      **bkw)),
                 ("dkv", lambda: tfa.flash_bwd_dkv_tf32(qd, kd, vd, do, lse, delta,
                                                        split=split, **bkw)),
                 ("dq_simt", lambda: tfa.flash_bwd_dq_f32(qd, kd, vd, do, lse, delta, **bkw)),
                 ("dkv_simt", lambda: tfa.flash_bwd_dkv_f32(qd, kd, vd, do, lse, delta,
                                                            **bkw)))
        ms = {n: device_ms(torch, c, 5) for n, c in calls}
        ms["dkv_sum"] = sum(t for key, t in device_ms(torch, dict(calls)["dkv"], 5,
                                                       by_kernel=True)[1].items()
                            if "flash_bwd_dkv_tf32_sum_kernel" in key)
        plain_fwd = device_ms(torch, lambda: tfa._reference_fwd(qd, kd, vd, causal, scale,
                                                                window), 3, 1)
        plain_bwd = device_ms(torch, lambda: tfa._reference_grads(
            qd, kd, vd, do, lse, delta, causal, scale, window), 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (qd, kd, vd))
        lib_f = sdpa_backends(torch, [(qt, kt, vt)], causal, 5)
        lib_b = sdpa_backends(torch, [(qt, kt, vt)], causal, 5, dout=do.transpose(1, 2))
        pairs = fwd_pairs(s, causal, window)
        reads = ["q", "k", "v", "do", "lse", "delta"]
        fwd_bytes = (f32_bytes(b, s, h, g, d, reads=["q", "k", "v"], writes=["o"])
                     + 4.0 * b * h * s)
        dq_bytes = f32_bytes(b, s, h, g, d, reads=reads, writes=["dq"])
        dkv_bytes = f32_bytes(b, s, h, g, d, reads=reads, writes=["dk", "dv"])
        # The float32-accurate products: three TF32 products each on the
        # tensor cores (the least time), or one f32 FMA on the CUDA cores
        # (flash_simt's route).  The prologue moves bytes only: q, k, v, dO
        # read once, its buffer written once.
        split_bytes = (f32_bytes(b, s, h, g, d, reads=["q", "k", "v", "do"], writes=[])
                       + 4.0 * split.numel())
        bounds = {
            "fwd": bound(3 * 4.0 * b * h * d * pairs, fwd_bytes, PEAK_TF32_FLOPS),
            "fwd_simt": bound(4.0 * b * h * d * pairs, fwd_bytes, PEAK_F32_FLOPS),
            "split": bound(0.0, split_bytes),
            "dq": bound(3 * 6.0 * b * h * d * pairs, dq_bytes, PEAK_TF32_FLOPS),
            "dkv": bound(3 * 8.0 * b * h * d * pairs, dkv_bytes, PEAK_TF32_FLOPS),
            "dq_simt": bound(6.0 * b * h * d * pairs, dq_bytes, PEAK_F32_FLOPS),
            "dkv_simt": bound(8.0 * b * h * d * pairs, dkv_bytes, PEAK_F32_FLOPS)}
        print(f"float32 attention timing {name}, device ms per call: fwd (3xTF32) "
              f"{ms['fwd']:.4f} (plain {plain_fwd:.4f}, sdpa {lib_f[2]:.4f} {lib_f[1]}, bound "
              f"{bounds['fwd'][0]:.4f} {bounds['fwd'][1]} at 3xTF32, "
              f"{bounds['fwd_simt'][0]:.4f} at f32 FMA; flash_simt's forward "
              f"{ms['fwd_simt']:.4f}); backward (3xTF32): prologue {ms['split']:.4f} (bound "
              f"{bounds['split'][0]:.4f} {bounds['split'][1]}) dq {ms['dq']:.4f} (bound "
              f"{bounds['dq'][0]:.4f} at 3xTF32, {bounds['dq_simt'][0]:.4f} at f32 FMA) dkv "
              f"{ms['dkv']:.4f} (its sum kernel {ms['dkv_sum']:.4f}; bound "
              f"{bounds['dkv'][0]:.4f} at 3xTF32, {bounds['dkv_simt'][0]:.4f} at f32 FMA), "
              f"together "
              f"{ms['split'] + ms['dq'] + ms['dkv']:.4f}; flash_simt's dq {ms['dq_simt']:.4f} "
              f"dkv {ms['dkv_simt']:.4f} (earlier); plain backward {plain_bwd:.4f} and sdpa "
              f"backward {lib_b[2]:.4f} ({lib_b[1]}), all three grads [{card}]", flush=True)
        rows["f32"] = dict(ms=ms, plain_fwd=plain_fwd, plain_bwd=plain_bwd, lib_fwd=lib_f,
                           lib_bwd=lib_b, bounds=bounds)
        del o, lse, delta, split
    # Decode: the d=80 model's generate (b=4, 32 kv heads, one row each,
    # 513..544 live of 544), then edges through flash_decode at the real
    # head dim; the last (an int8 cache at d=24: 24-byte rows) stays on
    # flash_simt's decode.
    # (name, kind, b, g, nh, nkv, hd, pos0, window, max_len)
    dcases = [("d80_len513", "bf16", 4, 1, 32, 32, 80, 512, None, 544),
              ("d80_len544", "bf16", 4, 1, 32, 32, 80, 543, None, 544),
              ("d32_int8_g5", "int8", 2, 5, 8, 4, 32, 300, 64, 517),
              ("d96_f32_window", "f32", 2, 2, 8, 2, 96, 1000, 9, 1152),
              ("d80_long", "bf16", 1, 1, 32, 8, 80, 19999, None, 20000),
              ("d24_int8_simt", "int8", 2, 3, 8, 4, 24, 300, None, 517)]
    for name, kind, b, g, nh, nkv, hd, pos0, window, max_len in dcases:
        gen = torch.Generator(device="cuda").manual_seed(7)
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        q = torch.randn(b, g, nh, hd, generator=gen, device="cuda").to(dtype)
        if kind == "int8":
            ck, ks = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            cv, vs = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            ck, cv = (torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").to(dtype)
                      for _ in range(2))
            sc = {}
        route = tfa.attention_route(q.shape, ck.shape, dtype, window=window, decode=True,
                                    cache_dtype=ck.dtype).kind
        if route != ("simt" if name.endswith("_simt") else "kernel"):
            fail(f"decode {name}: routed to {route}")
        fn = tfa.flash_decode_attention if route == "kernel" else tfa.flash_decode_simt
        key = ("flash_decode_simt" if route == "simt" else
               "flash_decode_int8" if kind == "int8" else "flash_decode")
        tfa.reset_launches()
        out = fn(q, ck, cv, pos0, window=window, **sc)
        dev = fn(q, ck, cv, torch.tensor(pos0, dtype=torch.int32, device="cuda"),
                 window=window, **sc)
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        if counts[key] != 2 or sum(counts.values()) != 2:
            fail(f"decode {name}: two calls launched {counts}, expected 2 of {key}")
        ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window, **sc)
        err = (out - ref).abs().max().item()
        wkey = "decode_simt" if route == "simt" else "decode"
        worst[wkey] = max(worst[wkey], err)
        if not (err <= DECODE_TOL and torch.equal(out, dev)):
            fail(f"decode {name} ({key}): max abs err {err:.3e} (tol {DECODE_TOL}), "
                 f"device pos0 bitwise {torch.equal(out, dev)}")
        print(f"decode {name} ({key}): {kind} cache=[{b},{max_len},{nkv},{hd}] g={g} "
              f"pos0={pos0} window={window} max_abs_err={err:.3e} (tol {DECODE_TOL}); "
              f"device pos0 bitwise equal [{card}]", flush=True)
    # Timed at the d=80 generate's middle (live 528), cycling four caches
    # as the layers' caches cycle: flash_decode, and flash_simt's decode
    # (the earlier route) at the same shape.
    b, nh, nkv, hd, live, max_len = 4, 32, 32, 80, 528, 544
    gen = torch.Generator(device="cuda").manual_seed(8)
    sets = [tuple(torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((b, 1, nh, hd), (b, max_len, nkv, hd), (b, max_len, nkv, hd)))
            for _ in range(4)]
    it = {"i": 0}

    def cycle(fn):
        def run():
            it["i"] = (it["i"] + 1) % len(sets)
            fn(*sets[it["i"]])
        return run

    def new(q, ck, cv):
        return tfa.flash_decode_attention(q, ck, cv, live - 1)

    def simt(q, ck, cv):
        return tfa.flash_decode_simt(q, ck, cv, live - 1)

    ms = device_ms(torch, cycle(new), 40)
    call_ms = time_ms(torch, cycle(new), 40)
    simt_ms = device_ms(torch, cycle(simt), 40)
    simt_call_ms = time_ms(torch, cycle(simt), 40)
    plain_ms = device_ms(torch, cycle(lambda q, ck, cv: tfa.flash_decode_reference(
        q, ck, cv, live - 1)), 10, 1)
    lib = sdpa_backends(torch, [(q.transpose(1, 2), ck[:, :live].transpose(1, 2),
                                 cv[:, :live].transpose(1, 2)) for q, ck, cv in sets],
                        False, 40)
    bms, by = decode_bound(b, nh, nkv, hd, live, 1, 2, False)
    print(f"decode timing d=80: cache=[{b},{max_len},{nkv},{hd}] live={live} g=1: flash_decode "
          f"ms={ms:.4f} ({call_ms:.4f} on the host clock); flash_simt's decode {simt_ms:.4f} "
          f"({simt_call_ms:.4f}); plain_ms={plain_ms:.4f} sdpa_ms={lib[2]:.4f} ({lib[1]}; by "
          f"backend {lib[0]}) bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
    rows["decode"] = dict(ms=ms, call_ms=call_ms, simt_ms=simt_ms, simt_call_ms=simt_call_ms,
                          plain_ms=plain_ms, lib=lib, bound_ms=bms, bound_by=by)
    del sets
    torch.cuda.empty_cache()
    return worst, rows


def phase_simt(torch, tfa, tt, tg, card, seed: int):
    """simt_kernels, then the main path of float32 attention and of
    decode at other head dims: the float32 Llama and the d=80 Llama each
    take one GPipe step
    (batch 4 x seq 1024, 2 micro-batches, except_last) and ``generate``
    4 x 512 prompts with 32 greedy tokens, each run's launches gated; the
    tokens against a teacher-forced forward."""
    import numpy as np

    from torchgpipe_tpu_torch import GPipe

    worst, rows = simt_kernels(torch, tfa, tg, card)
    out = {"worst": worst, "rows": rows, "paths": {}}
    loss_fn = causal_lm_loss(tt)
    for tag, preset, dtype, train_gate, gen_gate in (
            ("f32_llama", SIMT_F32, torch.float32, SIMT_F32_TRAIN, SIMT_F32_GENERATE),
            ("d80_llama", SIMT_D80, torch.bfloat16, SIMT_D80_TRAIN, SIMT_D80_GENERATE)):
        cfg = tt.TransformerConfig(**preset, dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        model = tt.llama(cfg, device="cuda", generator=gen)
        tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(
            0, cfg.vocab, (SIMT_BATCH, SIMT_SEQ))).cuda()
        pipe = GPipe(list(model), [len(model)], chunks=SIMT_CHUNKS, checkpoint="except_last")
        (loss, _, _), stats = step_with_peak(
            torch, tfa, pipe, lambda: pipe.value_and_grad(tokens, tokens, loss_fn))
        expect_launches(stats["launches"], train_gate, f"a {tag} training step")
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in pipe.parameters())
        if not (math.isfinite(loss.item()) and grads_finite):
            fail(f"{tag} step: loss {loss.item()}, gradients finite {grads_finite}")
        prof = None
        if tag == "f32_llama":
            # A second step under the profiler: device busy time and the
            # attention kernels' share of it (the float32 backward's).
            wall, busy, krows = profile(torch, card, f"simt path {tag} step",
                                        lambda: pipe.value_and_grad(tokens, tokens, loss_fn),
                                        top=8)
            attn = {n: sum(us for us, _, key in krows if n in key) / 1e3 for n in (
                "flash_fwd_tf32_kernel", "tf32_bwd_split_kernel", "flash_bwd_dq_tf32_kernel",
                "flash_bwd_dkv_tf32_kernel", "flash_bwd_dkv_tf32_sum_kernel")}
            prof = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3, "attention_ms": attn}
            print(f"simt path {tag}: profiled step device busy {busy * 1e3:.1f} ms of "
                  f"{wall * 1e3:.1f}; attention kernels (ms) "
                  f"{ {k: round(v, 3) for k, v in attn.items()} } [{card}]", flush=True)
        del pipe
        for p in model.parameters():
            p.grad = None
        model.eval()
        prompt = torch.randint(0, cfg.vocab, (4, SIMT_PROMPT), device="cuda", generator=gen)
        gout, _, gen_launches, times = timed_generate(torch, tfa, tg, cfg, model, prompt,
                                                      SIMT_NEW, 1)
        expect_launches(gen_launches, gen_gate, f"{tag} generate")
        agree, gap = teacher_forced(torch, model, prompt, gout)
        if agree < TF_AGREE or gap > TF_GAP:
            fail(f"{tag} generate vs teacher forcing: agreement {agree:.3f} (floor "
                 f"{TF_AGREE}), worst gap {gap:.3f} (tol {TF_GAP})")
        dec = statistics.median(times["decode_ms"]) / SIMT_NEW
        out["paths"][tag] = {"train": stats["launches"], "generate": gen_launches,
                             "loss": loss.item(), "step_ms": stats["ms"],
                             "decode_ms_per_token": dec, "teacher_forced_agree": agree,
                             "max_gap": gap, "step_profile": prof}
        print(f"simt path {tag}: {cfg.head_dim}-dim heads, {str(dtype)[6:]}, 2 blocks; step "
              f"batch {SIMT_BATCH} x seq {SIMT_SEQ} loss {loss.item():.5f} step_ms "
              f"{stats['ms']:.1f} launches {stats['launches']}; generate 4 x {SIMT_PROMPT} + "
              f"{SIMT_NEW}: launches {gen_launches} decode ms/token {dec:.3f} "
              f"teacher_forced_agree {agree:.4f} max_gap {gap:.4f} [{card}]", flush=True)
        del model, tokens, prompt, gout
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Every phase by number and name, in the order a run takes them, with the
# phases whose results it needs (``--phases``).
PHASES = {
    "3": "fwd", "4": "decode", "5": "bwd", "5b": "simt", "6": "generate", "6b": "generate_int8",
    "6c": "speculative", "6d": "beam", "7": "profile", "9": "serving",
    "9b": "int8_weights", "8": "train", "10": "train_1f1b", "11": "resnet101",
    "12": "train_graph", "13": "precision", "14": "offload", "15": "lora", "16": "unet",
    "17": "timeline", "18": "vit_l16", "19": "amoebanetd", "20": "t5",
    "21": "gpt2_xl_generate", "22": "mixtral_moe",
}
PHASE_ORDER = list(PHASES)
PHASE_NEEDS = {"6b": ["6"], "6c": ["6"], "6d": ["6"], "7": ["6"], "9": ["6"],
               "9b": ["6", "9"], "12": ["10"], "13": ["11", "12"], "14": ["10"],
               "15": ["8"], "17": ["16"]}


def select_phases(spec):
    """The phase numbers ``--phases`` selects (all without it), with the
    phases they need."""
    if spec is None:
        return set(PHASES)
    by_name = {name: num for num, name in PHASES.items()}
    todo = []
    for item in (x.strip() for x in spec.split(",") if x.strip()):
        num = item if item in PHASES else by_name.get(item)
        if num is None:
            fail(f"--phases: unknown phase {item!r}; phases: "
                 + ", ".join(f"{n} {m}" for n, m in PHASES.items()))
        todo.append(num)
    run = set()
    while todo:
        num = todo.pop()
        if num not in run:
            run.add(num)
            todo += PHASE_NEEDS.get(num, [])
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and prompt seed")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases by number or name (e.g. '3,mixtral_moe'); "
                         "the phases they need run too; default: every phase")
    args = ap.parse_args()
    run = select_phases(args.phases)

    run_t0 = time.perf_counter()
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

    r = {}     # each phase's result, by number

    def timed(numbers, label):
        """Run the selected ones of ``numbers`` (``(number, thunk)``) and
        print their seconds."""
        t0, parts = time.perf_counter(), []
        for num, fn in numbers:
            if num in run:
                t = time.perf_counter()
                r[num] = fn()
                parts.append(f"{num} {time.perf_counter() - t:.1f}")
        if parts:
            print(f"phases {label}: {time.perf_counter() - t0:.1f}s ({', '.join(parts)})",
                  flush=True)

    timed([("3", lambda: phase_fwd(torch, tfa, card, gqa_sdpa)),
           ("4", lambda: phase_decode(torch, tfa, tg, card)),
           ("5", lambda: phase_bwd(torch, tfa, card)),
           ("5b", lambda: phase_simt(torch, tfa, tt, tg, card, args.seed))],
          "3-5b (fwd, decode, bwd, simt)")
    if "6" in run:
        def gen_model():
            return r["6"][1]

        timed([("6", lambda: phase_slice(torch, tfa, tt, tg, card, args.seed)),
               ("6b", lambda: phase_slice_int8(torch, tfa, tg, card, *gen_model()[:4])[0]),
               ("6c", lambda: phase_speculative(torch, tfa, tt, tg, card, args.seed,
                                                *gen_model()[:3])),
               ("6d", lambda: phase_beam(torch, tfa, tg, card, *gen_model()[:3])),
               ("7", lambda: phase_profile(torch, tg, card, *gen_model()[:3])),
               ("9", lambda: phase_serving(torch, tfa, tg, card, args.seed,
                                           *gen_model()[:2])),
               ("9b", lambda: phase_int8_weights(torch, tfa, tg, card, args.seed,
                                                 *gen_model(), r["9"]))],
              "6-9b (generate .. int8_weights)")
        r["6"] = (r["6"][0], None)   # the generation model's 16 GB before training
        gc.collect()
        torch.cuda.empty_cache()
    timed([("8", lambda: (phase_train(torch, tfa, tt, card, args.seed),
                          phase_stages(torch, tt, card, args.seed))[0])], "8 (train)")
    timed([("10", lambda: phase_1f1b(torch, tfa, tt, card, args.seed)),
           ("11", lambda: phase_resnet(torch, tfa, card, args.seed))],
          "10-11 (train_1f1b, resnet101)")
    timed([("12", lambda: phase_train_graph(torch, tfa, tt, card, args.seed,
                                            r["10"]["balance"])),
           ("13", lambda: phase_precision(torch, tfa, tt, card, args.seed,
                                          r["11"]["balance"], r["12"],
                                          r["11"]["samples_per_s"])),
           ("14", lambda: phase_offload(torch, tfa, tt, card, args.seed,
                                        r["10"]["balance"]))],
          "12-14 (train_graph, precision, offload)")

    def unet():
        torch.backends.cudnn.deterministic = True   # bitwise-repeatable conv gradients
        return phase_unet(torch, tfa, card, args.seed)

    timed([("15", lambda: phase_lora(torch, tfa, tt, tg, card, args.seed, *r["8"][1])),
           ("16", unet), ("17", lambda: phase_timeline(torch, card, r["16"]))],
          "15-17 (lora, unet/vgg16, timeline)")
    torch.backends.cudnn.deterministic = False
    for key in ("layers", "x", "y"):
        r.get("16", {}).pop(key, None)
    timed([("18", lambda: phase_vit(torch, tfa, card, args.seed)),
           ("19", lambda: phase_amoebanet(torch, tfa, card, args.seed)),
           ("20", lambda: phase_t5(torch, tfa, card, args.seed)),
           ("21", lambda: phase_gpt2_xl(torch, tfa, tt, tg, card, args.seed)),
           ("22", lambda: phase_mixtral(torch, tfa, tt, tg, card, args.seed))],
          "18-22 (vit_l16, amoebanetd, t5, gpt2_xl_generate, mixtral_moe)")

    if run != set(PHASES):
        print(f"chip_smoke: phases {sorted(run, key=PHASE_ORDER.index)} of {len(PHASES)} "
              f"in {time.perf_counter() - run_t0:.1f}s; the kernels line needs every "
              "phase", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    fwd, (dec_err, dec), (bwd_err, bwd) = r["3"], r["4"], r["5"]
    launches, int8_launches = r["6"][0], r["6b"]
    spec_launches, beam_launches, serving = r["6c"], r["6d"], r["9"]
    train_launches = r["8"][0]
    one_f1b, resnet, graph, offload = r["10"], r["11"], r["12"], r["14"]
    precision_resnet, precision_llama = r["13"]
    lora_run, unet_row, vit_run, amoeba, t5_run = r["15"], r["16"], r["18"], r["19"], r["20"]
    gpt2, mixtral, int8w, simt = r["21"], r["22"], r["9b"], r["5b"]

    src = "torchgpipe_tpu_torch/csrc/"
    ref = "torchgpipe_tpu/ops/flash_attention.py"
    main_fwd = fwd["main"]

    paths = {"generate": launches, "generate_int8": int8_launches,
             "speculative": spec_launches, "beam_search": beam_launches,
             "serving": serving["kernel_launches"], "train_step": train_launches,
             "train_1f1b": one_f1b["launches"], "resnet101": resnet["launches"],
             "train_graph": graph["launches"], "precision_resnet101": precision_resnet["launches"],
             "precision_llama": precision_llama, "offload": offload["launches"],
             "lora_step": lora_run["launches"], "lora_packed": lora_run["packed_launches"],
             "lora_generate": lora_run["generate_launches"], "unet": unet_row["launches"],
             "vgg16": unet_row["vgg_launches"], "vit_l16": vit_run["launches"],
             "amoebanetd": amoeba["launches"], "t5": t5_run["launches"],
             "gpt2_xl_generate": gpt2["launches"],
             "int8_weights_generate": int8w["launches"],
             "mixtral_moe_train": mixtral["train"], "mixtral_moe_generate": mixtral["generate"],
             "mixtral_moe_serve": mixtral["serve"],
             "f32_llama_train": simt["paths"]["f32_llama"]["train"],
             "f32_llama_generate": simt["paths"]["f32_llama"]["generate"],
             "d80_llama_train": simt["paths"]["d80_llama"]["train"],
             "d80_llama_generate": simt["paths"]["d80_llama"]["generate"]}

    def by_path(name):
        return {p: n.get(name, 0) for p, n in paths.items()}

    def decode_entry(name, kind, main_path):
        t, long = dec["main"][kind], dec["long"][kind]
        return {"name": name, "route": "cuda", "source": src + "flash_decode.cu",
                "replaces": f"{ref}:1024", "launches": paths[main_path][name],
                "launches_by_path": by_path(name),
                "max_abs_err": dec_err[kind], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["lib_ms"], "library_backend": t["lib_backend"],
                "library_ms_by_backend": t["lib_by_backend"], "call_ms": t["call_ms"],
                "path_shapes": {"gpt2_xl": {
                    k: dec["gpt2_xl"][k] for k in ("ms", "plain_ms", "bound_ms")} | {
                    "library_ms": dec["gpt2_xl"]["lib_ms"],
                    "library_backend": dec["gpt2_xl"]["lib_backend"]},
                    "phi2_d80": {k: srows["decode"][k] for k in (
                        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")} | {
                        "library_ms": srows["decode"]["lib"][2],
                        "library_backend": srows["decode"]["lib"][1],
                        "launches": paths["d80_llama_generate"][name],
                        "earlier_kernel_ms": srows["decode"]["simt_ms"],
                        "shape": "bf16 cache [4, 544, 32, 80] live 528 g=1"}}
                if kind == "bf16" else {},
                "other_head_dims_max_abs_err": sworst["decode"],
                "long_cache": {"ms": long["ms"], "plain_ms": long["plain_ms"],
                               "bound_ms": long["bound_ms"],
                               "library_ms": long["lib_ms"],
                               "library_backend": long["lib_backend"],
                               "library_ms_by_backend": long["lib_by_backend"]}}

    def bwd_path(row, key, **extra):
        return {"ms": row[key][0], "call_ms": row[key][2], "plain_ms": row["plain_ms"],
                "bound_ms": row[key][1][0], "bound_by": row[key][1][1],
                "library_ms": row["lib_ms"], "library_backend": row["lib_backend"], **extra}

    def bwd_entry(name, key, line, also):
        main_bwd, long = bwd["main"], bwd["long12288"]
        ms, (bms, by), call = main_bwd[key]
        return {"name": name, "route": "cuda", "source": src + "flash_bwd.cu",
                "replaces": f"{ref}:{line}", "also_replaces": f"{ref}:{also}",
                "launches": train_launches[name],
                "launches_by_path": by_path(name),
                "max_abs_err": bwd_err[key],
                "ms": ms, "call_ms": call, "plain_ms": main_bwd["plain_ms"],
                "bound_ms": bms, "bound_by": by, "library_ms": main_bwd["lib_ms"],
                "library_backend": main_bwd["lib_backend"],
                "library_ms_by_backend": main_bwd["lib_by_backend"],
                "long_shape": {"ms": long[key][0], "call_ms": long[key][2],
                               "plain_ms": long["plain_ms"], "bound_ms": long[key][1][0],
                               "library_ms": long["lib_ms"],
                               "library_backend": long["lib_backend"],
                               "library_ms_by_backend": long["lib_by_backend"]},
                "path_shapes": {"vit_l16": bwd_path(bwd["vit_l16"], key, causal=False),
                                "pad_d80": bwd_path(bwd["pad_d80"], key, head_dim="80->128"),
                                "pad_d32": bwd_path(bwd["pad_d32"], key, head_dim="32->64")}}

    srows, sworst = simt["rows"], simt["worst"]

    def simt_entry(name, key, line, main_path, source="flash_simt.cu"):
        f32 = srows["f32"]
        ms, (bms, by) = f32["ms"][key], f32["bounds"][key]
        fwd = key.startswith("fwd")
        lib = f32["lib_fwd"] if fwd else f32["lib_bwd"]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": f"{ref}:{line}", "launches": paths[main_path][name],
                "launches_by_path": by_path(name), "max_abs_err": sworst[key],
                "ms": ms, "plain_ms": f32["plain_fwd"] if fwd else f32["plain_bwd"],
                "plain_covers": "forward" if fwd else "all three gradients",
                "bound_ms": bms, "bound_by": by, "library_ms": lib[2],
                "library_backend": lib[1], "library_ms_by_backend": lib[0],
                "shape": "f32 b=2 s=1024 h=32 g=8 d=64 causal"}

    def shape_entry(row):
        return {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")} | {
            "library_ms": row["lib_ms"], "library_device_ms": row["lib_device_ms"]}

    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": f"{ref}:69", "also_replaces": f"{ref}:301",
         "launches": launches["flash_fwd"],
         "launches_by_path": by_path("flash_fwd"),
         "max_abs_err": max(r["err"] for r in fwd.values()),
         "ms": main_fwd["ms"], "plain_ms": main_fwd["plain_ms"],
         "bound_ms": main_fwd["bound_ms"], "bound_by": main_fwd["bound_by"],
         "library_ms": main_fwd["lib_ms"],
         "device_ms": main_fwd["device_ms"], "library_device_ms": main_fwd["lib_device_ms"],
         "train_microbatch": shape_entry(fwd["train_microbatch"]),
         "long_shape": shape_entry(fwd["long12288"]),
         "path_shapes": {n: shape_entry(fwd[n])
                         for n in ("spec_draft_d64", "spec_target", "beam_prefill",
                                   "vit_l16", "gpt2_xl_prefill", "pad_d80", "pad_d32")}},
        decode_entry("flash_decode", "bf16", "generate"),
        decode_entry("flash_decode_int8", "int8", "generate_int8"),
        bwd_entry("flash_bwd_dq", "dq", 538, 411),
        bwd_entry("flash_bwd_dkv", "dkv", 592, 468),
        simt_entry("flash_fwd_tf32", "fwd", 69, "f32_llama_train", "flash_fwd_tf32.cu") | {
            "bound_at": "3xTF32 on the tensor cores (495 TF/s / 3)",
            "bound_fma_ms": srows["f32"]["bounds"]["fwd_simt"][0]},
        simt_entry("flash_fwd_f32", "fwd_simt", 69, "f32_llama_train") | {
            "takes": "float32 head dims that are not a multiple of 4",
            "max_abs_err_at": "d=18"},
        simt_entry("flash_bwd_dq_tf32", "dq", 538, "f32_llama_train", "flash_bwd_tf32.cu") | {
            "bound_at": "3xTF32 on the tensor cores (495 TF/s / 3)",
            "bound_fma_ms": srows["f32"]["bounds"]["dq_simt"][0],
            "prologue_ms": srows["f32"]["ms"]["split"],
            "prologue_bound_ms": srows["f32"]["bounds"]["split"][0],
            "prologue_launches": paths["f32_llama_train"]["flash_bwd_split_tf32"],
            "earlier_kernel_ms": srows["f32"]["ms"]["dq_simt"]},
        simt_entry("flash_bwd_dkv_tf32", "dkv", 592, "f32_llama_train", "flash_bwd_tf32.cu") | {
            "bound_at": "3xTF32 on the tensor cores (495 TF/s / 3)",
            "bound_fma_ms": srows["f32"]["bounds"]["dkv_simt"][0],
            "sum_kernel_ms": srows["f32"]["ms"]["dkv_sum"],
            "earlier_kernel_ms": srows["f32"]["ms"]["dkv_simt"]},
        simt_entry("flash_bwd_dq_f32", "dq_simt", 538, "f32_llama_train") | {
            "takes": "float32 head dims that are not a multiple of 4",
            "max_abs_err_at": "d=18"},
        simt_entry("flash_bwd_dkv_f32", "dkv_simt", 592, "f32_llama_train") | {
            "takes": "float32 head dims that are not a multiple of 4",
            "max_abs_err_at": "d=18"},
        {"name": "flash_decode_simt", "route": "cuda", "source": src + "flash_simt.cu",
         "replaces": f"{ref}:1024", "launches": paths["d80_llama_generate"]["flash_decode_simt"],
         "launches_by_path": by_path("flash_decode_simt"),
         "max_abs_err": sworst["decode_simt"], "max_abs_err_at": "int8 cache at d=24",
         "ms": srows["decode"]["simt_ms"], "call_ms": srows["decode"]["simt_call_ms"],
         "plain_ms": srows["decode"]["plain_ms"], "bound_ms": srows["decode"]["bound_ms"],
         "bound_by": srows["decode"]["bound_by"], "library_ms": srows["decode"]["lib"][2],
         "library_backend": srows["decode"]["lib"][1],
         "library_ms_by_backend": srows["decode"]["lib"][0],
         "takes": "cache rows that are not a multiple of 16 bytes",
         "shape": "bf16 cache [4, 544, 32, 80] live 528 g=1"},
    ]
    smem = smem_dynamic(_build)
    for k in kernels:
        k["ptxas"] = {f: resources[f] for f in KERNEL_FUNCS[k["name"]][1]}
        if k["name"] in smem:
            k["smem_dynamic_bytes"] = smem[k["name"]]
    for k in kernels:
        if k["name"] in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tf32",
                         "flash_bwd_dkv_tf32"):
            k["bitwise_repeat"] = True   # phases 5 and 5b fail otherwise
    for k in kernels[1:3]:
        k["device_pos0_bitwise"] = k["graph_replay"] = True   # phase 4 fails otherwise
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - run_t0:.1f}s in all", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
