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
   kernel), tokens teacher-forced.  Float16 and head dims 129-256: the
   f16 instantiations of flash_fwd, flash_bwd_dq/dkv and flash_decode
   (f16 and int8 caches), the d=256 instantiations of flash_fwd and
   flash_bwd_dq (bf16 and f16) and flash_simt.cu's wide kernels (d=160/256
   in bf16, f16 and f32; their decode with bf16, f16 and int8 caches)
   against the plain versions (backward bitwise on a second call, device
   pos0 bitwise), timed at the f16 path's and phase 25's shapes and at
   bf16 s=4096 d=256 beside SDPA (the d=256 kernels beside the simt ones
   they replace); head dims 384 and 512 (the reference's multiples of
   128 above 256: flash_simt.cu at sixteen lanes a row) in bf16 and f32,
   their decode over bf16 and int8 caches with 300-511 live keys, against
   the plain versions, timed at bf16 b=1 s=512 h=8 g=4 beside SDPA and
   their bounds (the kernels line's ``head_dims_384_512``); then a float16 Llama at Llama-3-8B's widths, 2 blocks, takes the
   same step (its loss beside a bf16 step at the same weights, a sanity
   bound) and ``generate``, launches gated on the f16 instantiations.
6. slice: greedy ``generate`` at Llama-3-8B width (random weights from a
   seed, 16 of its 32 layers: GEN_BLOCKS, batch 4, prompt 1024, 128 new
   tokens), with the
   kernels' launch counts read around that one call, prefill logits of
   the kernel path against the plain path, and the generated tokens
   against a teacher-forced full forward.
6b. slice_int8: the same ``generate`` with ``kv_quant=True`` (the int8
   decode kernel): launch counts, times, cache bytes, the teacher-forced
   check, token agreement with phase 6 and the two caches' decode logits
   on phase 6's tokens.
6c. speculative: ``speculative_generate`` with phase 6's model as the
   target and a random benchmarks/llama_speed.py ``1b`` draft (batch 2,
   prompt 512, 32 new tokens, gamma 4, greedy): launch counts against
   ``SpecStats``, the teacher-forced check, agreement with ``generate``;
   then the target as its own draft (acceptance >= 0.8).
6d. beam: ``beam_search`` of one prompt with 4 beams, 32 tokens, and
   ``num_beams=1`` against greedy ``generate`` (equal).
7. profile: device time by kernel and idle share, prefill and decode,
   bf16 and int8 caches (the device's activity alone: recording the
   host's ops too made the phase take ~55 s).
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
   the stateless SGD's, ``obs.StepReporter``'s line over the timed steps
   (its MFU from ``obs.measured_step_flops`` and the port's peak table,
   beside this script's own FLOPs share), a profile of one step, and a
   3-stage schedule on one card against the 1-stage one at 4 blocks.
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
   cut to depth 3, 192x192, batch 160, 8 micro-batches, 2 stages, 'except_last',
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
23. distributed: ``torchgpipe_tpu_torch.distributed`` at Llama-3-8B
   width cut to 2 blocks (bf16, batch 8 x seq 1024, 4 micro-batches,
   'except_last', SGD; balance [2, 2], ``balance_by_flops``' [3, 1]
   printed beside it).  Here: three steps of the single-process
   ``GPipe`` (loss, step-1 gradients kept on the host, launches), then
   ``StepGuard`` on it (a step poisoned at stage 1's input by
   ``faults.inject(nan_at=(1, 0))`` is skipped with every parameter,
   optimizer state and buffer bitwise as before; the next clean step
   equals an unguarded one).  Then two rank processes (this script with
   ``--dist-rank``, started by subprocess) on the same card over
   ``TcpTransport`` on localhost: three steps each, the step-1 loss and
   every gradient bitwise the single-process step's, 7 / 4 / 4 launches of
   flash_fwd / flash_bwd_dq / flash_bwd_dkv a rank (their sums the
   single-process counts), then rank 1 exits
   (``faults.should_die_at_megastep``) and rank 0's next step must raise
   a ``PeerDiedError`` naming it; the parent kills both after 300 s.
   Step ms of each rank beside the single-process step's, bytes staged
   through the host and the time spent waiting in ``Mailbox.get``.
24. fleet (run after 9b, on phase 6's model, shared by every replica):
   ``fleet.Router`` over two ``Engine`` replicas (phase 9's
   configuration, each with its own pool and captured programs, warmed
   up first) on a seeded ``fleet.synthetic_trace`` of 32 requests (4
   tenants, 256-512-token system prompts), a FlightRecorder on each
   replica and the router; replica r0 dies mid-trace
   (``faults.inject(die_at_step=...)``) and its requests resume on r1
   (24a); the same with ``fleet.RadixPrefixCache`` on both replicas,
   every ``prefix_copy``'s rows bitwise the donor's (24b); a prefill and
   a decode replica on ``fleet.prefill_heavy_config``, every migration's
   ingested rows bitwise the exported ones (24c); a
   ``fleet.SpeculativeEngine`` (phase 6c's random ``1b`` draft, gamma 4)
   on 8 requests beside a plain replica (24d); ``fleet.Autoscaler``
   scaling 24a's replicas down and up and a ``fleet.RolloutController``
   publish, swap and rollback on a virtual registry clock (24e); then the
   flight recorder's cost on the captured 8-slot decode step.  Gates:
   every request finishes at its budget, every stream passes phase 9's
   teacher-forced check, one capture per program (``compile_stats`` and
   ``program_count``), ``obs.reqtrace.stitch_request`` rebuilds every
   request's span tree with no orphan (moved and migrated requests
   across replicas), each new program's replay bitwise its eager body,
   zero hand-written kernel launches.  Its numbers go to a ``{"fleet":
   ...}`` line.
25. spmd: ``torchgpipe_tpu_torch.spmd.SpmdGPipe`` at Gemma-7B's
   published widths (head dim 256, tied embeddings) in bf16, 2 blocks,
   one a stage, rank processes over gloo on this card (this script
   re-run with hidden ``--spmd-*`` options): 25a pp=2 fill-drain, step 1's
   loss and every gradient leaf against a sequential oracle run here on
   the card with the same weights and batch, step 2 through
   ``make_train_step``; 25c ``spmd_params_for_generation`` of 25a's
   trained params and ``generate`` on the wide decode, against the plain
   version's tokens and a teacher-forced forward.  Each rank's launches
   (the d=256 tensor-core forward, dQ and dK/dV; a profile of 25a's step
   2 shows the same CUDA functions, none of flash_simt.cu's), step ms,
   bytes staged through the host and peak memory.  Then, on each rank
   from 25a's trained params: 25d, ``make_train_step(megastep=2)`` (SGD
   with momentum) over two stacked batches bitwise against
   ``resilience.StepGuard`` around two single steps (losses, params,
   momentum), and a guarded step under ``faults.inject(nan_at=(1, 0))``
   skipped with params and momentum bitwise as before; 25e, one
   ``checkpoint='offload'`` step bitwise a ``'never'`` step (both peaks
   and the offloaded bytes printed); each call's launches exact.  A
   ``{"spmd": ...}`` line.  (25b, 1F1B against fill-drain at pp=2 x dp=2,
   runs in phase 27's world.)
26. spmd_tp_sp: tensor and sequence parallelism in ``SpmdGPipe`` at
   Llama-3-8B's published widths in bf16, 2 blocks, one a stage, batch 2
   x seq 4096: one world of four rank processes over gloo on this card
   (``--tpsp-*``), three meshes on it: 26a pp=2 x tp=2 with
   vocab-sharded logits and ``vocab_parallel_cross_entropy``, 26b pp=2 x
   sp=2 on the ring (its blocks on flash_fwd / flash_bwd_dq /
   flash_bwd_dkv, merged by LSE), 26c the same mesh on Ulysses.  Each
   case's loss and every gradient leaf (each rank's shards) against one
   sequential oracle run here on the card, each rank's launch counts
   exact (26b's lane r: 3(r+1) forwards, 2(r+1) of each backward), 26b
   against 26c, ``gather`` of 26a's placement bitwise the drawn tree,
   the loss lower after an SGD step; each rank's step ms, bytes staged
   through the host by kind, peak memory; a ``{"spmd_tp_sp": ...}``
   line.  The ranks share one card: host staging, not multi-card
   scaling.
27. spmd_zero_sched: ZeRO/FSDP and the interleaved and zero-bubble
   schedules in ``SpmdGPipe`` at phase 25's Gemma-7B widths in bf16,
   batch 4 x 512 in 2 micro-batches, one world of four rank processes
   (pp=2 x dp=2 over gloo on this card, ``--spmd-case z``): 25b (1F1B
   against fill-drain, untied); 27a ``fsdp=True`` with
   ``make_train_step(zero=3)`` and AdamW, bitwise against the unsharded
   AdamW of the gathered tensors, and the fsdp step's gradients against
   the plain pipe's (tied); 27b ``make_train_step(zero=1)`` bitwise
   against the ``zero=0`` update of the plain step's gradients;
   27c ``schedule='interleaved'``, ``virtual_stages=2`` (4 blocks), fsdp,
   against phase 25's sequential oracle at 4 blocks (run by rank 0);
   27d ``schedule='zb'`` in ``'never'`` and ``'always'`` against 1F1B.
   Each rank's launches exact per case (a profile of the zb step shows
   none on flash_simt.cu), step ms, bytes staged through the host by kind
   (``fsdp``, ``zero``, ``grads``, ``pp``, ``loss``), block and optimizer
   bytes and peak at each ZeRO level, and ``simulate_pipeline``'s
   projections of the measured cells for the four schedules; a
   ``{"spmd_zero_sched": ...}`` line.
28. spmd_moe_ep: expert parallelism in ``SpmdGPipe`` at phase 22's
   Mixtral-8x7B widths in bf16 (8 experts, top-2, balance weight 0.02), 2
   blocks, one a stage, batch 8 x 1024 in 4 micro-batches,
   'except_last', dispatch 'sparse' at capacity factor E/k (no token
   drops): one world of four rank processes, pp=2 x ep=2 over gloo on
   this card (``--spmd-case e``), each rank 4 of the 8 experts.  Step
   1's loss and every gradient shard against a sequential oracle run here
   first (the unsharded model, ``ep_axis=None``, row by row in the lanes'
   order; its gradients written for the ranks, each reading its shard),
   two SGD steps with the loss lower after them, ``router_stats`` on each
   lane, each rank's launches exact; each rank's step ms, bytes staged
   through the host by kind (``ep``: the experts' all-to-alls;
   ``grads``), peak memory; a ``{"spmd_moe_ep": ...}`` line.

Each path's launch counts are set to 0 just before it runs and read just
after.  Then one JSON line per kernel (time, launches, bound, plain and
library yardsticks, the fastest SDPA backend by name; ``launches``
counts one generate call for the forward
and decode kernels, one ``generate(kv_quant=True)`` call for the int8
decode variant, one training step for the backward kernels, phase 5b's
float32 step for the 3xTF32 forward and backward, phase 25's rank step
for the wide route's (the d=256 forward, dQ and dK/dV), and 0 for
flash_simt's kernels, which no path reaches; every path's
counts are in
``launches_by_path``, flash_simt's and the 3xTF32 kernels' 0 on every
bf16 path at head dims 64 and 128), the card line,
and the
last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

# H100 SXM dense bf16 tensor-core rate: the port's own table
# (torchgpipe_tpu_torch/utils/hw.py, 989e12), read by main() once the port
# is importable.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = None
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
    "flash_fwd_f32": ("flash_simt", ("fwd_simt_kernel",)),
    "flash_bwd_dq_f32": ("flash_simt", ("dq_simt_kernel",)),
    "flash_bwd_dkv_f32": ("flash_simt", ("dkv_simt_kernel",)),
    "flash_decode_simt": ("flash_simt", ("decode_simt_kernel",)),
    # float16: the tensor-core kernels' f16 instantiations (the same
    # functions; registers are the max over instantiations).
    "flash_fwd_f16": ("flash_fwd", ("flash_fwd_kernel",)),
    "flash_bwd_dq_f16": ("flash_bwd", ("flash_bwd_dq_kernel",)),
    "flash_bwd_dkv_f16": ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel")),
    "flash_decode_f16": ("flash_decode", ("flash_decode_kernel", "flash_decode_merge")),
    # head dims 129-256: flash_simt.cu's kernels at eight lanes a row,
    # except at d=256 with bf16/f16 operands or caches (and int8 caches):
    # the wide route's "tc" kernels, flash_fwd_kernel<256, .>,
    # flash_bwd_dq_kernel<256, .>, flash_bwd_dkv_kernel<256, .> and
    # flash_decode_kernel<., ., 256, .>.
    "flash_fwd_d256": ("flash_fwd", ("flash_fwd_kernel",)),
    "flash_bwd_dq_d256": ("flash_bwd", ("flash_bwd_dq_kernel",)),
    "flash_bwd_dkv_d256": ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel")),
    "flash_decode_d256": ("flash_decode", ("flash_decode_kernel", "flash_decode_merge")),
    # Above 512 the same wrappers launch flash_simt.cu's chunked kernels.
    "flash_fwd_wide": ("flash_simt", ("fwd_simt_kernel", "fwd_chunk_kernel")),
    "flash_bwd_dq_wide": ("flash_simt", ("dq_simt_kernel", "dq_chunk_kernel")),
    "flash_bwd_dkv_wide": ("flash_simt", ("dkv_simt_kernel", "dkv_chunk_kernel")),
    "flash_decode_wide": ("flash_simt", ("decode_simt_kernel",)),
}
# The redesigned kernels and the instructions their SASS must hold: HGMMA
# (wgmma) and UTMALDG (TMA tensor loads); the decode kernel's scores run on
# mma.sync (HMMA) for bf16, f16 and int8 caches (an f32 cache keeps f32
# products on the CUDA cores: no HMMA there).  SASS_COUNT: instantiations
# each must show (d = 64, 128 and 256 times bf16 and f16 for flash_fwd,
# flash_bwd_dq and flash_bwd_dkv; the 3xTF32 kernels d = 64 and 128;
# decode: six query/cache type pairs x two tile dims x four row counts,
# any head dim up to 128 running on one of the two tile dims, and the
# five pairs whose cache is 16-bit or int8 x four row counts at the 256
# tile dim).
SASS_REQUIRED = {"flash_fwd": {"flash_fwd_kernel": ("HGMMA", "UTMALDG")},
                 "flash_bwd": {"flash_bwd_dkv_kernel": ("HGMMA", "UTMALDG"),
                               "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG")},
                 "flash_decode": {"flash_decode_kernel": ("UTMALDG", "HMMA")},
                 "flash_fwd_tf32": {"flash_fwd_tf32_kernel": ("HGMMA", "UTMALDG")},
                 "flash_bwd_tf32": {"flash_bwd_dq_tf32_kernel": ("HGMMA", "UTMALDG"),
                                    "flash_bwd_dkv_tf32_kernel": ("HGMMA", "UTMALDG")}}
SASS_COUNT = {"flash_fwd_kernel": 6, "flash_bwd_dkv_kernel": 6, "flash_bwd_dq_kernel": 6,
              "flash_decode_kernel": 68, "flash_fwd_tf32_kernel": 2,
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


# What the wide simt kernels take (the kernels line's ``takes``).
WIDE_TAKES = ("head dims 129-255 and the multiples of 128 above 256 in bf16 and f16; "
              "the same and 256 in f32")


def smem_simt(which, d):
    """flash_simt.cu's dynamic shared memory per block (``which``: 0
    forward, 1 dQ, 2 dK/dV) at head dim ``d``."""
    import ctypes

    from torchgpipe_tpu_torch.ops import _build

    return _build.function("flash_simt", "tgt_flash_simt_smem_bytes", [ctypes.c_int] * 2)(
        which, d)


def smem_dynamic(build):
    """Dynamic shared memory per block at d=128 of the redesigned kernels
    (d=256 for their head-dim-256 instantiations; the decode kernel's at
    its main-path instantiation: bf16 cache, up to
    4 rows a group; the 3xTF32 forward's and backward's at their main
    path's d=64), from their C interfaces."""
    import ctypes

    fwd = build.function("flash_fwd", "tgt_flash_fwd_smem_bytes", [ctypes.c_int])
    dq = build.function("flash_bwd", "tgt_flash_bwd_dq_smem_bytes", [ctypes.c_int])
    dkv = build.function("flash_bwd", "tgt_flash_bwd_dkv_smem_bytes", [ctypes.c_int])
    dec = build.function("flash_decode", "tgt_flash_decode_smem_bytes", [])
    dec256 = build.function("flash_decode", "tgt_flash_decode_d256_smem_bytes", [])
    simt = build.function("flash_simt", "tgt_flash_simt_smem_bytes", [ctypes.c_int] * 2)
    tf32 = build.function("flash_fwd_tf32", "tgt_flash_fwd_tf32_smem_bytes", [ctypes.c_int])
    dq_tf32 = build.function("flash_bwd_tf32", "tgt_flash_bwd_dq_tf32_smem_bytes", [ctypes.c_int])
    dkv_tf32 = build.function("flash_bwd_tf32", "tgt_flash_bwd_dkv_tf32_smem_bytes",
                              [ctypes.c_int])
    return {"flash_fwd": fwd(128), "flash_bwd_dq": dq(128), "flash_bwd_dkv": dkv(128),
            "flash_decode": dec(), "flash_decode_int8": dec(),
            "flash_fwd_tf32": tf32(64), "flash_bwd_dq_tf32": dq_tf32(64),
            "flash_bwd_dkv_tf32": dkv_tf32(64), "flash_fwd_f32": simt(0, 128),
            "flash_bwd_dq_f32": simt(1, 128), "flash_bwd_dkv_f32": simt(2, 128),
            "flash_fwd_f16": fwd(128), "flash_bwd_dq_f16": dq(128),
            "flash_bwd_dkv_f16": dkv(128), "flash_fwd_d256": fwd(256),
            "flash_bwd_dq_d256": dq(256), "flash_bwd_dkv_d256": dkv(256),
            "flash_decode_d256": dec256(), "flash_fwd_wide": simt(0, 256),
            "flash_bwd_dq_wide": simt(1, 256), "flash_bwd_dkv_wide": simt(2, 256)}


DEVICE_MS_TRIES = 3


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
    per call})``.  The profiler can come back without some or all of the
    device's events (late in this script's process it does): a record
    with no device time, or with a kernel seen a number of times that
    ``reps`` does not divide, is taken again, up to DEVICE_MS_TRIES
    times.  After that a kernel counts its mean time as often a call as
    it was seen a call, rounded (at least once), and a record with no
    device time at all falls back to ``time_ms`` (CUDA events, the
    host's gaps included); either is said on stderr."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_TRIES):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}   # kernel: [device us, events]
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev = getattr(e, "self_device_time_total", None)
                acc = seen.setdefault(e.key, [0.0, 0])
                acc[0] += e.self_cuda_time_total if dev is None else dev
                acc[1] += e.count
        whole = all(n % reps == 0 for _, n in seen.values())
        if whole and any(us > 0 for us, _ in seen.values()):
            break
    else:
        if not any(us > 0 for us, _ in seen.values()):
            print(f"device_ms: {DEVICE_MS_TRIES} profiles of {reps} calls recorded no device "
                  f"time; timed with CUDA events instead", file=sys.stderr, flush=True)
            total = time_ms(torch, fn, reps, warmup=0)
            return (total, {}) if by_kernel else total
        print(f"device_ms: {DEVICE_MS_TRIES} profiles of {reps} calls lost kernel events "
              f"(last: {sorted(n for _, n in seen.values())} events); each kernel's mean "
              f"time counted round(events / {reps}) times a call", file=sys.stderr,
              flush=True)
    per = {k: us / n * (n // reps if whole else max(1, round(n / reps))) / 1e3
           for k, (us, n) in seen.items() if n}
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


def bound(flops: float, nbytes: float, peak_flops: float = None):
    t_ops = flops / (peak_flops or PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
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
        # Phase 26's blocks (Llama-3-8B's 32 / 8 heads of 128, one row): a
        # ring step's diagonal block (causal) and an earlier lane's block
        # (whole) at 2048 positions; a tp lane's 16 / 4 heads over 4096
        # positions, which is Ulysses' shape too.
        ("ring_diag", 1, 32, 8, 2048, None, 128, True),
        ("ring_block", 1, 32, 8, 2048, None, 128, False),
        ("tp_lane", 1, 16, 4, 4096, None, 128, True),
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
        # Phase 6c (prompt 512, 32 new, gamma 4: buffers of 512 + 32 + 5 =
        # 549 positions, one row at a time): the 1b draft's decode reads
        # 513..549 live keys at hd 64; the target's verify, 5 queries (20
        # rows per kv head) at 517..549.
        ("draft_hd64_len513", 1, 32, 8, 64, 1, 512, None, 549),
        ("draft_hd64_len532", 1, 32, 8, 64, 1, 531, None, 549),
        ("draft_hd64_len549", 1, 32, 8, 64, 1, 548, None, 549),
        ("verify_rows20_len517", 1, 32, 8, 128, 5, 512, None, 549),
        ("verify_rows20_len549", 1, 32, 8, 128, 5, 544, None, 549),
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
    # the 50 MB L2) as the layers' caches cycle in the real loop; and at
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
        # Phase 3's rows of phase 26: a ring step's blocks with their own
        # LSE (the ring passes the merged one; phase 26 holds that), a tp
        # lane's and Ulysses' heads.
        ("ring_diag", 1, 32, 8, 2048, 128, None, True),
        ("ring_block", 1, 32, 8, 2048, 128, None, False),
        ("tp_lane", 1, 16, 4, 4096, 128, None, True),
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
        if name not in ("main", "long12288", "vit_l16", "pad_d80", "pad_d32", "ring_block",
                        "tp_lane"):
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
# The generation model of phases 6-9b and 24 (generate, the int8 cache,
# speculative decoding's target, beam search, the profile, the Engine, int8
# weights, the fleet): Llama-3-8B's widths cut to 16 of its 32 blocks, to
# keep the whole run inside its time as the SPMD phases grow (all 32 until
# PR 20; their numbers in PERF.md are at 32).
GEN_BLOCKS = 16
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
            "flash_decode_simt": tfa.flash_decode_simt.launches,
            "flash_fwd_d256": tfa.flash_attention_wide.launches_d256,
            "flash_bwd_dq_d256": tfa.flash_bwd_dq_wide.launches_d256,
            "flash_fwd_wide": tfa.flash_attention_wide.launches,
            "flash_bwd_dq_wide": tfa.flash_bwd_dq_wide.launches,
            "flash_bwd_dkv_d256": tfa.flash_bwd_dkv_wide.launches_d256,
            "flash_decode_d256": tfa.flash_decode_wide.launches_d256,
            "flash_bwd_dkv_wide": tfa.flash_bwd_dkv_wide.launches,
            "flash_decode_wide": tfa.flash_decode_wide.launches}


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
    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=GEN_BLOCKS))
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
                      new_tokens: int = 32, gamma: int = 4):
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
            cfg, model, prompt, s + steps, kv_quant=kv_quant), cuda_only=True)
        gw, gb, _ = profile(torch, card, f"generate{tag} x{steps}", lambda: tg.generate(
            cfg, model, prompt, steps, kv_quant=kv_quant), cuda_only=True)
        print(f"profile decode{tag} (generate - prefill) per step: "
              f"wall={(gw - pw) * 1e3 / steps:.2f}ms "
              f"device_busy={(gb - pb) * 1e3 / steps:.2f}ms "
              f"idle_share={1 - (gb - pb) / (gw - pw):.3f} [{card}]", flush=True)


# Phase 9: the serving Engine on phase 6's model.  ``Engine(cfg, model,
# num_slots=8, max_len=1152, prefill_chunk=(8, 64, 256))``, greedy: a bf16
# pool of GEN_BLOCKS (16) layers x K and V x [8, 1152, 8, 128] = 0.60 GB.
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
# Phase 8's peak memory (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
# torch.optim.SGD without momentum keeps no state, so the peak stays within
# 1 GiB of the step's own.  50.01 GiB with the hand-written in-place SGD it
# had before make_train_step; 48.60 since the step frees the leaves of its
# gathered output after the loss's backward (the loss's graph held them,
# and with them three checkpointed micro-batches' logits, 3 x 0.49 GiB,
# through every cell's backward).
TRAIN_PEAK_GIB = 48.60


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

    # StepReporter over the timed steps: its MFU numerator is the step's
    # FLOPs counted on the meta device (obs.measured_step_flops of one
    # unpipelined forward + backward), its clock the host's (each step
    # ends in a synchronisation), its peak the port's table.
    from torchgpipe_tpu_torch import obs

    counted = obs.measured_step_flops(
        lambda m, x: loss_fn(m(x), x).backward(), llama, tokens)
    reporter = obs.StepReporter(items_per_step=b * s, items_label="tokens",
                                flops_per_step=counted, clock=time.perf_counter,
                                emit=lambda line: None)
    step_ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step())
        end.record()
        end.synchronize()
        reporter.step()
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
          f"mfu={flops / (med * 1e-3) / PEAK_BF16_FLOPS:.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TF/s "
          f"max_memory_allocated={peak / 2**30:.2f}GiB launches/step={launches} "
          f"[{card}]", flush=True)
    rep = reporter.summary()
    if counted is None or rep.get("measured_mfu") is None:
        fail(f"StepReporter gave no MFU (counted FLOPs {counted}, peak "
             f"{reporter.peak_flops})")
    print(f"train: StepReporter {reporter.line()} (counted {counted:.4e} FLOPs a step "
          f"on the meta device: the full S x S attention square and the plain "
          f"backward's Q.K^T recompute, no checkpoint recompute; this script's count "
          f"{flops:.4e}, causal pairs: ratio {counted / flops:.4f}; the reporter's "
          f"MFU {rep['measured_mfu']:.4f} on the host clock's last step beside "
          f"{flops / (med * 1e-3) / PEAK_BF16_FLOPS:.4f} from device time) [{card}]",
          flush=True)
    profile(torch, card, "train step", step, top=16, cuda_only=True)
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
    profile(torch, card, "resnet101 step", lambda: step(x, y), top=10, cuda_only=True)
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
    ref_host = [to_host(x) for x in ref]   # for the remat policy's steps below
    del ref, grads1, loss, grads   # the replay's outputs hold the graph's pool
    # Times: three replays with new tokens each, two eager steps.
    replay_ms = timed_steps(torch, lambda: fstep(toks[1], toks[1]), 3)
    eager_ms = timed_steps(torch, lambda: estep(toks[1], toks[1]), 2)
    rw, rb, rows = profile(torch, card, "train_graph replay", lambda: fstep(toks[2], toks[2]),
                           top=6, cuda_only=True)
    per_replay = profile_launches(rows)
    if per_replay != want_launches:
        fail(f"train_graph: flash kernels per replay (profile) {per_replay}, expected "
             f"{want_launches} (the eager step's)")
    ew, eb, _ = profile(torch, card, "train_graph eager step", lambda: estep(toks[2], toks[2]),
                        top=6, cuda_only=True)
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
    policy = train_graph_policy(torch, tfa, card, pipe, run, ref_host, sgd, loss_fn,
                                dict(want_launches, flash_fwd=cfg.n_layers * chunks),
                                toks[2], cfg.n_layers * (chunks - 1))
    del ref_host
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
            "eager_idle": 1 - eb / ew, "capture_s": stats["capture_s"], "policy": policy}


def train_graph_policy(torch, tfa, card, pipe, run, ref_host, sgd, loss_fn, want, tokens,
                       kept_cells):
    """Phase 12's captured step again under ``remat_policy=
    policies.save_flash_stats``: each checkpointed cell (``kept_cells`` of
    them, a block each) keeps its flash O and LSE, so its recompute
    launches no forward kernel (``want``: the warm-up's wrapper counts and
    a replay's profile).  The warm-up and a replay bitwise the policy-free
    eager step (``ref_host``: loss, every .grad, every updated
    parameter); the warm-up's peak memory (eager step and capture) beside
    a policy-free fused pipe's, and the bytes the policy kept."""
    from torchgpipe_tpu_torch.checkpoint import policies

    peaks, out = {}, {}
    for what, kw in (("policy-free", {}),
                     ("save_flash_stats", dict(remat_policy=policies.save_flash_stats))):
        gc.collect()
        torch.cuda.empty_cache()
        ppipe = pipe(fused=True, **kw)
        pstep = ppipe.make_train_step(sgd, loss_fn)
        for p in ppipe.parameters():   # the last step's .grad: a captured pool's
            p.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads, launches = run(pstep, f"{what} warm-up")
        peaks[what] = torch.cuda.max_memory_allocated() - base
        if kw:
            expect_launches(launches, want, "the save_flash_stats warm-up (wrapper counts)")
            for step_what in ("warm-up", "replay"):
                if step_what == "replay":
                    loss, grads, launches = run(pstep, "save_flash_stats replay")
                    expect_launches(launches, {}, "a save_flash_stats replay (wrapper counts)")
                bad = [bitwise(torch, [loss], ref_host[0]), bitwise(torch, grads, ref_host[1]),
                       bitwise(torch, list(ppipe.parameters()), ref_host[2])]
                if any(bad):
                    fail(f"train_graph save_flash_stats: the {step_what} differs from the "
                         f"policy-free step: loss {bad[0]}, grads {bad[1][:8]}, params "
                         f"{bad[2][:8]}")
            _, _, rows = profile(torch, card, "train_graph save_flash_stats replay",
                                 lambda: pstep(tokens, tokens), top=6, cuda_only=True)
            out["per_replay"] = profile_launches(rows)
            if out["per_replay"] != want:
                fail(f"train_graph save_flash_stats: flash kernels per replay (profile) "
                     f"{out['per_replay']}, expected {want}")
            out["kept_bytes"] = ppipe.remat_stats["saved_bytes"]
            out["replay_ms"] = statistics.median(timed_steps(torch, lambda: pstep(tokens,
                                                                                  tokens), 3))
        del ppipe, pstep, loss, grads
    out["peak_rise_bytes"] = peaks["save_flash_stats"] - peaks["policy-free"]
    out["peaks"] = peaks
    print(f"train_graph save_flash_stats: the captured step with remat_policy="
          f"policies.save_flash_stats, warm-up and replay bitwise the policy-free step; flash "
          f"launches {out['per_replay']} a replay (the policy-free step's forward count less "
          f"the {kept_cells} recomputes); kept {out['kept_bytes']} B of O and LSE "
          f"({kept_cells} cells); warm-up peak {peaks['save_flash_stats']} B vs "
          f"{peaks['policy-free']} B policy-free (rise {out['peak_rise_bytes']} B); "
          f"replay {out['replay_ms']:.1f} ms [{card}]", flush=True)
    return out


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
# The witness's rows: the first 128 of the batch (8 a micro-batch), each
# precision at that sub-batch.  Its two float64 ResNet-101 steps were the
# slowest work of the phase at all 512 rows.
WITNESS_ROWS = 128


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

    # The witness, at its sub-batch: a plain float64 copy and the policy
    # at float64 (on a copy, so that `layers` takes bf16's below), the
    # loss in float64, beside float32 and (below) bf16 at those rows.
    def loss64(out, tgt):
        return F.cross_entropy(out.double(), tgt)

    xw, yw = x[:WITNESS_ROWS], y[:WITNESS_ROWS]
    wit = {}
    for what in ("float32", "float64", "policy float64"):
        restore(layers, snapshot)
        if what == "float32":
            m = resnet(copy.deepcopy(layers))
            wl, _, _ = m.value_and_grad(xw, yw, loss_fn)
        elif what == "float64":
            m = resnet([layer.double() for layer in copy.deepcopy(layers)])
            wl, _, _ = m.value_and_grad(xw.double(), yw, loss64)
        else:
            m = resnet(copy.deepcopy(layers), compute_dtype=torch.float64)
            wl, _, _ = m.value_and_grad(xw, yw, loss64)
        wit[what] = (wl.item(), [p.grad for p in m.parameters()])
        del m, wl
    (l64, g64), lpol, (lw32, g32w) = wit["float64"], wit["policy float64"][0], wit["float32"]
    w32 = grad_distance(F, g32w, g64)
    wpol = grad_distance(F, wit["policy float64"][1], g64)
    del wit["policy float64"]
    restore(layers, snapshot)
    model = resnet(layers, compute_dtype=torch.bfloat16)
    snapshot = state(layers)                  # the wrapped layers' keys
    (l16, _, _), s16 = step_with_peak(torch, tfa, model,
                                      lambda: model.value_and_grad(x, y, loss_fn))
    expect_launches(s16["launches"], {}, "a bf16 ResNet-101 step")
    g16 = [p.grad.clone() for p in model.parameters()]
    restore(layers, snapshot)
    model.value_and_grad(xw, yw, loss_fn)
    g16w = [p.grad.clone() for p in model.parameters()]
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
    w16 = grad_distance(F, g16w, g64)
    del g32, g64, wit, g32w, g16w
    print(f"precision: ResNet-101 witness on the first {WITNESS_ROWS} rows, gradients "
          f"against a plain float64 copy (loss "
          f"{l64:.7f}; float32 {lw32:.7f}, policy float64 {lpol:.7f}): plain float32 "
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
    rw, rb, _ = profile(torch, card, "resnet101 bf16 step", lambda: step(x, y), top=10,
                        cuda_only=True)
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
    profile(torch, card, "lora step", lambda: step(x, y), top=8, cuda_only=True)
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
# dropouts (0.1) live.  Its (5, 64) U-Net is cut to depth 3 (the widths
# of the levels kept are the row's): depth 4 as phases 18-21 joined, 3 as
# phase 25 did, to keep the whole run near its time.
UNET_ROW = dict(depth=3, num_convs=5, base_channels=64)


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
                        lambda: pipe.value_and_grad(x, y, unet_loss, rng=5), top=6,
                        cuda_only=True)
    rw, rb, _ = profile(torch, card, "unet replay",
                        lambda: fpipe.value_and_grad(x, y, unet_loss, rng=6), top=6,
                        cuda_only=True)
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
    wall, busy, _ = profile(torch, card, "vit_l16 step", lambda: step(x, y), top=8,
                            cuda_only=True)
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
    wall, busy, _ = profile(torch, card, "amoebanetd step", lambda: step(x, y), top=8,
                            cuda_only=True)
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
    wall, busy, _ = profile(torch, card, "mixtral step", lambda: step(tokens, tokens), top=8,
                            cuda_only=True)
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
    wide_worst, wide_rows = wide_f16_kernels(torch, tfa, tg, card)
    out = {"worst": worst, "rows": rows, "wide_worst": wide_worst, "wide_rows": wide_rows,
           "paths": {}}
    loss_fn = causal_lm_loss(tt)
    for tag, preset, dtype, train_gate, gen_gate in (
            ("f32_llama", SIMT_F32, torch.float32, SIMT_F32_TRAIN, SIMT_F32_GENERATE),
            ("d80_llama", SIMT_D80, torch.bfloat16, SIMT_D80_TRAIN, SIMT_D80_GENERATE),
            ("f16_llama", SIMT_F16, torch.float16, SIMT_F16_TRAIN, SIMT_F16_GENERATE)):
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
        bf16_loss = None
        if tag == "f16_llama":
            # The same weights in bf16, one step: a sanity bound on the loss.
            bcfg = tt.TransformerConfig(**preset, dtype=torch.bfloat16)
            bmodel = tt.llama(bcfg, device="cuda", generator=gen)
            bmodel.load_state_dict(model.state_dict())
            bpipe = GPipe(list(bmodel), [len(bmodel)], chunks=SIMT_CHUNKS,
                          checkpoint="except_last")
            bf16_loss = bpipe.value_and_grad(tokens, tokens, loss_fn)[0].item()
            del bpipe, bmodel
            if abs(loss.item() - bf16_loss) > F16_BF16_REL * abs(bf16_loss):
                fail(f"{tag} step: float16 loss {loss.item()} vs bf16 {bf16_loss} at the same "
                     f"weights (rel bound {F16_BF16_REL})")
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
                             "loss": loss.item(), "bf16_loss": bf16_loss,
                             "step_ms": stats["ms"],
                             "decode_ms_per_token": dec, "teacher_forced_agree": agree,
                             "max_gap": gap, "step_profile": prof}
        print(f"simt path {tag}: {cfg.head_dim}-dim heads, {str(dtype)[6:]}, 2 blocks; step "
              f"batch {SIMT_BATCH} x seq {SIMT_SEQ} loss {loss.item():.5f}"
              f"{'' if bf16_loss is None else f' (bf16 at the same weights {bf16_loss:.5f})'}"
              f" step_ms "
              f"{stats['ms']:.1f} launches {stats['launches']}; generate 4 x {SIMT_PROMPT} + "
              f"{SIMT_NEW}: launches {gen_launches} decode ms/token {dec:.3f} "
              f"teacher_forced_agree {agree:.4f} max_gap {gap:.4f} [{card}]", flush=True)
        del model, tokens, prompt, gout
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Phase 5b, float16 and head dims 129-256 (ROADMAP C.3): the f16
# instantiations of flash_fwd, flash_bwd_dq/dkv and flash_decode, the
# wide route (head dim 256, Gemma's: the forward, dQ and dK/dV in bf16/f16
# on flash_fwd.cu's and flash_bwd.cu's d=256 instantiations and the decode
# of bf16/f16/int8 caches on flash_decode.cu's 256 tiles; float32, d=160
# and d=192 on flash_simt.cu's wide kernels), against the plain versions at
# the shapes their paths give them (the f16 Llama-3-8B-width step's
# micro-batch and generate; phase 25's Gemma-7B-width micro-batch and
# generate) and at edges; gemma_long (half of Gemma's 8192 context) is a
# timing shape; bf16_d192 holds and times the 16-bit flash_simt.cu forward,
# dQ and dK/dV, which take bf16 and f16 head dims 129-255; the *_d384 and
# *_d512 rows hold and time flash_simt.cu at the reference's multiples of
# 128 above 256 (sixteen lanes a row, 16-key dQ and 16-query dK/dV
# tiles), bf16 and f32, and their decode over bf16 and int8 caches with
# live lengths of 300 to 511; the *_d640 and *_d1024 rows the same above
# 512, on flash_simt.cu's chunked kernels (the output head dim split over
# the grid in chunks of 512, S and dP formed over the whole head dim by
# every chunk's block) and its chunked decode.  Tolerances:
# float16 rounds where bf16 does at 2^-11 instead of 2^-8, so FWD_TOL, BWD_ROW_TOL/BWD_FLOOR (derived for bf16
# above) hold with room; the d=256 tensor-core kernels round P and dS as
# the d=128 ones do (the derivations above hold at any head dim; dK/dV's
# P^T crosses between its warpgroups in f32, unrounded); the
# simt kernels widen every element to f32 and compute as the plain
# versions do, rounding their outputs once: FWD_TOL and the row tolerance
# for bf16/f16, SIMT_F32_TOL and simt_rows for f32; the decode DECODE_TOL.
# (name, dtype, b, h, g, s, d, window, causal, route)
WIDE_CASES = [("f16_train_microbatch", "f16", 2, 32, 8, 1024, 128, None, True, "kernel"),
              ("f16_d64_window", "f16", 2, 8, 2, 333, 64, 50, True, "kernel"),
              ("gemma_microbatch", "bf16", 2, 16, 16, 512, 256, None, True, "wide"),
              ("f16_d256_window", "f16", 1, 8, 4, 333, 256, 64, True, "wide"),
              ("gemma_long", "bf16", 1, 16, 16, 4096, 256, None, True, "wide"),
              ("bf16_d192", "bf16", 2, 16, 8, 512, 192, None, True, "wide"),
              ("f32_d160_nocausal", "f32", 1, 8, 2, 200, 160, None, False, "wide"),
              ("bf16_d384", "bf16", 1, 8, 4, 512, 384, None, True, "wide"),
              ("f32_d384_window", "f32", 1, 4, 2, 300, 384, 64, True, "wide"),
              ("bf16_d512", "bf16", 1, 8, 4, 512, 512, None, True, "wide"),
              ("f32_d512", "f32", 1, 4, 2, 257, 512, None, False, "wide"),
              ("bf16_d640", "bf16", 1, 8, 4, 512, 640, None, True, "wide"),
              ("f32_d640_window", "f32", 1, 4, 2, 300, 640, 64, True, "wide"),
              ("bf16_d1024", "bf16", 1, 8, 4, 512, 1024, None, True, "wide")]
# The rows timed beside their bounds, plain versions and SDPA.
WIDE_TIMED = ("f16_train_microbatch", "gemma_microbatch", "gemma_long", "bf16_d192",
              "bf16_d384", "bf16_d512", "bf16_d640", "bf16_d1024")
# (name, kind, b, g, nh, nkv, hd, pos0, window, max_len, route)
WIDE_DECODE = [("f16_generate", "f16", 4, 1, 32, 8, 128, 527, None, 544, "kernel"),
               ("f16_int8", "f16int8", 2, 5, 8, 4, 64, 300, 64, 517, "kernel"),
               ("gemma_generate", "bf16", 2, 1, 16, 16, 256, 135, None, 144, "wide"),
               ("f16_d256", "f16", 2, 2, 8, 2, 256, 1000, 9, 1152, "wide"),
               ("int8_d256", "int8", 2, 1, 8, 8, 256, 500, None, 517, "wide"),
               ("gemma_long_cache", "bf16", 1, 1, 16, 16, 256, 4095, None, 4160, "wide"),
               ("bf16_d192_generate", "bf16", 2, 1, 16, 8, 192, 135, None, 144, "wide"),
               ("bf16_d384_generate", "bf16", 1, 1, 8, 4, 384, 299, None, 320, "wide"),
               ("int8_d384", "int8", 1, 3, 8, 4, 384, 300, 64, 517, "wide"),
               ("bf16_d512_generate", "bf16", 1, 1, 8, 4, 512, 299, None, 320, "wide"),
               ("int8_d512", "int8", 1, 1, 8, 2, 512, 510, None, 512, "wide"),
               ("bf16_d640_generate", "bf16", 1, 1, 8, 4, 640, 299, None, 320, "wide"),
               ("int8_d640", "int8", 1, 3, 8, 4, 640, 300, 64, 517, "wide"),
               ("bf16_d1024_generate", "bf16", 1, 1, 8, 4, 1024, 299, None, 320, "wide"),
               ("int8_d1024", "int8", 1, 2, 8, 2, 1024, 400, None, 517, "wide")]
# The decode rows timed: the f16 generate's, 25c's (gemma_generate, on the
# d=256 tiles of flash_decode.cu, beside flash_simt.cu's decode it
# replaced), a long live cache at Gemma's width (4096 of its 8192
# positions: the share of the bytes bound) and a d=192 cache (flash_simt.cu,
# which keeps head dims 129-255).
WIDE_DECODE_TIMED = ("f16_generate", "gemma_generate", "gemma_long_cache",
                     "bf16_d192_generate", "bf16_d384_generate", "bf16_d512_generate",
                     "bf16_d640_generate", "bf16_d1024_generate")
HALF = {"f16": "float16", "bf16": "bfloat16", "f32": "float32"}


def wide_f16_kernels(torch, tfa, tg, card):
    """WIDE_CASES and WIDE_DECODE against the plain versions; the path
    shapes (the f16 training micro-batch and generate, phase 25's Gemma
    micro-batch and generate) timed beside SDPA and the bound.  Returns
    ``(worst errors, timing rows)``."""
    worst, rows = {}, {}
    for name, kind, b, h, g, s, d, window, causal, want_route in WIDE_CASES:
        dtype = getattr(torch, HALF[kind])
        route = tfa.attention_route((b, s, h, d), (b, s, g, d), dtype, window=window).kind
        if route != want_route:
            fail(f"{kind} attention {name}: routed to {route}, expected {want_route}")
        wide = route == "wide"
        tc = wide and tfa.wide_kernel((b, s, h, d), dtype) == "tc"
        fwd = tfa._flash_fwd_wide if wide else tfa._flash_fwd
        dqf = tfa.flash_bwd_dq_wide if wide else tfa.flash_bwd_dq
        dkvf = tfa.flash_bwd_dkv_wide if wide else tfa.flash_bwd_dkv
        names = (("flash_fwd_d256", "flash_bwd_dq_d256", "flash_bwd_dkv_d256") if tc
                 else ("flash_fwd_wide", "flash_bwd_dq_wide", "flash_bwd_dkv_wide") if wide
                 else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        gen = torch.Generator(device="cuda").manual_seed(9)
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dtype)
                   for n in (h, g, g))
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        scale = d ** -0.5
        bkw = dict(causal=causal, sm_scale=scale, window=window)
        tfa.reset_launches()
        o, lse = fwd(q, k, v, causal, scale, window)
        delta = tfa._delta(do, o)
        got = (dqf(q, k, v, do, lse, delta, **bkw), *dkvf(q, k, v, do, lse, delta, **bkw))
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        if counts != {key: int(key in names) for key in counts}:
            fail(f"{kind} attention {name}: one forward and backward launched {counts}, "
                 f"expected one each of {names}")
        again = (dqf(q, k, v, do, lse, delta, **bkw), *dkvf(q, k, v, do, lse, delta, **bkw))
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"{kind} attention {name}: two backward calls disagree bitwise")
        ref_o, _ = tfa._reference_fwd(q, k, v, causal, scale, window)
        want = tfa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
        err = (o.float() - ref_o.float()).abs().max().item()
        if kind == "f32":
            ratios, tol = [simt_rows(a, c) for a, c in zip(got, want)], SIMT_F32_TOL
        else:
            ratios, tol = [bwd_rows(a, c)[0] for a, c in zip(got, want)], FWD_TOL
        if not (err <= tol and max(ratios) <= 1.0):
            fail(f"{kind} attention {name}: forward err {err:.3e} (tol {tol}), dq/dk/dv "
                 f"worst row err/tol {ratios}")
        key = ("wide_tc" if tc else "wide_simt" if wide else "f16") + f"_{kind}"
        worst[key] = max(worst.get(key, 0.0), err)
        worst[key + "_bwd"] = max(worst.get(key + "_bwd", 0.0), *(
            (a.float() - c.float()).abs().max().item() for a, c in zip(got, want)))
        worst[key + "_dq"] = max(worst.get(key + "_dq", 0.0),
                                 (got[0].float() - want[0].float()).abs().max().item())
        worst[key + "_dkv"] = max(worst.get(key + "_dkv", 0.0), *(
            (a.float() - c.float()).abs().max().item() for a, c in zip(got[1:], want[1:])))
        print(f"{kind} attention {name} ({', '.join(names)}): b={b} s={s} h={h} g={g} d={d} "
              f"window={window} causal={causal} fwd max_abs_err={err:.3e} (tol {tol}) "
              f"dq/dk/dv worst row err/tol {[round(x, 4) for x in ratios]}; backward "
              f"bitwise equal on a second call [{card}]", flush=True)
        if name not in WIDE_TIMED:
            continue
        calls = {"fwd": lambda: fwd(q, k, v, causal, scale, window),
                 "dq": lambda: dqf(q, k, v, do, lse, delta, **bkw),
                 "dkv": lambda: dkvf(q, k, v, do, lse, delta, **bkw)}
        if tc:
            # The flash_simt.cu kernels the d=256 ones replace, in this run.
            calls["fwd_simt"] = lambda: tfa._simt_fwd("fwd_simt", q, k, v, causal, scale,
                                                      window)
            calls["dq_simt"] = lambda: tfa._simt_dq("dq_simt", q, k, v, do, lse, delta,
                                                    causal, scale, window)
            calls["dkv_simt"] = lambda: tfa._simt_dkv("dkv_simt", q, k, v, do, lse, delta,
                                                      causal, scale, window)
        # The simt kernels take 18-56 ms a call at s=4096: two calls each.
        ms = {n: device_ms(torch, c, 2 if s > 1024 and n.endswith("_simt") else 5)
              for n, c in calls.items()}
        plain_fwd = device_ms(torch, lambda: tfa._reference_fwd(q, k, v, causal, scale,
                                                                window), 3, 1)
        plain_bwd = device_ms(torch, lambda: tfa._reference_grads(
            q, k, v, do, lse, delta, causal, scale, window), 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_f = sdpa_backends(torch, [(qt, kt, vt)], causal, 5)
        lib_b = sdpa_backends(torch, [(qt, kt, vt)], causal, 5, dout=do.transpose(1, 2))
        pairs = fwd_pairs(s, causal, window)
        reads = ["q", "k", "v", "do", "lse", "delta"]
        nbytes = {"fwd": attn_bytes(b, s, h, g, d, reads=["q", "k", "v"], writes=["o"])
                  + 4.0 * b * h * s,
                  "dq": attn_bytes(b, s, h, g, d, reads=reads, writes=["dq"]),
                  "dkv": attn_bytes(b, s, h, g, d, reads=reads, writes=["dk", "dv"])}
        flops = {"fwd": 4.0 * b * h * d * pairs, "dq": 6.0 * b * h * d * pairs,
                 "dkv": 8.0 * b * h * d * pairs}
        # The least time is the 16-bit tensor-core rate's (the work a
        # Hopper kernel could do there); the simt kernels run on the CUDA
        # cores, so their f32 FMA bound is printed beside.
        bounds = {n: bound(flops[n], nbytes[n]) for n in flops}
        fma = {n: bound(flops[n], nbytes[n], PEAK_F32_FLOPS)[0] for n in flops}
        earlier = (f" (flash_simt.cu in this run: fwd {ms['fwd_simt']:.4f} dq "
                   f"{ms['dq_simt']:.4f} dkv {ms['dkv_simt']:.4f})" if tc else "")
        print(f"{kind} attention timing {name}, device ms per call: fwd {ms['fwd']:.4f} dq "
              f"{ms['dq']:.4f} dkv {ms['dkv']:.4f}{earlier}; bounds (16-bit tensor cores) "
              f"{ {n: round(x[0], 4) for n, x in bounds.items()} } (f32 FMA "
              f"{ {n: round(x, 4) for n, x in fma.items()} }); plain fwd {plain_fwd:.4f} "
              f"bwd {plain_bwd:.4f}; sdpa fwd {lib_f[2]:.4f} ({lib_f[1]}) bwd "
              f"{lib_b[2]:.4f} ({lib_b[1]}, three grads) [{card}]", flush=True)
        rows[name] = dict(ms=ms, bounds=bounds, fma=fma, plain_fwd=plain_fwd,
                          plain_bwd=plain_bwd, lib_fwd=lib_f, lib_bwd=lib_b)
        del o, lse, delta, got, again, want
    for name, kind, b, g, nh, nkv, hd, pos0, window, max_len, want_route in WIDE_DECODE:
        gen = torch.Generator(device="cuda").manual_seed(10)
        qdt = torch.float16 if kind.startswith("f16") else torch.bfloat16
        q = torch.randn(b, g, nh, hd, generator=gen, device="cuda").to(qdt)
        if kind.endswith("int8"):
            ck, ks = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            cv, vs = int8_cache(torch, tg, gen, b, max_len, nkv, hd)
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            ck, cv = (torch.randn(b, max_len, nkv, hd, generator=gen, device="cuda").to(qdt)
                      for _ in range(2))
            sc = {}
        route = tfa.attention_route(q.shape, ck.shape, qdt, window=window, decode=True,
                                    cache_dtype=ck.dtype).kind
        if route != want_route:
            fail(f"decode {name}: routed to {route}, expected {want_route}")
        tc = route == "wide" and tfa.wide_kernel(q.shape, ck.dtype, decode=True) == "tc"
        key = ("flash_decode_d256" if tc else "flash_decode_wide" if route == "wide" else
               "flash_decode_int8" if kind.endswith("int8") else "flash_decode")
        tfa.reset_launches()
        out = tfa.decode_attention(q, ck, cv, pos0, window=window, **sc)
        dev = tfa.decode_attention(q, ck, cv, torch.tensor(pos0, dtype=torch.int32,
                                                           device="cuda"), window=window, **sc)
        torch.cuda.synchronize()
        counts = kernel_launches(tfa)
        if counts[key] != 2 or sum(counts.values()) != 2:
            fail(f"decode {name}: two calls launched {counts}, expected 2 of {key}")
        ref = tfa.flash_decode_reference(q, ck, cv, pos0, window=window, **sc)
        err = (out - ref).abs().max().item()
        wkey = "decode_d256" if tc else "decode_wide" if route == "wide" else "decode_f16"
        worst[wkey] = max(worst.get(wkey, 0.0), err)
        if not (err <= DECODE_TOL and torch.equal(out, dev)):
            fail(f"decode {name} ({key}): max abs err {err:.3e} (tol {DECODE_TOL}), "
                 f"device pos0 bitwise {torch.equal(out, dev)}")
        print(f"decode {name} ({key}): {kind} q {str(qdt)[6:]} cache=[{b},{max_len},{nkv},"
              f"{hd}] g={g} pos0={pos0} window={window} max_abs_err={err:.3e} (tol "
              f"{DECODE_TOL}); device pos0 bitwise equal [{card}]", flush=True)
        if name not in WIDE_DECODE_TIMED:
            continue
        live = pos0 + g
        sets = [(q, ck, cv)] + [tuple(torch.randn_like(t) for t in (q, ck, cv))
                                for _ in range(3)]
        it = {"i": 0}

        def cycle(fn):
            def run():
                it["i"] = (it["i"] + 1) % len(sets)
                fn(*sets[it["i"]])
            return run

        ms = device_ms(torch, cycle(lambda a, c, e: tfa.decode_attention(a, c, e, pos0)), 40)
        plain_ms = device_ms(torch, cycle(lambda a, c, e: tfa.flash_decode_reference(
            a, c, e, pos0)), 10, 1)
        lib = sdpa_backends(torch, [(a.transpose(1, 2), c[:, :live].transpose(1, 2),
                                     e[:, :live].transpose(1, 2)) for a, c, e in sets],
                            False, 40)
        bms, by = decode_bound(b, nh, nkv, hd, live, g, 2, False)
        simt_ms = None
        if tc:   # flash_simt.cu's decode, which the d=256 tiles replace, in this run
            simt_ms = device_ms(torch, cycle(lambda a, c, e: tfa._decode_simt_call(
                tfa.flash_decode_simt, "decode_simt", tfa.supports_decode_wide, "", a, c, e,
                pos0, None, None, None)), 10)
        print(f"decode timing {name} ({key}): cache=[{b},{max_len},{nkv},{hd}] live={live} "
              f"g={g}: ms={ms:.4f}"
              f"{'' if simt_ms is None else f' (flash_simt.cu in this run: {simt_ms:.4f})'} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib[2]:.4f} ({lib[1]}) "
              f"bound_ms={bms:.4f} ({by}) [{card}]", flush=True)
        rows[name] = dict(ms=ms, simt_ms=simt_ms, plain_ms=plain_ms, lib=lib, bound_ms=bms,
                          bound_by=by)
        del sets
    torch.cuda.empty_cache()
    return worst, rows


# The f16 path of phase 5b: Llama-3-8B's widths in float16 cut to 2
# blocks, one GPipe step (SIMT_BATCH x SIMT_SEQ, SIMT_CHUNKS
# micro-batches, except_last) and generate 4 x SIMT_PROMPT + SIMT_NEW, on
# the tensor-core kernels' f16 instantiations; the same weights in bf16
# take one step beside it as a sanity bound on the loss, not an equality:
# the two round the same products at 2^-11 and 2^-8 relative, a few
# 2^-8 of the loss after 2 blocks and the 128256-way softmax, so the
# losses within F16_BF16_REL of each other.
SIMT_F16 = dict(LLAMA3_8B, n_layers=2)
SIMT_F16_TRAIN = SIMT_D80_TRAIN
SIMT_F16_GENERATE = SIMT_D80_GENERATE
F16_BF16_REL = 2 ** -5


# Phase 23: the multi-process pipeline (torchgpipe_tpu_torch.distributed)
# at Llama-3-8B width cut to CUT_BLOCKS blocks, batch 8 x seq 1024, 4
# micro-batches, 'except_last', SGD at TRAIN_LR.  balance_by_flops(2)
# answers [3, 1] here (the head's 4096 x 128256 product outweighs a
# block at seq 1024), which puts both blocks, and so every attention
# kernel, on rank 0; the phase cuts [2, 2] instead, one block a rank, so
# that each rank's process launches the kernels (7 flash_fwd, 4 dQ and
# 4 dK/dV a step: 4 forwards and 3 recomputes, 4 backwards), and prints
# balance_by_flops' answer beside it.
DIST_BALANCE = [2, 2]
DIST_CHUNKS = 4
DIST_STEPS = 3             # steps both ranks take; rank 1 exits after them
DIST_RECV_TIMEOUT = 5.0    # a receive's steady-state deadline (a step is < 1 s)
DIST_GRACE = 120.0         # the first step's extra: the peer's start-up
DIST_CONNECT_S = 2.0       # connect deadline once both listeners are up
DIST_DEADLINE_S = 300      # the parent kills both ranks after this
DIST_WORKERS = ["rank0", "rank1"]
DIST_LAUNCHES = {"flash_fwd": DIST_CHUNKS + DIST_CHUNKS - 1, "flash_bwd_dq": DIST_CHUNKS,
                 "flash_bwd_dkv": DIST_CHUNKS}


def dist_model(torch, tt, seed: int):
    """Phase 23's layers and batches, the same in the parent and in each
    rank: random weights from the seed, built on the card."""
    import numpy as np

    cfg = llama_cfg(tt, torch, dict(LLAMA3_8B, n_layers=CUT_BLOCKS))
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    layers = list(tt.llama(cfg, device="cuda", generator=gen))
    rng = np.random.default_rng(seed + 7)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1024))).cuda()
               for _ in range(DIST_STEPS + 1)]
    return cfg, layers, batches


def dist_grads(model_layers, offset: int = 0):
    """``{"<layer index>.<param>": .grad on the host}``."""
    return {f"{offset + i}.{n}": p.grad.detach().cpu()
            for i, layer in enumerate(model_layers) for n, p in layer.named_parameters()}


def dist_rank_main(args) -> None:
    """One rank of phase 23, started by the parent as its own process:
    DIST_STEPS steps over TcpTransport on localhost, then rank 1 exits
    (``faults.should_die_at_megastep``, checked between steps) and rank 0's
    next step must raise PeerDiedError naming it.  Writes its report and
    its step-1 gradients into ``--dist-out``; prints no result line."""
    import torch

    from torchgpipe_tpu_torch.distributed import (
        DistributedGPipe, DistributedGPipeDataLoader, PeerDiedError, TcpTransport)
    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.obs.flightrec import align_clocks
    from torchgpipe_tpu_torch.ops import flash_attention as tfa
    from torchgpipe_tpu_torch.resilience import faults

    if not torch.cuda.is_available():
        raise RuntimeError("phase 23 rank: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, out = args.dist_rank, args.dist_out
    ports = [int(p) for p in args.dist_ports.split(",")]
    t_start = time.perf_counter()
    cfg, layers, batches = dist_model(torch, tt, args.seed)
    transport = TcpTransport(DIST_WORKERS[rank],
                             {w: ("127.0.0.1", p) for w, p in zip(DIST_WORKERS, ports)},
                             connect_timeout=DIST_DEADLINE_S)
    box = transport.register(DIST_WORKERS[rank])
    pipe = DistributedGPipe(layers, rank, DIST_WORKERS, DIST_BALANCE, chunks=DIST_CHUNKS,
                            transport=transport, mailbox=box, device="cuda",
                            checkpoint="except_last", recv_timeout=DIST_RECV_TIMEOUT,
                            first_step_grace=DIST_GRACE)
    del layers
    opt = torch.optim.SGD(list(pipe.parameters()), lr=TRAIN_LR)
    loss_fn = causal_lm_loss(tt)
    # The clock handshake is the rendezvous: after it both listeners are
    # up, so a refused connect means a dead peer.
    align_clocks(transport, box, rank, DIST_WORKERS, timeout=DIST_DEADLINE_S)
    transport.connect_timeout = DIST_CONNECT_S
    data = [(x, x) for x in batches] if rank == 0 else None
    loader = iter(DistributedGPipeDataLoader(
        data, rank, DIST_WORKERS, transport=transport, mailbox=box,
        num_batches=DIST_STEPS + 1, recv_timeout=DIST_RECV_TIMEOUT + DIST_GRACE))
    report = {"rank": rank, "ready_s": time.perf_counter() - t_start, "losses": [],
              "step_ms": [], "bytes_sent": [], "wait_s": []}

    def step(k):
        x, y = next(loader)
        outs = pipe.forward(x)
        if pipe.is_last:
            loss, gys, _ = pipe.loss_grads(outs, y, loss_fn)
            pipe.backward(gys)
            report["losses"].append(loss.item())
            report["loss_bits"] = report.get("loss_bits", []) + [
                int(loss.view(torch.int32).item())]
        else:
            pipe.backward()
        if k == 0:
            torch.cuda.synchronize()
            report["launches"] = kernel_launches(tfa)
            torch.save(dist_grads(pipe.partition, pipe.offset),
                       os.path.join(out, f"rank{rank}_grads.pt"))
        opt.step()

    with faults.inject(die_at_megastep=(1, DIST_STEPS)):
        for k in range(DIST_STEPS + 1):
            if faults.should_die_at_megastep(rank, k):
                report["exited_after_steps"] = k
                break
            if k == 0:
                tfa.reset_launches()
            torch.cuda.synchronize()
            t0, b0, w0 = time.perf_counter(), transport.bytes_sent, box.wait_s
            if k < DIST_STEPS:
                step(k)
            else:
                try:
                    step(k)
                except PeerDiedError as err:
                    report["peer_died"] = {"rank": err.rank, "worker": err.worker,
                                           "message": str(err),
                                           "seconds": time.perf_counter() - t0}
                    break
                raise RuntimeError(f"rank {rank}: step {k + 1} went through although "
                                   "rank 1 exited")
            torch.cuda.synchronize()
            report["step_ms"].append((time.perf_counter() - t0) * 1e3)
            report["bytes_sent"].append(transport.bytes_sent - b0)
            report["wait_s"].append(box.wait_s - w0)
    transport.close()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def dist_reference(torch, tfa, tt, card, seed: int):
    """The single-process GPipe at the phase's balance: DIST_STEPS SGD
    steps (losses, step-1 gradients on the host, launches, step times),
    then StepGuard on the same pipe."""
    import functools

    from torchgpipe_tpu_torch import GPipe
    from torchgpipe_tpu_torch.balance import balance_by_flops

    cfg, layers, batches = dist_model(torch, tt, seed)
    flops_balance = balance_by_flops(2, layers, batches[0][: 8 // DIST_CHUNKS])
    loss_fn = causal_lm_loss(tt)
    pipe = GPipe(layers, DIST_BALANCE, chunks=DIST_CHUNKS, checkpoint="except_last")
    train = pipe.make_train_step(functools.partial(torch.optim.SGD, lr=TRAIN_LR), loss_fn)
    ref = {"losses": [], "loss_bits": [], "step_ms": [], "flops_balance": flops_balance}
    for k in range(DIST_STEPS):
        if k == 0:
            tfa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = train(batches[k], batches[k])
        torch.cuda.synchronize()
        ref["step_ms"].append((time.perf_counter() - t0) * 1e3)
        ref["losses"].append(loss.item())
        ref["loss_bits"].append(int(loss.view(torch.int32).item()))
        if k == 0:
            ref["launches"] = kernel_launches(tfa)
            ref["grads"] = dist_grads(pipe)
    expect_launches(ref["launches"], {k: 2 * n for k, n in DIST_LAUNCHES.items()},
                    "phase 23's single-process step")
    ref["guard"] = dist_guard(torch, pipe, loss_fn, batches)
    del pipe, train, layers
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, ref


def dist_guard(torch, pipe, loss_fn, batches):
    """StepGuard on the single-process pipe (SGD with momentum, so there
    is optimizer state): a step whose stage-1 input is poisoned
    (``faults.inject(nan_at=(1, 0))``, ``faults.poison``) is skipped with
    parameters, optimizer state and buffers bitwise as they were, and the
    next clean step equals an unguarded step from the same state."""
    import functools

    from torchgpipe_tpu_torch.resilience import StepGuard, faults

    step = pipe.make_train_step(
        functools.partial(torch.optim.SGD, lr=TRAIN_LR, momentum=0.9), loss_fn)
    guard = StepGuard(step)

    def live():
        return list(pipe.parameters()) + list(pipe.buffers()) + opt_tensors(step.optimizers)

    def state():
        return [t.detach().clone() for t in live()]

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    guard(batches[0], batches[0])
    before = state()
    with faults.inject(nan_at=(1, 0)):
        bad, _ = guard(batches[1], batches[1])
    if torch.isfinite(bad) or guard.stats.skipped != 1:
        fail(f"StepGuard: the poisoned step gave loss {bad.item()} and "
             f"{guard.stats.skipped} skips, expected a non-finite loss skipped")
    if not same(state(), before):
        fail("StepGuard: a skipped step changed parameters, optimizer state or buffers")
    good, _ = guard(batches[2], batches[2])
    after = state()
    with torch.no_grad():
        for t, s in zip(live(), before):
            t.copy_(s)
    plain, _ = step(batches[2], batches[2])
    if not (torch.equal(good, plain) and same(after, state())):
        fail("StepGuard: the clean step after a skip differs from an unguarded step "
             "from the same state")
    out = {"skipped": guard.stats.skipped, "steps": guard.stats.steps,
           "poisoned_loss": bad.item(), "state_tensors": len(before),
           "next_step_loss": good.item()}
    del before, after
    return out


def phase_distributed(torch, tfa, tt, card, seed: int):
    """Phase 23: the single-process reference and StepGuard here, then two
    rank processes over TcpTransport on this card, each DIST_STEPS steps;
    rank 1 exits and rank 0 must name it."""
    import socket
    import sys
    import tempfile

    t_phase = time.perf_counter()
    cfg, ref = dist_reference(torch, tfa, tt, card, seed)
    t_ref = time.perf_counter() - t_phase
    socks = [socket.socket() for _ in DIST_WORKERS]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = ",".join(str(s.getsockname()[1]) for s in socks)
    for s in socks:
        s.close()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        t0 = time.perf_counter()
        for rank in range(len(DIST_WORKERS)):
            log = open(os.path.join(out, f"rank{rank}.log"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                 "--dist-rank", str(rank), "--dist-ports", ports, "--dist-out", out],
                stdout=log, stderr=subprocess.STDOUT), log))
        try:
            rcs = [p.wait(timeout=max(1.0, DIST_DEADLINE_S - (time.perf_counter() - t0)))
                   for p, _ in procs]
        except subprocess.TimeoutExpired:
            rcs = None
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        ranks_s = time.perf_counter() - t0
        logs = ""
        for rank in range(len(DIST_WORKERS)):
            with open(os.path.join(out, f"rank{rank}.log"), errors="replace") as f:
                logs += f"--- rank {rank}\n" + f.read()[-4000:]
        if rcs is None:
            fail(f"distributed: the ranks did not finish within {DIST_DEADLINE_S}s "
                 f"(killed)\n{logs}")
        if rcs != [0, 0]:
            fail(f"distributed: rank exit codes {rcs}\n{logs}")
        reports = []
        for rank in range(len(DIST_WORKERS)):
            with open(os.path.join(out, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
        grads = {}
        for rank in range(len(DIST_WORKERS)):
            grads.update(torch.load(os.path.join(out, f"rank{rank}_grads.pt")))
    r0, r1 = reports
    # Equality: the same kernels on the same micro-batches in the same
    # order, so bitwise (see PERF.md section 5 for the cause if not).
    if r1["loss_bits"][0] != ref["loss_bits"][0]:
        fail(f"distributed: step-1 loss {r1['losses'][0]!r} vs single-process "
             f"{ref['losses'][0]!r}: not bitwise equal")
    if sorted(grads) != sorted(ref["grads"]):
        fail(f"distributed: gradient names differ: {sorted(set(grads) ^ set(ref['grads']))}")
    unequal = [k for k in grads if not torch.equal(grads[k], ref["grads"][k])]
    if unequal:
        worst = max((grads[k].float() - ref["grads"][k].float()).abs().max().item()
                    for k in unequal)
        fail(f"distributed: {len(unequal)}/{len(grads)} step-1 gradients differ from the "
             f"single-process step's (worst {worst:.3e}): {unequal[:6]}")
    for rep in reports:
        expect_launches(rep["launches"], DIST_LAUNCHES, f"phase 23 rank {rep['rank']}'s step 1")
    summed = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    if summed != ref["launches"]:
        fail(f"distributed: launches summed over ranks {summed} != single-process "
             f"{ref['launches']}")
    died = r0.get("peer_died")
    if r1.get("exited_after_steps") != DIST_STEPS or not died or died["rank"] != 1 \
            or "peer rank 1 ('rank1') is dead" not in died["message"]:
        fail(f"distributed: rank 1 exited after {r1.get('exited_after_steps')} steps and "
             f"rank 0 reported {died}; expected a PeerDiedError naming rank 1")
    if died["seconds"] > DIST_RECV_TIMEOUT + 2 * DIST_CONNECT_S + 5.0:
        fail(f"distributed: the dead peer took {died['seconds']:.1f}s to name, over "
             f"recv_timeout + probe")
    later_equal = r1["loss_bits"][1:DIST_STEPS] == ref["loss_bits"][1:DIST_STEPS]
    med = {r["rank"]: statistics.median(r["step_ms"][1:DIST_STEPS]) for r in reports}
    ref_ms = statistics.median(ref["step_ms"][1:DIST_STEPS])
    staged = {r["rank"]: statistics.median(r["bytes_sent"][1:DIST_STEPS]) for r in reports}
    wait = {r["rank"]: statistics.median(r["wait_s"][1:DIST_STEPS]) for r in reports}
    g = ref["guard"]
    print(f"distributed: Llama-3-8B width, {cfg.n_layers} blocks, bf16, batch 8 x seq "
          f"1024, chunks {DIST_CHUNKS}, except_last, SGD lr {TRAIN_LR}; balance "
          f"{DIST_BALANCE} (balance_by_flops(2) = {ref['flops_balance']}); 2 rank "
          f"processes on one card over TcpTransport (localhost, host-staged): step-1 loss "
          f"{r1['losses'][0]:.6f} and {len(grads)}/{len(grads)} gradients bitwise the "
          f"single-process GPipe's; steps 2-3 losses bitwise: {later_equal}; launches "
          f"rank 0 {r0['launches']}, rank 1 {r1['launches']}, summed = single-process; "
          f"rank 1 exited after {DIST_STEPS} steps and rank 0 raised PeerDiedError in "
          f"{died['seconds']:.2f}s: {died['message']!r}; StepGuard: poisoned step "
          f"skipped with all {g['state_tensors']} state tensors bitwise as before, the "
          f"next step bitwise an unguarded one [{card}]", flush=True)
    print(f"distributed: step_ms (median of steps 2-3) rank 0 {med[0]:.1f}, rank 1 "
          f"{med[1]:.1f} vs single-process {ref_ms:.1f}; bytes staged through the host "
          f"a step: rank 0 {staged[0]:.0f}, rank 1 {staged[1]:.0f}; waiting in "
          f"Mailbox.get a step: rank 0 {wait[0] * 1e3:.1f} ms, rank 1 {wait[1] * 1e3:.1f} "
          f"ms; the two ranks' contexts time-slice one card, so this measures transport "
          f"and schedule, not overlap across cards; ranks started in "
          f"{max(r['ready_s'] for r in reports):.1f}s, ran in {ranks_s:.1f}s, reference "
          f"and guard {t_ref:.1f}s [{card}]", flush=True)
    result = {"card": card, "balance": DIST_BALANCE, "flops_balance": ref["flops_balance"],
              "losses": r1["losses"], "single_process_losses": ref["losses"],
              "later_losses_bitwise": later_equal, "grads_bitwise": len(grads),
              "launches": {r["rank"]: r["launches"] for r in reports},
              "launches_sum": summed, "peer_died": died,
              "step_ms": {r["rank"]: r["step_ms"] for r in reports},
              "single_process_step_ms": ref["step_ms"], "bytes_staged": staged,
              "mailbox_wait_s": wait, "guard": g, "ranks_s": ranks_s}
    print(json.dumps({"distributed": result}), flush=True)
    return result


# --------------------------------------------------------------------- #
# phase 24: the serving fleet                                            #
# --------------------------------------------------------------------- #

# The fleet's trace (24a, 24b): fleet.synthetic_trace at the model's
# vocab, 4 tenants whose system prompts are 256-512 tokens, suffixes of
# 16-128 and budgets of 32-96 new tokens (prompt + budget <= 1152, the
# serving pool's max_len).  Arrivals by router step: 16 at once, then 4
# every 8 steps; replica r0 dies before its own step 30, mid-decode.  32
# requests keep the phase short within the run's limit: the arrivals
# still run past r0's death, and 24d/24e take theirs from the first 20.
FLEET_TRACE = dict(n_requests=32, vocab=128256, n_tenants=4, prefix_len=(256, 512),
                   suffix_len=(16, 128), new_tokens=(32, 96), max_len=1152)
FLEET_FIRST, FLEET_EVERY, FLEET_BATCH, FLEET_DIE_AT = 16, 8, 4, 30
# The prefix cache: up to 4 of a replica's 8 slots pinned as donors, and
# no reuse shorter than 16 tokens.
FLEET_PC = dict(min_prefix_len=16, max_entries=4)
FLEET_GAMMA = 4
# The rows the row-copy programs write are compared with their source
# after every copy; a replay is compared with its eager body once.
FLEET_STATS = dict(SERVE_STATS, prefix_copy=1)


def fleet_engines(Engine, cfg, model, names, prefix=None, **kw):
    """One engine per name on ``model`` (phase 9's configuration), each
    with a prefix cache of its own when ``prefix`` (the fleet package) is
    given."""
    return {n: Engine(cfg, model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prefill_chunk=SERVE_LADDER, prefix_cache=None if prefix is None
                      else prefix.RadixPrefixCache(**FLEET_PC), **kw) for n in names}


def warm_engine(np, fleet, eng, vocab, seed):
    """Capture every program of a unified engine once, served alone: one
    request per ladder bucket (8, 64 and 256 prompt tokens, 2 new), and
    with a prefix cache one that extends the 256-token prompt (its hit
    captures prefix_copy); then a fresh trie, the warm-up's pins
    released."""
    rng = np.random.RandomState(seed)
    for g in SERVE_LADDER:
        p = rng.randint(0, vocab, g).astype(np.int32)
        serve_all(eng, [(p, 2)])
    if eng._prefix_cache is not None:
        serve_all(eng, [(np.concatenate([p, rng.randint(0, vocab, 8).astype(np.int32)]), 2)])
        if eng._prefix_cache.hits != 1:
            fail(f"fleet: the warm-up's prefix hit did not happen {eng._prefix_cache.stats()}")
        eng._prefix_cache.clear(eng.pool)
        eng._prefix_cache = fleet.RadixPrefixCache(**FLEET_PC)


def fresh_books(obs, ServingMetrics, engines, recorders=None):
    """A registry of their own for the timed run (the warm-up's requests
    out of its series), each engine's metrics on it by replica label."""
    shared = obs.MetricsRegistry()
    for n, eng in engines.items():
        eng.metrics = ServingMetrics(registry=shared.labeled(replica=n))
        eng.drain_hooks.clear()
        if recorders is not None:
            eng.recorder = recorders[n]
    return shared


def drive_fleet(router, trace):
    """Submit ``trace`` (``TraceRequest``s, each under its session) as
    arrivals by router step and step the router until idle.  Returns
    ``{rid: (prompt, max_new_tokens)}`` and the router steps."""
    reqs, nxt, steps = {}, 0, 0

    def upto(k):
        nonlocal nxt
        while nxt < min(k, len(trace)):
            t = trace[nxt]
            reqs[router.submit(t.prompt, t.max_new_tokens, session=t.session)] = (
                t.prompt, t.max_new_tokens)
            nxt += 1

    upto(FLEET_FIRST)
    while True:
        due = FLEET_EVERY * ((nxt - FLEET_FIRST) // FLEET_BATCH + 1)
        if nxt < len(trace) and steps >= due:
            upto(nxt + FLEET_BATCH)
        if router.step():
            steps += 1
        elif nxt < len(trace):
            steps = due          # idle before the next arrival: it comes now
        else:
            break
    return reqs, steps


def rows_checked(torch, eng, log):
    """Wrap ``eng``'s row-copy dispatch: after each ``prefix_copy`` or
    ``migrate_ingest``, rows [0, n) of the destination slot in every layer
    must be bitwise the donor slot's (or the shipped rows'); counts in
    ``log``, and the checks' own seconds in ``log["check_s"]`` (timings
    that span a copy leave them out)."""
    real = eng._run_rows

    def run(name, src, dst, n, rows=None):
        real(name, src, dst, n, rows=rows)
        t0 = time.perf_counter()
        c = eng.pool.cache
        with torch.inference_mode():
            for kind in ("k", "v"):
                for i, bank in enumerate(getattr(c, kind)):
                    want = bank[src, :n] if rows is None else rows[kind][i][:n]
                    if not torch.equal(bank[dst, :n], want):
                        fail(f"fleet: {name} wrote rows [0, {n}) of slot {dst} that are not "
                             f"the {'donor slot ' + str(src) if rows is None else 'shipped'} "
                             f"rows ({kind} layer {i})")
        log[name] = log.get(name, 0) + 1
        log["check_s"] = log.get("check_s", 0.0) + time.perf_counter() - t0

    eng._run_rows = run


def replay_equals_body(torch, eng, name, state):
    """Program ``name``'s graph replayed once and its eager body run once
    from the same state (``state``: every tensor it reads or writes), on
    the inputs it last ran with: bitwise equal, the state restored."""
    prog = eng._programs[name]
    if prog.graph is None:
        fail(f"fleet: {name} has no captured graph")
    with torch.inference_mode():
        torch.cuda.synchronize()
        saved = [t.clone() for t in state]
        prog.graph.replay()
        after = [t.clone() for t in state]
        for t, s in zip(state, saved):
            t.copy_(s)
        prog.body(eng)
        same = all(torch.equal(a, t) for a, t in zip(after, state))
        for t, s in zip(state, saved):
            t.copy_(s)
        torch.cuda.synchronize()
    del saved, after
    if not same:
        fail(f"fleet: the replay of {name} is not bitwise its eager body")
    return True


def stitched(obs, recorders, rids, moved):
    """Every request's span tree from the replicas' and the router's
    flight dumps: no orphan, complete; a moved request spans two
    attempts or more.  Returns the attempts and migrations counted."""
    from torchgpipe_tpu_torch.obs.flightrec import dump_from_dict

    dumps = [dump_from_dict(r.to_dict()) for r in recorders]
    attempts = migrations = 0
    for rid in rids:
        t = obs.stitch_request(dumps, rid)
        if t.orphans or not t.complete:
            fail(f"fleet: request {rid}'s trace has orphans {t.orphans} / is incomplete:\n"
                 + obs.format_request_tree(t))
        n_att = sum(1 for s in t.root.children if s.name.startswith("attempt@"))
        if rid in moved and t.migrations < 1:
            fail(f"fleet: moved request {rid} stitched with no migration:\n"
                 + obs.format_request_tree(t))
        attempts += n_att
        migrations += t.migrations
    return {"requests": len(rids), "attempts": attempts, "migrations": migrations,
            "orphans": 0, "events": sum(len(d.events) for d in dumps)}


def latency(np, shared, engines):
    """TTFT/TPOT p50/p99 per replica from the shared registry's
    histograms, and pooled over every replica's request records."""
    out = {}
    for metric in ("ttft", "tpot"):
        h = shared.get(f"serving_{metric}_seconds")
        per = {n: {"p50": h.percentile(0.5, replica=n), "p99": h.percentile(0.99, replica=n)}
               for n in engines} if h is not None else {}
        vals = [getattr(r, metric) for e in engines.values()
                for r in e.metrics.requests.values() if getattr(r, metric) is not None]
        out[metric] = {"by_replica": per,
                       "pooled_p50": float(np.percentile(vals, 50)) if vals else None,
                       "pooled_p99": float(np.percentile(vals, 99)) if vals else None}
    return out


def fleet_run(torch, np, fleet, obs, faults, tfa, engines, trace, seed, what):
    """24a/24b: two replicas behind a Router with a shared registry and a
    FlightRecorder each; r0 dies before its step FLEET_DIE_AT.  Gates
    every request finishing at its length, the streams, one capture per
    program, the stitched traces and zero hand-written kernel launches."""
    from torchgpipe_tpu_torch.serving import ServingMetrics

    recs = {n: obs.FlightRecorder(capacity=1 << 16, worker=n) for n in engines}
    router_rec = obs.FlightRecorder(capacity=1 << 16, worker="router")
    shared = fresh_books(obs, ServingMetrics, engines, recs)
    router = fleet.Router(engines, registry=shared, seed=seed, recorder=router_rec)
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with faults.inject(die_at_step=(0, FLEET_DIE_AT)):
        reqs, steps = drive_fleet(router, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_launches(tfa)
    expect_launches(counts, {}, f"the fleet ({what})")
    if router.replicas["r0"].alive or router._c_failovers.value() != 1:
        fail(f"fleet ({what}): r0 did not die at its step {FLEET_DIE_AT}")
    results = {rid: router.result(rid).tolist() for rid in reqs}
    short = [rid for rid, (_, n) in reqs.items() if len(results[rid]) != n]
    if len(reqs) != len(trace) or short:
        fail(f"fleet ({what}): {len(short)} of {len(reqs)} requests did not finish: {short}")
    moved = {rid for rid in reqs if router._records[rid].moves}
    if not moved:
        fail(f"fleet ({what}): r0's death moved no in-flight request")
    for n, eng in engines.items():
        want = FLEET_STATS if eng._prefix_cache is not None else SERVE_STATS
        if eng.compile_stats != want or eng.program_count != len(want):
            fail(f"fleet ({what}): {n} captured {eng.compile_stats} ({eng.program_count} "
                 f"programs), expected {want}")
    traces = stitched(obs, [*recs.values(), router_rec], list(reqs), moved)
    for eng in engines.values():
        eng.recorder = None
    tokens = sum(len(t) for t in results.values())
    out = {"requests": len(reqs), "router_steps": steps, "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "moved": len(moved),
           "routed": {n: router._c_routed.value(replica=n) for n in engines},
           "latency": latency(np, shared, engines), "reqtrace": traces,
           "compile_stats": {n: e.compile_stats for n, e in engines.items()},
           "kernel_launches": counts,
           "streams": [(reqs[r][0], results[r]) for r in reqs]}
    return out, router


def phase_fleet(torch, tfa, tt, card, seed, cfg, model):
    """The serving fleet at Llama-3-8B width on phase 6's model (its
    replicas share that one copy of the weights): 24a a router over two
    replicas with a failover, 24b the same with the radix prefix cache,
    24c a prefill/decode pair with KV migration, 24d the speculative
    engine beside a plain one, 24e the autoscaler and a rollout with a
    rollback, then the flight recorder's cost on the captured decode
    step.  No hand-written kernel runs on these paths (the slot step's
    dense read, as in phase 9): every sub-phase's launch gate reads 0
    before its teacher-forced check, which runs the model's forward."""
    import copy

    import numpy as np

    from torchgpipe_tpu_torch import fleet, obs
    from torchgpipe_tpu_torch.resilience import faults
    from torchgpipe_tpu_torch.serving import Engine, ServingMetrics

    out = {"card": card, "model": f"Llama-3-8B width, {cfg.n_layers} layers, bf16, random "
                                  f"from seed {seed}, shared by every replica",
           "engine": {"num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                      "prefill_chunk": list(SERVE_LADDER)}}
    tcfg = fleet.TraceConfig(seed=seed, **FLEET_TRACE)
    tstats = fleet.TraceStats()
    trace = list(fleet.synthetic_trace(tcfg, tstats))
    out["trace"] = {"config": FLEET_TRACE, "skipped_too_long": tstats.skipped_too_long,
                    "shareable_fraction": tstats.shareable_fraction,
                    "prompt_tokens": tstats.total_prompt_tokens,
                    "arrivals": f"{FLEET_FIRST} at once, {FLEET_BATCH} every {FLEET_EVERY} "
                                f"router steps; r0 dies before its step {FLEET_DIE_AT}"}

    def check_streams(streams, what, check_model=model):
        return stream_check(torch, check_model, streams, TF_AGREE, TF_GAP, f"fleet ({what})")

    # 24a. Two unified replicas behind a router; r0 dies mid-trace.
    t_sub = time.perf_counter()
    engines = fleet_engines(Engine, cfg, model, ("r0", "r1"))
    for i, eng in enumerate(engines.values()):
        warm_engine(np, fleet, eng, cfg.vocab, seed + 10 + i)
    if engines["r0"].weights_key() != engines["r1"].weights_key():
        fail("fleet: the replicas do not share the model's weights")
    a, router = fleet_run(torch, np, fleet, obs, faults, tfa, engines, trace, seed,
                          "24a router")
    a["teacher_forced"] = check_streams(a.pop("streams"), "24a router")
    a["seconds"] = time.perf_counter() - t_sub
    out["24a_router"] = a

    # 24b. The same trace on two replicas with the radix prefix cache.
    t_sub = time.perf_counter()
    pcs = fleet_engines(Engine, cfg, model, ("r0", "r1"), prefix=fleet)
    rows_log = {}
    for i, eng in enumerate(pcs.values()):
        warm_engine(np, fleet, eng, cfg.vocab, seed + 20 + i)
        rows_checked(torch, eng, rows_log)
    b, router_b = fleet_run(torch, np, fleet, obs, faults, tfa, pcs, trace, seed,
                            "24b prefix")
    b["teacher_forced"] = check_streams(b.pop("streams"), "24b prefix")
    hits = sum(e._prefix_cache.hits for e in pcs.values())
    looks = hits + sum(e._prefix_cache.misses for e in pcs.values())
    b["prefix"] = {"hits": hits, "lookups": looks, "hit_rate": hits / max(looks, 1),
                   "prefill_tokens_saved": sum(e.metrics.prefix_reused_tokens
                                               for e in pcs.values()),
                   "prompt_tokens": tstats.total_prompt_tokens,
                   "rows_checked_copies": rows_log.get("prefix_copy", 0),
                   "by_replica": {n: e._prefix_cache.stats() for n, e in pcs.items()}}
    if not hits or rows_log.get("prefix_copy", 0) != hits:
        fail(f"fleet (24b): prefix hits {hits}, copies checked {rows_log}")
    donor = pcs["r1"]
    b["prefix_copy_replay_equals_body"] = replay_equals_body(
        torch, donor, "prefix_copy", pool_buffers(donor))
    for eng in pcs.values():
        eng.pool.check_refcounts()
    b["seconds"] = time.perf_counter() - t_sub
    out["24b_prefix"] = b
    del pcs, donor, router_b
    gc.collect()
    torch.cuda.empty_cache()

    # 24c. A prefill replica and a decode replica: every prompt migrates.
    t_sub = time.perf_counter()
    dcfg_trace = fleet.prefill_heavy_config(32, seed=seed, max_len=SERVE_MAX_LEN,
                                            vocab=cfg.vocab)
    dtrace = list(fleet.synthetic_trace(dcfg_trace))
    pair = {"p0": fleet_engines(Engine, cfg, model, ("p0",), role="prefill")["p0"],
            "d0": fleet_engines(Engine, cfg, model, ("d0",), role="decode")["d0"]}
    fleet.validate_pools(pair["p0"], pair["d0"])
    warm = fleet.Router(pair, seed=seed)
    rng = np.random.RandomState(seed + 30)
    for g in SERVE_LADDER:
        warm.submit(rng.randint(0, cfg.vocab, g).astype(np.int32), 2, rid=f"warm{g}")
        warm.run()
    rows_log = {}
    rows_checked(torch, pair["d0"], rows_log)
    recs = {n: obs.FlightRecorder(capacity=1 << 16, worker=n) for n in pair}
    router_rec = obs.FlightRecorder(capacity=1 << 16, worker="router")
    shared = fresh_books(obs, ServingMetrics, pair, recs)
    router_c = fleet.Router(pair, registry=shared, seed=seed, recorder=router_rec)
    per_pos = sum(t.numel() * t.element_size() // SERVE_MAX_LEN
                  for t in pool_buffers(pair["d0"])) // SERVE_SLOTS
    payload = sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype).element_size()
                  for v in pair["d0"].kv_row_specs().values() for s in v)
    mig = {"ms": [], "rows": []}
    real_migrate = fleet.migration.migrate

    def timed_migrate(src, dst, req, **kw):
        torch.cuda.synchronize()
        t0, checks = time.perf_counter(), rows_log.get("check_s", 0.0)
        rid = real_migrate(src, dst, req, **kw)
        torch.cuda.synchronize()
        checks = rows_log.get("check_s", 0.0) - checks
        mig["ms"].append((time.perf_counter() - t0 - checks) * 1e3)
        mig["rows"].append(req.prompt_len)
        return rid

    fleet.migration.migrate = timed_migrate
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        creqs = {router_c.submit(t.prompt, t.max_new_tokens, session=t.session):
                 (t.prompt, t.max_new_tokens) for t in dtrace}
        router_c.run()
    finally:
        fleet.migration.migrate = real_migrate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_launches(tfa)
    expect_launches(counts, {}, "the fleet (24c disaggregated)")
    cres = {rid: router_c.result(rid).tolist() for rid in creqs}
    short = [rid for rid, (_, n) in creqs.items() if len(cres[rid]) != n]
    if short:
        fail(f"fleet (24c): requests short of their budget: {short}")
    n_mig = int(shared.counter("fleet_migrations").value())
    if n_mig != len(creqs) or len(mig["ms"]) != n_mig or rows_log.get("migrate_ingest") != n_mig:
        fail(f"fleet (24c): {n_mig} migrations for {len(creqs)} requests, "
             f"{len(mig['ms'])} timed, {rows_log} row checks")
    want_p = {f"prefill@{g}": 1 for g in SERVE_LADDER}
    if pair["p0"].compile_stats != want_p or pair["d0"].compile_stats != {
            "decode": 1, "migrate_ingest": 1} or pair["p0"].program_count != 3 or \
            pair["d0"].program_count != 2:
        fail(f"fleet (24c): captures {pair['p0'].compile_stats} / {pair['d0'].compile_stats}")
    traces = stitched(obs, [*recs.values(), router_rec], list(creqs), set(creqs))
    if traces["migrations"] != len(creqs):
        fail(f"fleet (24c): {traces['migrations']} stitched handoffs for {len(creqs)} requests")
    c = {"requests": len(creqs), "wall_s": wall,
         "tokens": sum(len(t) for t in cres.values()),
         "migrations": n_mig, "ms_per_migration": {
             "median": statistics.median(mig["ms"]), "max": max(mig["ms"]),
             "min": min(mig["ms"])},
         "live_bytes_shipped": sum(mig["rows"]) * per_pos,
         "live_bytes_per_position": per_pos,
         "payload_bytes_per_migration": payload,
         "rows_checked": rows_log["migrate_ingest"],
         "latency": latency(np, shared, pair), "reqtrace": traces,
         "compile_stats": {n: e.compile_stats for n, e in pair.items()},
         "kernel_launches": counts}
    c["migrate_ingest_replay_equals_body"] = replay_equals_body(
        torch, pair["d0"], "migrate_ingest", pool_buffers(pair["d0"]))
    c["teacher_forced"] = check_streams([(p, cres[r]) for r, (p, _) in creqs.items()],
                                        "24c disaggregated")
    c["seconds"] = time.perf_counter() - t_sub
    out["24c_disagg"] = c
    del pair, warm, router_c
    gc.collect()
    torch.cuda.empty_cache()

    # 24d. The speculative engine (the random 1b draft of phase 6c, gamma
    # 4) on 8 requests, beside 24a's surviving plain replica.
    t_sub = time.perf_counter()
    dcfg = llama_cfg(tt, torch, LLAMA_1B)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    draft = tt.llama(dcfg, device="cuda", generator=gen)
    spec = fleet.SpeculativeEngine(cfg, model, dcfg, draft, gamma=FLEET_GAMMA,
                                   num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                   prefill_chunk=SERVE_LADDER)
    warm_engine(np, fleet, spec, cfg.vocab, seed + 40)
    sreqs = [(t.prompt, t.max_new_tokens) for t in trace[:SERVE_SLOTS]]
    plain = engines["r1"]
    plain.drain_hooks.clear()
    runs = {}
    tfa.reset_launches()
    for name, eng in (("speculative", spec), ("plain", plain), ("speculative", spec),
                      ("plain", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve_all(eng, sreqs)
        torch.cuda.synchronize()
        runs.setdefault(name, []).append((time.perf_counter() - t0, res))
    counts = kernel_launches(tfa)
    expect_launches(counts, {}, "the fleet (24d speculative)")
    toks = sum(n for _, n in sreqs)
    d = {"requests": len(sreqs), "tokens": toks, "gamma": FLEET_GAMMA,
         "draft": f"llama_speed 1b ({dcfg.dim} dim, {dcfg.n_layers} layers), random from "
                  f"seed {seed + 2}",
         "acceptance": spec.acceptance_rate,
         "rounds": spec._c_rounds.value(), "proposed": spec._c_proposed.value(),
         "accepted": spec._c_accepted.value(), "kernel_launches": counts}
    for name, rs in runs.items():
        walls = [w for w, _ in rs]
        d[name] = {"wall_s": walls, "tokens_per_s": [toks / w for w in walls],
                   "ms_per_token_of_a_stream": [w * 1e3 / (toks / len(sreqs)) for w in walls]}
        for w, res in rs:
            short = [r for (p, n), r in zip(sreqs, res) if len(res[r]) != n]
            if short:
                fail(f"fleet (24d {name}): streams short of their budget {short}")
    # The speculative round never runs the plain decode program (the
    # reference's count keeps it: its program_count is the base bound plus
    # the drafts).
    want_spec = dict(SERVE_STATS, decode=0, **{f"draft@{g}": 1 for g in spec.draft_buckets})
    if spec.compile_stats != want_spec or spec.program_count != len(want_spec):
        fail(f"fleet (24d): captures {spec.compile_stats} ({spec.program_count} programs), "
             f"expected {want_spec}")
    d["compile_stats"] = spec.compile_stats
    d["draft_replays_equal_bodies"] = {
        name: replay_equals_body(
            torch, spec, name, spec.draft_pool.cache.k + spec.draft_pool.cache.v
            + [spec._draft_lengths, spec._programs[name].tok])
        for name in (f"draft@{g}" for g in spec.draft_buckets)}
    res = runs["speculative"][-1][1]
    d["teacher_forced"] = check_streams([(p, res[r]) for (p, _), r in zip(sreqs, res)],
                                        "24d speculative")
    pres = runs["plain"][-1][1]
    d["token_agreement_with_plain"] = float(np.mean(
        [a == b for r, s in zip(res, pres) for a, b in zip(res[r], pres[s])]))
    d["seconds"] = time.perf_counter() - t_sub
    out["24d_speculative"] = d
    del spec, draft
    gc.collect()
    torch.cuda.empty_cache()

    # 24e. The autoscaler, then a rollout and its rollback, over 24a's two
    # replicas on a virtual registry clock.
    t_sub = time.perf_counter()

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    vclock = Clock()
    vreg = obs.MetricsRegistry(clock=vclock)
    for eng in engines.values():      # r0's failover drain left it closed
        eng.drain_hooks.clear()
        eng.resume_serving()
    router_e = fleet.Router(engines, registry=vreg, seed=seed)
    scaler = fleet.Autoscaler(router_e, service_time_s=1.0, window_s=1.0, headroom=1.0,
                              hold_ticks=1, min_replicas=1)
    ereqs = [(t.prompt, min(t.max_new_tokens, 32)) for t in trace[8:20]]
    actions, rids = [], []
    tfa.reset_launches()
    # Request ids of their own: 24a's finished requests keep theirs on
    # these engines.
    for i, (p, n) in enumerate(ereqs[:6]):
        scaler.observe_arrival()
        rids.append(router_e.submit(p, n, rid=f"scale{i}"))
    for _ in range(3):
        router_e.step()
    vclock.t += 5.0                       # the arrivals age out of the window
    actions.append(scaler.tick())
    for _ in range(3):
        router_e.step()
    scaler.observe_arrival(40)            # a burst: 40/s x 1 s over 8 slots
    for i, (p, n) in enumerate(ereqs[6:], 6):
        rids.append(router_e.submit(p, n, rid=f"scale{i}"))
    actions.append(scaler.tick())
    router_e.run()
    if actions != ["down:r1", "up:r1"]:
        fail(f"fleet (24e): autoscaler actions {actions}, expected ['down:r1', 'up:r1']")
    eres = {r: router_e.result(r).tolist() for r in rids}
    if any(len(eres[r]) != n for r, (_, n) in zip(rids, ereqs)):
        fail("fleet (24e): a request was dropped across the scale-down and up")
    e = {"autoscaler": {"actions": actions, "requests": len(rids),
                        "moved": sum(1 for r in rids if router_e._records[r].moves)}}

    head = model[-1]
    w0 = head.w.detach().clone()
    head_v1 = copy.deepcopy(head)
    with torch.no_grad():
        head_v1.w.neg_()                  # version 1: a different head
    v1 = [*list(model)[:-1], head_v1]
    v1_model = torch.nn.Sequential(*v1)
    ctl = fleet.RolloutController(router_e)
    steps = [ctl.publish(v1, 1)]
    vreqs = [(t.prompt, 24) for t in trace[20:24]]
    first = [router_e.submit(p, n, rid=f"v1-{i}") for i, (p, n) in enumerate(vreqs)]
    steps.append(ctl.tick())
    if steps[-1] != "swap:r0:v1" or ctl.versions() != {"r0": 1, "r1": 1}:
        fail(f"fleet (24e): rollout {steps}, versions {ctl.versions()}")
    with torch.inference_mode():
        swapped = torch.equal(head.w, head_v1.w)
    router_e.run()
    v1_streams = [(p, router_e.result(r).tolist()) for (p, _), r in zip(vreqs, first)]
    steps.append(ctl.rollback("drill"))
    steps.append(ctl.tick())
    with torch.inference_mode():
        restored = torch.equal(head.w, w0)
    if steps[2:] != ["rollback:v0", "swap:r0:v0"] or not (swapped and restored) or \
            ctl.versions() != {"r0": 0, "r1": 0}:
        fail(f"fleet (24e): rollback {steps}, versions {ctl.versions()}, head swapped "
             f"{swapped}, restored bitwise {restored}")
    second = [router_e.submit(p, n, rid=f"v0-{i}") for i, (p, n) in enumerate(vreqs)]
    router_e.run()
    v0_streams = [(p, router_e.result(r).tolist()) for (p, _), r in zip(vreqs, second)]
    counts = kernel_launches(tfa)
    expect_launches(counts, {}, "the fleet (24e autoscaler and rollout)")
    if any(len(t) != n for (_, t), (_, n) in zip(v1_streams + v0_streams, vreqs * 2)):
        fail("fleet (24e): a request was dropped across the rollout")
    for n, eng in engines.items():
        if eng.compile_stats != SERVE_STATS:
            fail(f"fleet (24e): {n} recaptured across drain/swap/resume: {eng.compile_stats}")
    e["rollout"] = {"actions": steps, "head_swapped_bitwise": swapped,
                    "restored_bitwise": restored,
                    "v1_tokens_differ": float(np.mean([a != b for (_, x), (_, y) in zip(
                        v1_streams, v0_streams) for a, b in zip(x, y)]))}
    e["teacher_forced"] = check_streams(
        [(p, eres[r]) for r, (p, _) in zip(rids, ereqs)] + v0_streams, "24e v0")
    e["teacher_forced_v1"] = check_streams(v1_streams, "24e v1", v1_model)
    del v1_model, v1, head_v1, w0, ctl
    e["seconds"] = time.perf_counter() - t_sub
    out["24e_autoscale_rollout"] = e

    # The flight recorder's cost: the captured 8-slot decode step with and
    # without recorder=, alternated on one engine in windows of 8 steps.
    eng = engines["r1"]
    eng.drain_hooks.clear()
    rec = obs.FlightRecorder(capacity=1 << 16, worker="r1")
    for t in trace[:SERVE_SLOTS]:
        eng.submit(t.prompt[:64], min(400, SERVE_MAX_LEN - 64), rid=f"cost{t.index}")
    while eng.scheduler.queue or eng.scheduler.prefill_pending():
        eng.step()
    cost = {"off": [], "on": []}
    for order in (("on", "off"), ("off", "on")) * 3:
        for mode in order:
            eng.recorder = rec if mode == "on" else None
            cost[mode].append(step_ms(torch, eng, 8))
    eng.drain()                 # recorded: the coalesced decode groups flush
    eng.recorder = None
    med = {k: statistics.median(sum(v, [])) for k, v in cost.items()}
    out["recorder_cost"] = {
        "decode_step_ms_median": med, "window_medians": {
            k: [statistics.median(w) for w in v] for k, v in cost.items()},
        "on_minus_off_ms": med["on"] - med["off"],
        "on_over_off": med["on"] / med["off"], "events": len(rec.events())}
    del router_e, router, engines, eng, plain
    gc.collect()
    torch.cuda.empty_cache()

    a, b, c, d, r = (out["24a_router"], out["24b_prefix"], out["24c_disagg"],
                     out["24d_speculative"], out["recorder_cost"])
    for key, row in (("24a", a), ("24b", b)):
        lat = row["latency"]
        print(f"fleet {key}: {row['requests']} requests in {row['wall_s']:.3f}s, "
              f"{row['tokens']} tokens = {row['tokens_per_s']:.2f} tokens/s fleet-wide, "
              f"r0 died at its step {FLEET_DIE_AT}, {row['moved']} moved to r1; TTFT p50/p99 "
              f"(pooled) {lat['ttft']['pooled_p50']:.4f}/{lat['ttft']['pooled_p99']:.4f}s, "
              f"TPOT {lat['tpot']['pooled_p50']:.5f}/{lat['tpot']['pooled_p99']:.5f}s; "
              f"reqtrace {row['reqtrace']} [{card}]", flush=True)
    print(f"fleet 24b prefix: hit rate {b['prefix']['hit_rate']:.4f} ({b['prefix']['hits']} "
          f"of {b['prefix']['lookups']}), prefill tokens saved "
          f"{b['prefix']['prefill_tokens_saved']} of {b['prefix']['prompt_tokens']}, every "
          f"copy's rows bitwise the donor's, replay == eager body [{card}]", flush=True)
    print(f"fleet 24c disaggregated: {c['requests']} requests, {c['migrations']} migrations, "
          f"{c['live_bytes_shipped'] / 1e6:.2f} MB of live rows shipped "
          f"({c['payload_bytes_per_migration'] / 1e6:.2f} MB fixed-shape payload each), "
          f"ms per migrated request median {c['ms_per_migration']['median']:.3f} "
          f"(max {c['ms_per_migration']['max']:.3f}) [{card}]", flush=True)
    print(f"fleet 24d speculative: acceptance {d['acceptance']:.4f}, ms/token of a stream "
          f"{d['speculative']['ms_per_token_of_a_stream']} beside the plain engine's "
          f"{d['plain']['ms_per_token_of_a_stream']} [{card}]", flush=True)
    print(f"fleet recorder cost: captured 8-slot decode step median {r['decode_step_ms_median']}"
          f" ms, on - off {r['on_minus_off_ms']:.4f} ms ({r['on_over_off']:.4f}x) [{card}]",
          flush=True)
    print(json.dumps({"fleet": out}), flush=True)
    return out


# Every phase by number and name, in the order a run takes them, with the
# phases whose results it needs (``--phases``).
# --------------------------------------------------------------------- #
# phase 25: the SPMD engine (torchgpipe_tpu_torch.spmd)                  #
# --------------------------------------------------------------------- #

# Gemma-7B's published widths (HF google/gemma-7b config.json, as the
# reference's models/hf_interop.from_hf_gemma maps it: head dim 256, the
# tanh gelu, the embedding scaled by sqrt(dim), tied embeddings; an ffn of
# 24576 is mlp_ratio 12 under the gated 2/3 rule) in bf16, cut to 2 of its
# 28 blocks, one block a stage.
GEMMA_7B = dict(vocab=256000, dim=3072, n_layers=2, n_heads=16, n_kv_heads=16,
                n_head_dim=256, mlp_ratio=12.0, act="gelu_tanh",
                embed_scale=math.sqrt(3072), tie_embeddings=True, rope_theta=10000.0,
                norm_eps=1e-6)
SPMD_BATCH, SPMD_SEQ, SPMD_CHUNKS, SPMD_STEPS = 4, 512, 2, 2
SPMD_LR = TRAIN_LR
SPMD_PROMPT, SPMD_NEW = 128, 16
SPMD_DEADLINE_S = 420
# A rank's launches in a step: its one block a stage under 'except_last'
# at SPMD_CHUNKS micro-batches: two forwards and one recompute, two
# backwards, on the wide route (head dim 256: the forward, dQ and dK/dV on
# the tensor-core kernels' d=256 instantiation); none of the others.
# SPMD_PROFILE: the CUDA function (its instantiation) of each of those
# counters and of the simt forward, dQ and dK/dV, whose launches a
# profile of 25a's step 2 must show as the counters say (none on simt).
SPMD_LAUNCHES = {"flash_fwd_d256": SPMD_CHUNKS + SPMD_CHUNKS - 1,
                 "flash_bwd_dq_d256": SPMD_CHUNKS, "flash_bwd_dkv_d256": SPMD_CHUNKS}
SPMD_PROFILE = {"flash_fwd_d256": "flash_fwd_kernel<256", "flash_bwd_dq_d256":
                "flash_bwd_dq_kernel<256", "flash_bwd_dkv_d256": "flash_bwd_dkv_kernel<256",
                "flash_fwd_wide": "fwd_simt_kernel", "flash_bwd_dq_wide": "dq_simt_kernel",
                "flash_bwd_dkv_wide": "dkv_simt_kernel"}
# bf16 tolerances of a pipelined step against the sequential oracle (or
# 1F1B against fill-drain): the same products in bf16 batched otherwise
# (the pipeline's micro-batches and pp-sharded head; the oracle's whole
# batch) round differently at 2^-8 relative, compounding over 2 blocks
# and the backward, as tests/test_torch_cuda_training.py's bf16 route
# derives: the loss to 2^-6 relative, each gradient leaf to 2^-4 of its
# max.  25c: the decode's tokens against the plain version's on the card
# by the teacher-forced check (TF_AGREE, TF_GAP), as phase 6's.
SPMD_LOSS_REL, SPMD_GRAD_REL = 2 ** -6, 2 ** -4
# 25e's 'never' and 'offload' steps: no recompute.
SPMD_NEVER_LAUNCHES = {k: SPMD_CHUNKS for k in SPMD_LAUNCHES}
# 25f: 'always' recomputes every cell (a forward each), and under
# remat_policy=policies.save_flash_stats no recompute launches the forward
# kernel, so the step launches what 'never' does.  The policy keeps each
# cell's O (bf16 [b/m, s, h, 256]) and LSE (f32 [b/m * h, s]) of the
# rank's one block.
SPMD_ALWAYS_LAUNCHES = dict(SPMD_LAUNCHES, flash_fwd_d256=2 * SPMD_CHUNKS)
SPMD_KEPT_BYTES = SPMD_CHUNKS * (SPMD_BATCH // SPMD_CHUNKS) * SPMD_SEQ * GEMMA_7B["n_heads"] * (
    256 * 2 + 4)


class _Stand:
    """What SpmdGPipe.init reads of a mesh, for the parent's oracle: the
    same draw as every rank's, without a process group."""

    def __init__(self, pp, dp, device):
        self.axis_names, self.shape = ("pp", "dp"), {"pp": pp, "dp": dp}
        self.coords, self.device = {"pp": 0, "dp": 0}, device


def spmd_engine(torch, tt, spmd, mesh, tied: bool, schedule: str, dp_axis,
                device: str = "cuda", **kw):
    """Phase 25's engine (and phase 27's: ``kw`` are more ``SpmdGPipe``
    arguments; ``virtual_stages=v`` gives 2v blocks); its layers on
    ``device`` ("meta" for an engine that draws no params: the trees hold
    every tensor it runs on)."""
    blocks = 2 * kw.get("virtual_stages", 1)
    cfg = tt.TransformerConfig(**dict(GEMMA_7B, tie_embeddings=tied, n_layers=blocks),
                               dtype=torch.bfloat16)
    block, pre, post = tt.llama_spmd(cfg, blocks, device=device)
    pipe = spmd.SpmdGPipe(block, 2, mesh, chunks=SPMD_CHUNKS, loss_fn=causal_lm_loss(tt),
                          pre=pre, post=post, schedule=schedule, dp_axis=dp_axis,
                          **dict(dict(checkpoint="except_last"), **kw))
    return cfg, pipe


def spmd_init(torch, pipe, seed: int):
    """The global params tree (the same on every rank: one generator) and
    the batch of the seed."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    params = pipe.init(gen, ((SPMD_BATCH, SPMD_SEQ), torch.int64))
    tokens = torch.from_numpy(np.random.default_rng(seed + 25).integers(
        0, GEMMA_7B["vocab"], (SPMD_BATCH, SPMD_SEQ)))
    return params, tokens


def spmd_free_templates(pipe):
    """The engine runs its layers on the parameter trees; the layers' own
    tensors are templates, freed once the trees exist."""
    for layer in (pipe.block, pipe.pre, pipe.post):
        layer.to("meta")


def spmd_rank_main(args) -> None:
    """One rank of phase 25 (case ``a``), 27 (case ``z``,
    :func:`zero_sched_rank`) or 28 (case ``e``, :func:`moe_ep_rank`),
    started by the parent as its own process
    over gloo on this card.  Case ``a``: pp=2, dp=1, fill-drain, tied;
    step 1 by ``train_step`` (its gathered gradients written for the
    parent's oracle), step 2 by ``make_train_step``; the gathered trained
    params written for 25c."""
    import torch
    import torch.distributed as dist

    from torchgpipe_tpu_torch import spmd
    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, out, case = args.spmd_rank, args.spmd_world, args.spmd_out, args.spmd_case
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.spmd_port}",
                            rank=rank, world_size=world)
    try:
        if case == "e":
            moe_ep_rank(torch, tfa, tt, spmd, spmd.make_mesh(2, 1, ep=2), args.seed, out)
            return
        dp = world // 2
        mesh = spmd.make_mesh(2, dp)
        if case == "z":
            zero_sched_rank(torch, tfa, tt, spmd, mesh, args.seed,
                            os.path.join(out, f"z_rank{rank}.json"))
            return
        report = {"rank": rank, "coords": mesh.coords, "device": str(mesh.device),
                  "step_ms": [], "staged_bytes": [], "peak_gib": [], "launches": []}
        _, pipe = spmd_engine(torch, tt, spmd, mesh, True, "fill_drain", None)
        params, tokens = spmd_init(torch, pipe, args.seed)
        params = pipe.place(params)
        spmd_free_templates(pipe)
        torch.cuda.empty_cache()
        report["ready_s"] = time.perf_counter() - t_start

        def timed(fn, profiled=False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launches()
            card = card_line() if profiled else None
            b0, t0 = mesh.staged_bytes, time.perf_counter()
            if profiled:   # which CUDA functions the step launched
                out = []
                rows = profile(torch, card, f"25{case} rank {rank}",
                               lambda: out.append(fn()), top=0, cuda_only=True)[2]
                res = out[0]
                report["profile"] = {k: sum(n for _, n, key in rows if name in key)
                                     for k, name in SPMD_PROFILE.items()}
            else:
                res = fn()
            torch.cuda.synchronize()
            report["step_ms"].append((time.perf_counter() - t0) * 1e3)
            report["staged_bytes"].append(mesh.staged_bytes - b0)
            report["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            report["launches"].append(kernel_launches(tfa))
            return res

        def flat(tree):
            return [a for k in ("pre", "blocks", "post") for _, a in spmd._items(tree[k])]

        loss, local = timed(lambda: pipe.train_step(params, tokens, tokens))
        report["losses"] = [loss.item()]
        grads = pipe.gather(local)   # for the parent's oracle
        # Step 1's SGD update from its gradients above, then step 2 whole
        # through make_train_step.
        with torch.no_grad():
            for t, gr in zip(flat(params), flat(local)):
                t.sub_(SPMD_LR * gr)
        del local
        step = pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=SPMD_LR))
        loss2 = timed(lambda: step(params, tokens, tokens), profiled=True)
        report["losses"].append(loss2.item())
        trained = pipe.gather(params)
        if rank == 0:
            torch.save(grads, os.path.join(out, "grads_a.pt"))
            torch.save(trained, os.path.join(out, "params_a.pt"))
        del trained, grads, step
        knobs_rank(torch, tfa, tt, spmd, mesh, pipe, params, tokens, args.seed, report, timed)
        with open(os.path.join(out, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def knobs_rank(torch, tfa, tt, spmd, mesh, pipe, params, tokens, seed, report, timed):
    """25d and 25e on one rank of phase 25's pp=2 world, from 25a's
    trained params (copies: 25c generates from the originals).  25d:
    ``make_train_step(megastep=2)`` (SGD with momentum, so there is
    optimizer state) over two stacked batches against StepGuard around two
    single steps, bitwise (losses, params, momentum); then a guarded step
    under ``faults.inject(nan_at=(1, 0))`` (stage 1's first cell
    poisoned): skipped, params and momentum bitwise as before.  25e: one
    ``checkpoint='offload'`` step against a ``'never'`` step: loss and
    every gradient bitwise, both peaks."""
    import functools

    import numpy as np

    from torchgpipe_tpu_torch.resilience import StepGuard, faults

    def clone(tree):
        return {k: spmd._tree_map(lambda a: a.detach().clone(), v) for k, v in tree.items()}

    def flat(tree):
        return [a for k in ("pre", "blocks", "post") for _, a in spmd._items(tree[k])]

    def state(step):
        return [v for st in step.optimizer.state.values() for v in st.values()
                if isinstance(v, torch.Tensor)]

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    t0 = time.perf_counter()
    sgd = functools.partial(torch.optim.SGD, lr=SPMD_LR, momentum=0.9)
    second = torch.from_numpy(np.random.default_rng(seed + 250).integers(
        0, GEMMA_7B["vocab"], tokens.shape))
    xs = torch.stack([tokens, second])
    pa, pb = clone(params), clone(params)
    mega = pipe.make_train_step(sgd, megastep=2)
    losses, finite = timed(lambda: mega(pa, xs, xs))
    single = pipe.make_train_step(sgd)
    guard = StepGuard(single)
    singles = torch.stack([timed(lambda k=k: guard(pb, xs[k], xs[k])) for k in range(2)])
    report["25d"] = {"bitwise": bool(torch.equal(losses, singles) and same(flat(pa), flat(pb))
                                     and same(state(mega), state(single))),
                     "finite": finite.tolist(), "losses": losses.tolist()}
    del pa
    before = [t.clone() for t in flat(pb) + state(single)]
    with faults.inject(nan_at=(1, 0)):
        bad = timed(lambda: guard(pb, tokens, tokens))
    report["25d"].update(
        poisoned_loss=bad.item(), skipped=guard.stats.skipped, steps=guard.stats.steps,
        skip_bitwise=bool(same(flat(pb) + state(single), before)))
    del pb, before, mega, single, guard
    gc.collect()
    torch.cuda.empty_cache()
    got = {}
    for mode in ("never", "offload"):
        _, e = spmd_engine(torch, tt, spmd, mesh, True, "fill_drain", None, "meta",
                           checkpoint=mode)
        loss, g = timed(lambda: e.train_step(params, tokens, tokens))
        got[mode] = (loss, flat(g))
        if mode == "offload":
            report["25e_offload_stats"] = dict(e.offload_stats)
    report["25e"] = {"bitwise": bool(torch.equal(got["never"][0], got["offload"][0])
                                     and same(got["never"][1], got["offload"][1])),
                     "loss": got["never"][0].item()}
    report["25de_s"] = time.perf_counter() - t0
    del got
    remat_rank(torch, tt, spmd, mesh, params, tokens, report, timed, flat, same)


def remat_rank(torch, tt, spmd, mesh, params, tokens, report, timed, flat, same):
    """25f on one rank of phase 25's world: ``checkpoint='always'`` with
    ``remat_policy=policies.save_flash_stats`` against the policy-free
    ``'always'`` step: loss and every gradient bitwise; launches (the
    policy's recomputes launch no forward kernel) and peaks beside."""
    from torchgpipe_tpu_torch.checkpoint import policies

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = {}
    for what, kw in (("always", {}),
                     ("save_flash_stats", dict(remat_policy=policies.save_flash_stats))):
        _, e = spmd_engine(torch, tt, spmd, mesh, True, "fill_drain", None, "meta",
                           checkpoint="always", **kw)
        loss, g = timed(lambda: e.train_step(params, tokens, tokens))
        got[what] = (loss, [t.cpu() for t in flat(g)])   # on the host: the peaks compare
        if kw:
            report["25f_kept_bytes"] = e.remat_stats["saved_bytes"]
        del e, g
        gc.collect()
        torch.cuda.empty_cache()
    report["25f"] = {"bitwise": bool(torch.equal(got["always"][0], got["save_flash_stats"][0])
                                     and same(got["always"][1], got["save_flash_stats"][1])),
                     "loss": got["always"][0].item(), "seconds": time.perf_counter() - t0}
    del got


def spmd_rel_diff(torch, got, want, chunk: int = 1 << 24) -> float:
    """max |got - want| / max |want| over a leaf, in float32 chunks of
    ``chunk`` elements (four ranks share the card: no leaf-sized float32
    temporaries)."""
    err = scale = 0.0
    for a, c in zip(got.reshape(-1).split(chunk), want.reshape(-1).split(chunk)):
        err = max(err, (a.float() - c.float()).abs().max().item())
        scale = max(scale, c.float().abs().max().item())
    return err / max(scale, 1e-30)


def spmd_ranks(torch, seed: int, case: str, world: int, out: str):
    """Run phase 25's case on ``world`` rank processes; their reports."""
    import socket
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for rank in range(world):
        log = open(os.path.join(out, f"{case}_rank{rank}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--spmd-rank", str(rank), "--spmd-world", str(world), "--spmd-port", str(port),
             "--spmd-case", case, "--spmd-out", out],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")), log))
    try:
        rcs = [p.wait(timeout=max(1.0, SPMD_DEADLINE_S - (time.perf_counter() - t0)))
               for p, _ in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if rcs != [0] * world:
        logs = ""
        for rank in range(world):
            with open(os.path.join(out, f"{case}_rank{rank}.log"), errors="replace") as f:
                logs += f"--- rank {rank}\n" + f.read()[-4000:]
            part = os.path.join(out, f"{case}_rank{rank}.json")
            if os.path.exists(part):   # what a rank reported before it failed
                with open(part) as f:
                    logs += f"--- rank {rank}'s report so far\n" + f.read()[-6000:] + "\n"
        fail(f"spmd 25{case}: rank exit codes {rcs} (None: killed after "
             f"{SPMD_DEADLINE_S}s)\n{logs}")
    reports = []
    for rank in range(world):
        with open(os.path.join(out, f"{case}_rank{rank}.json")) as f:
            reports.append(json.load(f))
    return reports, time.perf_counter() - t0


def spmd_oracle(torch, tfa, tt, spmd, seed: int, tied: bool = True, v: int = 1):
    """25a's single-process sequential oracle on the card: the same params
    and batch, pre, the 2v blocks in their global order (block ``g`` of
    an interleaved tree at ``[g % 2, g // 2]``), the head and the loss,
    one after another; its loss and gradients on the host."""
    sched, kw = ("interleaved", {"virtual_stages": v}) if v > 1 else ("fill_drain", {})
    _, pipe = spmd_engine(torch, tt, spmd, _Stand(2, 1, torch.device("cuda")), tied, sched,
                          None, **kw)
    params, tokens = spmd_init(torch, pipe, seed)
    spmd_free_templates(pipe)
    leaves = {k: spmd._tree_map(lambda a: a.detach().requires_grad_(), params[k])
              for k in ("pre", "blocks", "post")}
    x = tokens.cuda()
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = pipe._run_pre(leaves, x, True)
    for g in range(2 * v):
        h = spmd._call(pipe.block, pipe._names["blocks"], spmd._tree_map(
            lambda a: a[g % 2, g // 2] if v > 1 else a[g], leaves["blocks"]), h)
    loss = causal_lm_loss(tt)(pipe._run_post(leaves, h), x)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = {k: spmd._tree_map(lambda a: a.grad.detach().cpu(), leaves[k])
             for k in leaves}
    launches = kernel_launches(tfa)
    del leaves, params, h
    return loss.item(), grads, ms, launches


class plain_attention:
    """Within it, the model code calls the plain attention versions (the
    generation module's and the block's names), on the card too."""

    def __init__(self, tt, tg, tfa):
        self.mods, self.tfa = (tt, tg), tfa

    def __enter__(self):
        tfa = self.tfa
        self.saved = [(m, n, getattr(m, n)) for m in self.mods
                      for n in ("attention", "decode_attention") if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, (lambda q, k, v, **kw: tfa.flash_attention_reference(q, k, v, **kw))
                    if n == "attention" else
                    (lambda q, ck, cv, pos0, **kw: tfa.flash_decode_reference(
                        q, ck, cv, pos0, **kw)))

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def phase_spmd(torch, tfa, tt, tg, card, seed: int):
    """Phase 25: the SPMD engine at Gemma-7B width over gloo on this card.
    25a: the oracle here, then pp=2 fill-drain (tied) on 2 rank
    processes; 25c: spmd_params_for_generation of 25a's trained params,
    generate SPMD_NEW tokens on the wide decode, against the plain
    version's.  (25b runs in phase 27's world.)"""
    import tempfile

    import numpy as np

    from torchgpipe_tpu_torch import spmd

    t_phase = time.perf_counter()
    ref_loss, ref_grads, ref_ms, ref_launches = spmd_oracle(torch, tfa, tt, spmd, seed)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        ra, a_s = spmd_ranks(torch, seed, "a", 2, out)
        grads = torch.load(os.path.join(out, "grads_a.pt"))
        trained = torch.load(os.path.join(out, "params_a.pt"))
    loss_a = ra[0]["losses"][0]
    if abs(loss_a - ref_loss) > SPMD_LOSS_REL * abs(ref_loss):
        fail(f"spmd 25a: step-1 loss {loss_a} vs the sequential oracle's {ref_loss} "
             f"(rel tol {SPMD_LOSS_REL})")
    worst = {}
    for path, want in spmd._items(ref_grads):
        worst[str(path)] = spmd_rel_diff(torch, dict(spmd._items(grads))[path], want)
    bad = {k: v for k, v in worst.items() if v > SPMD_GRAD_REL}
    if bad or len(worst) != len(spmd._items(grads)):
        fail(f"spmd 25a: gradients against the oracle beyond {SPMD_GRAD_REL} of each "
             f"leaf's max: {bad}")
    for rep in ra:
        expect_launches(rep["launches"][0], SPMD_LAUNCHES, f"25a rank {rep['rank']} step 1")
        expect_launches(rep["launches"][1], SPMD_LAUNCHES, f"25a rank {rep['rank']} step 2")
        want = {k: SPMD_LAUNCHES.get(k, 0) for k in SPMD_PROFILE}
        if rep["profile"] != want:
            fail(f"spmd 25a rank {rep['rank']}: step 2's profile launched {rep['profile']} "
                 f"of {SPMD_PROFILE}, expected {want}")
    if not all(math.isfinite(x) for rep in ra for x in rep["losses"]):
        fail(f"spmd: non-finite losses {[rep['losses'] for rep in ra]}")
    # 25d and 25e: the timed steps after 25a's two (timed() appends each).
    for rep in ra:
        d, r = rep["25d"], rep["rank"]
        if not (d["bitwise"] and d["finite"] == [True, True]):
            fail(f"spmd 25d rank {r}: make_train_step(megastep=2) against two guarded "
                 f"steps: bitwise {d['bitwise']}, finite {d['finite']}")
        if not (d["skip_bitwise"] and d["skipped"] == 1 and d["steps"] == 2
                and not math.isfinite(d["poisoned_loss"])):
            fail(f"spmd 25d rank {r}: the poisoned guarded step: {d}")
        if not rep["25e"]["bitwise"]:
            fail(f"spmd 25e rank {r}: the 'offload' step is not bitwise the 'never' step")
        knob_launches = rep["launches"][2:]
        want = ([{k: 2 * v for k, v in SPMD_LAUNCHES.items()}]
                + [SPMD_LAUNCHES] * 3 + [SPMD_NEVER_LAUNCHES] * 2
                + [SPMD_ALWAYS_LAUNCHES, SPMD_NEVER_LAUNCHES])
        if len(knob_launches) != len(want):
            fail(f"spmd 25d-f rank {r}: {len(knob_launches)} timed calls, expected {len(want)}")
        for k, (got, w) in enumerate(zip(knob_launches, want)):
            expect_launches(got, w, f"25d-f rank {r}, timed call {k}")
        if not rep["25f"]["bitwise"]:
            fail(f"spmd 25f rank {r}: the save_flash_stats step is not bitwise the "
                 f"policy-free 'always' step")
        if rep["25f_kept_bytes"] != SPMD_KEPT_BYTES:
            fail(f"spmd 25f rank {r}: the policy kept {rep['25f_kept_bytes']} B, expected "
                 f"{SPMD_KEPT_BYTES} (O and LSE of {SPMD_CHUNKS} cells)")
    # 25c: generate from 25a's trained params on the card.
    cfg = tt.TransformerConfig(**GEMMA_7B, dtype=torch.bfloat16)
    _, pipe = spmd_engine(torch, tt, spmd, _Stand(2, 1, torch.device("cuda")), True,
                          "fill_drain", None, "meta")
    model = tg.spmd_params_for_generation(pipe, trained, device="cuda")
    del trained
    prompt = torch.from_numpy(np.random.default_rng(seed + 26).integers(
        0, cfg.vocab, (2, SPMD_PROMPT))).cuda()
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = tg.generate(cfg, model, prompt, SPMD_NEW)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = kernel_launches(tfa)
    expect_launches(gen_launches, {"flash_fwd_d256": 2, "flash_decode_d256": 2 * SPMD_NEW},
                    "25c generate")
    with plain_attention(tt, tg, tfa):
        plain = tg.generate(cfg, model, prompt, SPMD_NEW)
    if sum(kernel_launches(tfa).values()) != sum(gen_launches.values()):
        fail("spmd 25c: the plain generate launched a kernel")
    same = (toks == plain).float().mean().item()
    agree, gap = teacher_forced(torch, model, prompt, toks)
    if agree < TF_AGREE or gap > TF_GAP:
        fail(f"spmd 25c: generate vs teacher forcing: agreement {agree:.3f} (floor "
             f"{TF_AGREE}), worst gap {gap:.3f} (tol {TF_GAP})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    step = {f"a{r['rank']}": r["step_ms"][:2] for r in ra}
    staged = {f"a{r['rank']}": r["staged_bytes"][:2] for r in ra}
    peak = {f"a{r['rank']}": r["peak_gib"][:2] for r in ra}
    print(f"spmd 25a: Gemma-7B width (dim 3072, 16 heads of 256, ffn 24576, vocab 256000, "
          f"tied, gelu_tanh), bf16, 2 blocks; batch {SPMD_BATCH} x seq {SPMD_SEQ}, chunks "
          f"{SPMD_CHUNKS}, except_last, fill-drain, pp=2 over gloo (2 processes on this "
          f"card): step-1 loss {loss_a:.6f} vs the sequential oracle's {ref_loss:.6f}; "
          f"{len(worst)} gradient leaves, worst {max(worst.values()):.3e} of its max (tol "
          f"{SPMD_GRAD_REL}); step 2 loss {ra[0]['losses'][1]:.6f}; launches a rank "
          f"{[r['launches'][0] for r in ra]} (oracle, both blocks: {ref_launches}); step 2's "
          f"profile a rank {[r['profile'] for r in ra]} [{card}]",
          flush=True)
    print(f"spmd 25c: generate 2 x {SPMD_PROMPT} + {SPMD_NEW} from 25a's trained params "
          f"(spmd_params_for_generation): {gen_ms:.1f} ms, launches {gen_launches}; tokens "
          f"equal to the plain version's {same:.3f}; teacher_forced_agree {agree:.4f} "
          f"max_gap {gap:.4f} [{card}]", flush=True)
    d0 = ra[0]["25d"]
    print(f"spmd 25d: make_train_step(megastep=2) (SGD momentum 0.9) bitwise two StepGuard "
          f"steps on every rank, losses {d0['losses']}; a step under faults.inject(nan_at="
          f"(1, 0)) gave loss {d0['poisoned_loss']} and was skipped with params and momentum "
          f"bitwise; 25e: checkpoint='offload' bitwise 'never' on every rank, offload stats "
          f"by rank {[r['25e_offload_stats'] for r in ra]}; step ms by rank (megastep, 2 "
          f"guarded, poisoned, never, offload) {[r['step_ms'][2:] for r in ra]}, peak GiB "
          f"{[r['peak_gib'][2:8] for r in ra]}; 25d-e took "
          f"{[round(r['25de_s'], 1) for r in ra]} s [{card}]", flush=True)
    print(f"spmd 25f: checkpoint='always' with remat_policy=policies.save_flash_stats bitwise "
          f"the policy-free 'always' step on every rank (loss {ra[0]['25f']['loss']:.6f}); "
          f"launches a rank {ra[0]['launches'][8]} policy-free vs {ra[0]['launches'][9]} "
          f"kept ({ra[0]['25f_kept_bytes']} B of O and LSE a rank); step ms by rank "
          f"{[r['step_ms'][8:] for r in ra]}, peak GiB {[r['peak_gib'][8:] for r in ra]}; "
          f"25f took {[round(r['25f']['seconds'], 1) for r in ra]} s [{card}]", flush=True)
    print(f"spmd: step_ms by rank {step}; bytes staged through the host a step {staged}; "
          f"peak GiB {peak}; the oracle's step {ref_ms:.1f} ms; ranks ran 25a in "
          f"{a_s:.1f}s, started in {max(r['ready_s'] for r in ra):.1f}s; the phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    result = {"card": card, "loss_a": loss_a, "oracle_loss": ref_loss,
              "grad_worst_rel": max(worst.values()), "losses_a": ra[0]["losses"],
              "launches": {f"a{r['rank']}": r["launches"] for r in ra},
              "launches_a_rank": ra[0]["launches"][0], "generate_launches": gen_launches,
              "generate_ms": gen_ms, "tokens_equal_plain": same,
              "teacher_forced_agree": agree, "max_gap": gap, "step_ms": step,
              "staged_bytes": staged, "peak_gib": peak, "oracle_ms": ref_ms,
              "ranks_s": {"a": a_s},
              "knobs": {f"a{r['rank']}": {"25d": r["25d"], "25e": r["25e"],
                                          "offload_stats": r["25e_offload_stats"],
                                          "seconds": r["25de_s"]} for r in ra},
              "remat": {f"a{r['rank']}": {"25f": r["25f"], "kept_bytes": r["25f_kept_bytes"],
                                          "launches": r["launches"][8:],
                                          "step_ms": r["step_ms"][8:],
                                          "peak_gib": r["peak_gib"][8:]} for r in ra}}
    print(json.dumps({"spmd": result}), flush=True)
    return result


# --------------------------------------------------------------------- #
# phase 26: tensor and sequence parallelism in the SPMD engine           #
# --------------------------------------------------------------------- #

# Llama-3-8B's published widths (LLAMA3_8B: dim 4096, 32 query and 8 kv
# heads of 128, ffn 14336, vocab 128256, untied) in bf16, cut to 2 of its
# 32 blocks, one a stage; batch 2 x seq 4096 in 2 micro-batches,
# 'except_last', fill-drain, one SGD step at TRAIN_LR.  One world of 4
# rank processes over gloo on this card runs the three cases, one
# make_mesh each: 26a pp=2 x tp=2 (vocab-sharded logits through
# vocab_parallel_cross_entropy), 26b pp=2 x sp=2 on the ring, 26c the same
# mesh on Ulysses.  The ranks share one card, so the phase proves the
# engine and the kernels and measures host staging, not multi-card
# scaling.
TP_SP_CFG = dict(LLAMA3_8B, n_layers=2)
TP_SP_BATCH, TP_SP_SEQ, TP_SP_CHUNKS = 2, 4096, 2
TP_SP_CASES = {"a": dict(sp=1, tp=2, impl="ring"), "b": dict(sp=2, tp=1, impl="ring"),
               "c": dict(sp=2, tp=1, impl="ulysses")}
TP_SP_WORLD = 4
TP_SP_DEADLINE_S = 420
# A rank's launches in a step: its one block at 2 micro-batches under
# 'except_last' is two forwards and one recompute, two backwards: at the
# tp lanes' 16 q / 4 kv heads (26a) and on Ulysses' 16 / 4 heads over the
# whole sequence (26c).
TP_SP_LAUNCHES = {"flash_fwd": TP_SP_CHUNKS + TP_SP_CHUNKS - 1,
                  "flash_bwd_dq": TP_SP_CHUNKS, "flash_bwd_dkv": TP_SP_CHUNKS}


def ring_launches(r: int) -> dict:
    """26b on sp lane ``r``: each attention call runs the blocks of lanes
    0..r (its own causal, the earlier ones whole, the later one skipped),
    one tile each at 2048 positions (kv_block_size 2048), so 3 (r + 1)
    forwards and 2 (r + 1) of each backward."""
    return {k: v * (r + 1) for k, v in TP_SP_LAUNCHES.items()}


def tp_sp_cfg(tt, torch, case):
    c = TP_SP_CASES[case]
    return tt.TransformerConfig(**TP_SP_CFG, dtype=torch.bfloat16,
                                tp_axis="tp" if c["tp"] > 1 else None,
                                sp_axis="sp" if c["sp"] > 1 else None, sp_impl=c["impl"])


def tp_sp_engine(torch, tt, spmd, mesh, case, device):
    """Phase 26's engine of ``case``; its layers on ``device`` ("meta":
    an engine that runs on the trees alone)."""
    cfg = tp_sp_cfg(tt, torch, case)
    block, pre, post = tt.llama_spmd(cfg, 2, device=device,
                                     gather_logits=cfg.tp_axis is None)
    loss = tt.cross_entropy if cfg.tp_axis is None else \
        tt.vocab_parallel_cross_entropy(cfg.tp_axis)
    return spmd.SpmdGPipe(block, 2, mesh, chunks=TP_SP_CHUNKS, loss_fn=loss, pre=pre,
                          post=post, checkpoint="except_last", tp_axis=cfg.tp_axis,
                          sp_axis=cfg.sp_axis)


def tp_sp_batch(torch, seed: int):
    """Tokens of the seed and their next tokens as the aligned labels
    (pre-shifted: a loss that shifts inside would cut across the sp
    shards)."""
    import numpy as np

    tokens = torch.from_numpy(np.random.default_rng(seed + 26).integers(
        0, TP_SP_CFG["vocab"], (TP_SP_BATCH, TP_SP_SEQ)))
    return tokens, torch.roll(tokens, -1, 1)


def tp_sp_init(torch, pipe, seed: int):
    """The global params tree of the seed (one generator on the card, the
    same on every rank and in the oracle), on the card (3.2 GB: each
    case's ``place`` slices it there)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 26)
    tree = pipe.init(gen, ((TP_SP_BATCH, TP_SP_SEQ), torch.int64))
    spmd_free_templates(pipe)
    torch.cuda.empty_cache()
    return tree


def fingerprint(torch, tree) -> list:
    """Per leaf: the float64 sum and sum of squares (on the card)."""
    from torchgpipe_tpu_torch import spmd

    out = []
    for _, a in spmd._items(tree):
        d = a.cuda().double()
        out.append([d.sum().item(), (d * d).sum().item()])
    return out


def tp_sp_rank_main(args) -> None:
    """One rank of phase 26 (started by the parent over gloo on this
    card): cases a, b and c in turn, each on its own mesh of the one
    process group; per case a timed ``train_step``, each gradient leaf
    against the oracle's (its shard), an SGD step and ``eval_loss``."""
    import torch
    import torch.distributed as dist

    from torchgpipe_tpu_torch import spmd
    from torchgpipe_tpu_torch.models import transformer as tt
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, out = args.tpsp_rank, args.tpsp_out
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.tpsp_port}",
                            rank=rank, world_size=TP_SP_WORLD)
    try:
        oracle = torch.load(os.path.join(out, "oracle.pt"), mmap=True)
        tokens, labels = tp_sp_batch(torch, args.seed)
        report = {"rank": rank, "cases": {}}
        tree = None
        for case, c in TP_SP_CASES.items():
            t_case = time.perf_counter()
            mesh = spmd.make_mesh(2, 1, c["sp"], tp=c["tp"])
            pipe = tp_sp_engine(torch, tt, spmd, mesh, case,
                                "cuda" if tree is None else "meta")
            if tree is None:
                tree = tp_sp_init(torch, pipe, args.seed)
                report["ready_s"] = time.perf_counter() - t_start
                report["fingerprint_equal"] = fingerprint(torch, tree) == oracle["fingerprint"]
            params = pipe.place(tree)
            rep = {"coords": mesh.coords}
            if case == "a":
                back = pipe.gather(params)
                if rank == 0:
                    rep["gather_bitwise"] = all(
                        torch.equal(x, y.cpu()) for (_, x), (_, y) in
                        zip(spmd._items(back), spmd._items(tree)))
                del back
            if case == list(TP_SP_CASES)[-1]:
                tree = None      # the last case's placement holds what it needs
                torch.cuda.empty_cache()
            rep["setup_s"] = time.perf_counter() - t_case
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launches()
            b0, by0 = mesh.staged_bytes, dict(mesh.staged_by)
            t0 = time.perf_counter()
            loss, grads = pipe.train_step(params, tokens, labels)
            torch.cuda.synchronize()
            rep["step_ms"] = (time.perf_counter() - t0) * 1e3
            rep["launches"] = kernel_launches(tfa)
            rep["staged_bytes"] = mesh.staged_bytes - b0
            rep["staged_by"] = {k: v - by0.get(k, 0) for k, v in mesh.staged_by.items()}
            rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rep["loss"] = loss.item()
            t_check = time.perf_counter()
            # Each leaf of this rank's gradients against its shard of the
            # oracle's (the parent divides by the whole leaf's max).
            errs = {}
            for key in ("pre", "blocks", "post"):
                specs = spmd.broadcast_specs(pipe._specs[key], grads[key])
                for (path, g), (_, spec) in zip(spmd._items(grads[key]), spmd._items(specs)):
                    want = pipe._shard(dict(spmd._items(oracle["grads"][key]))[path], spec)
                    errs[str((key,) + path)] = max(
                        (a.float() - b.float()).abs().max().item()
                        for a, b in zip(g.reshape(-1).split(1 << 24),
                                        want.reshape(-1).split(1 << 24)))
                    del want
            rep["grad_err"] = errs
            with torch.no_grad():
                for key in ("pre", "blocks", "post"):
                    for (_, t), (_, g) in zip(spmd._items(params[key]),
                                              spmd._items(grads[key])):
                        t.sub_(TRAIN_LR * g)
            del grads
            rep["check_s"] = time.perf_counter() - t_check
            t_eval = time.perf_counter()
            rep["loss_after"] = pipe.eval_loss(params, tokens, labels).item()
            rep["eval_s"] = time.perf_counter() - t_eval
            report["cases"][case] = rep
            del params, pipe
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def tp_sp_oracle(torch, tfa, tt, seed: int, out: str):
    """Phase 26's sequential oracle on the card: the unsharded model at
    the same weights and batch, pre, both blocks and the head in turn,
    ``cross_entropy``; its loss and time, its gradients (with each leaf's
    max) and the params' fingerprint saved for the ranks."""
    from torchgpipe_tpu_torch import spmd

    class Stand:
        axis_names, shape = ("pp", "dp"), {"pp": 2, "dp": 1}
        coords, device = {"pp": 0, "dp": 0}, torch.device("cuda")

    cfg = tt.TransformerConfig(**TP_SP_CFG, dtype=torch.bfloat16)
    block, pre, post = tt.llama_spmd(cfg, 2, device="cuda")
    pipe = spmd.SpmdGPipe(block, 2, Stand(), chunks=TP_SP_CHUNKS, loss_fn=tt.cross_entropy,
                          pre=pre, post=post)
    tree = tp_sp_init(torch, pipe, seed)
    tokens, labels = (t.cuda() for t in tp_sp_batch(torch, seed))
    leaves = {k: spmd._tree_map(lambda a: a.detach().requires_grad_(), tree[k])
              for k in ("pre", "blocks", "post")}
    tfa.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = pipe._run_pre(leaves, tokens, True)
    for j in range(2):
        h = spmd._call(pipe.block, pipe._names["blocks"],
                       spmd._tree_map(lambda a: a[j], leaves["blocks"]), h)
    loss = tt.cross_entropy(pipe._run_post(leaves, h), labels)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = kernel_launches(tfa)
    del h
    grads = {k: spmd._tree_map(lambda a: a.grad.detach().cpu(), leaves[k]) for k in leaves}
    scale = {str((k,) + p): _leaf_max(torch, a.grad)
             for k in leaves for p, a in spmd._items(leaves[k])}
    torch.save({"grads": grads, "fingerprint": fingerprint(torch, tree)},
               os.path.join(out, "oracle.pt"))
    del leaves, grads, tree
    gc.collect()
    torch.cuda.empty_cache()
    return loss.item(), scale, ms, peak, launches


def _leaf_max(torch, g) -> float:
    return max(c.float().abs().max().item() for c in g.reshape(-1).split(1 << 24))


def tp_sp_ranks(torch, seed: int, out: str):
    """Phase 26's four rank processes; their reports and the seconds."""
    import socket
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for rank in range(TP_SP_WORLD):
        log = open(os.path.join(out, f"rank{rank}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--tpsp-rank", str(rank), "--tpsp-port", str(port), "--tpsp-out", out],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")), log))
    try:
        rcs = [p.wait(timeout=max(1.0, TP_SP_DEADLINE_S - (time.perf_counter() - t0)))
               for p, _ in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if rcs != [0] * TP_SP_WORLD:
        logs = ""
        for rank in range(TP_SP_WORLD):
            with open(os.path.join(out, f"rank{rank}.log"), errors="replace") as f:
                logs += f"--- rank {rank}\n" + f.read()[-4000:]
        fail(f"spmd_tp_sp: rank exit codes {rcs} (None: killed after "
             f"{TP_SP_DEADLINE_S}s)\n{logs}")
    reports = []
    for rank in range(TP_SP_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    return reports, time.perf_counter() - t0


def phase_tp_sp(torch, tfa, tt, card, seed: int):
    """Phase 26: tensor and sequence parallelism at Llama-3-8B width over
    gloo on this card (26a pp=2 x tp=2, 26b pp=2 x sp=2 ring, 26c the same
    on Ulysses) against one sequential oracle here."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ref_loss, scale, ref_ms, ref_peak, ref_launches = tp_sp_oracle(torch, tfa, tt, seed,
                                                                       out)
        reps, ranks_s = tp_sp_ranks(torch, seed, out)
    if not all(r["fingerprint_equal"] for r in reps):
        fail("spmd_tp_sp: a rank drew other params than the oracle's")
    if not reps[0]["cases"]["a"].get("gather_bitwise"):
        fail("spmd_tp_sp 26a: gather of the tp placement is not bitwise the global tree")
    res = {}
    for case in TP_SP_CASES:
        rows = [r["cases"][case] for r in reps]
        loss = rows[0]["loss"]
        if any(abs(r["loss"] - ref_loss) > SPMD_LOSS_REL * abs(ref_loss) for r in rows):
            fail(f"spmd_tp_sp 26{case}: losses {[r['loss'] for r in rows]} vs the "
                 f"oracle's {ref_loss} (rel tol {SPMD_LOSS_REL})")
        worst = {}
        for r in rows:
            for k, e in r["grad_err"].items():
                worst[k] = max(worst.get(k, 0.0), e / max(scale[k], 1e-30))
        bad = {k: v for k, v in worst.items() if v > SPMD_GRAD_REL}
        if bad or set(worst) != set(scale):
            fail(f"spmd_tp_sp 26{case}: gradients against the oracle beyond "
                 f"{SPMD_GRAD_REL} of each leaf's max: {bad}")
        for r, rep in zip(rows, reps):
            want = ring_launches(r["coords"]["sp"]) if case == "b" else TP_SP_LAUNCHES
            expect_launches(r["launches"], want, f"26{case} rank {rep['rank']}")
        after = [r["loss_after"] for r in rows]
        if not all(math.isfinite(x) and x < loss for x in after):
            fail(f"spmd_tp_sp 26{case}: eval_loss after the SGD step {after} "
                 f"vs {loss} before")
        res[case] = {"loss": loss, "loss_after_step": after[0],
                     "grad_worst_rel": max(worst.values()), "leaves": len(worst),
                     "step_ms": [r["step_ms"] for r in rows],
                     "staged_bytes": [r["staged_bytes"] for r in rows],
                     "staged_by": [r["staged_by"] for r in rows],
                     "peak_gib": [r["peak_gib"] for r in rows],
                     "launches": [r["launches"] for r in rows],
                     "seconds": {k: max(r[k] for r in rows)
                                 for k in ("setup_s", "check_s", "eval_s")}}
    if abs(res["b"]["loss"] - res["c"]["loss"]) > SPMD_LOSS_REL * abs(res["b"]["loss"]):
        fail(f"spmd_tp_sp: ring loss {res['b']['loss']} vs Ulysses {res['c']['loss']}")
    names = {"a": "pp=2 x tp=2, vocab-sharded logits + vocab_parallel_cross_entropy",
             "b": "pp=2 x sp=2, ring", "c": "pp=2 x sp=2, Ulysses"}
    for case, row in res.items():
        print(f"spmd_tp_sp 26{case}: Llama-3-8B width (dim 4096, 32/8 heads of 128, ffn "
              f"14336, vocab 128256), bf16, 2 blocks; batch {TP_SP_BATCH} x seq "
              f"{TP_SP_SEQ}, chunks {TP_SP_CHUNKS}, except_last, fill-drain; {names[case]} "
              f"over gloo (4 processes on this card: host staging, not multi-card "
              f"scaling): loss {row['loss']:.6f} vs the oracle's {ref_loss:.6f}, "
              f"{row['leaves']} gradient leaves, worst {row['grad_worst_rel']:.3e} of its "
              f"max (tol {SPMD_GRAD_REL}); eval_loss after one SGD step "
              f"{row['loss_after_step']:.6f}; step_ms by rank {row['step_ms']}; bytes "
              f"staged through the host a step by rank {row['staged_bytes']}, by kind "
              f"{row['staged_by']}; peak GiB {row['peak_gib']}; launches by rank "
              f"{row['launches']}; slowest rank's seconds beside the step {row['seconds']} "
              f"[{card}]", flush=True)
    print(f"spmd_tp_sp: the oracle's step {ref_ms:.1f} ms, peak {ref_peak:.2f} GiB, "
          f"launches {ref_launches}; ranks ran in {ranks_s:.1f}s (started in "
          f"{max(r['ready_s'] for r in reps):.1f}s); the phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    result = {"card": card, "oracle_loss": ref_loss, "oracle_ms": ref_ms,
              "oracle_peak_gib": ref_peak, "cases": res, "ranks_s": ranks_s,
              "launches_tp": res["a"]["launches"][0], "launches_ring": res["b"]["launches"],
              "launches_ulysses": res["c"]["launches"][0]}
    print(json.dumps({"spmd_tp_sp": result}), flush=True)
    return result


# --------------------------------------------------------------------- #
# phase 27: ZeRO/FSDP and the interleaved and zero-bubble schedules      #
# --------------------------------------------------------------------- #

# Phase 25's model (GEMMA_7B in bf16, batch SPMD_BATCH x SPMD_SEQ in
# SPMD_CHUNKS micro-batches, 'except_last' where a schedule takes it) in
# one world of four rank processes, pp=2 x dp=2 over gloo on this card.
# AdamW at a rate whose first update (about lr a weight) is ~8 bf16 ulps
# of a dim^-1/2 weight (2^-13 = 1.2e-4 at 0.0156), so every leaf moves
# and a bitwise comparison of two updates means something.
ZS_LR = 1e-3
ZS_V = 2
# A rank's launches in a step (its one block, or its ZS_V chunks, at C =
# SPMD_CHUNKS micro-batches; every attention on the d=256 tensor-core
# kernels, none on flash_simt.cu):
# - fill-drain and 1F1B under 'except_last' (25b, 27a, 27b): C forwards
#   and C - 1 recomputes, C dQ and C dK/dV (SPMD_LAUNCHES);
# - zb 'never' (27d): C forwards; a micro-batch's B cell (its input's
#   gradient) and then its W cell (the weights', from the same graph) each
#   pass through attention's backward: 2C dQ and 2C dK/dV;
# - zb 'always': as 'never', plus each micro-batch's one recompute, in B:
#   2C forwards;
# - interleaved (27c, 'except_last': the cells of micro-batch C - 1 keep
#   their graphs): ZS_V chunks of C forwards and C - 1 recomputes, ZS_V * C
#   dQ and dK/dV;
# - the 4-block sequential oracle (27c, no checkpoint): 4 of each.
_C = SPMD_CHUNKS
ZS_LAUNCHES = {
    "fill_drain": SPMD_LAUNCHES, "1f1b": SPMD_LAUNCHES,
    "zb_never": {"flash_fwd_d256": _C, "flash_bwd_dq_d256": 2 * _C,
                 "flash_bwd_dkv_d256": 2 * _C},
    "zb_always": {"flash_fwd_d256": 2 * _C, "flash_bwd_dq_d256": 2 * _C,
                  "flash_bwd_dkv_d256": 2 * _C},
    "interleaved": {"flash_fwd_d256": ZS_V * (2 * _C - 1), "flash_bwd_dq_d256": ZS_V * _C,
                    "flash_bwd_dkv_d256": ZS_V * _C},
    "zero3": SPMD_LAUNCHES, "zero1": SPMD_LAUNCHES,
    # phase 29: 27a's step again, the reference and the resumed one
    "ckpt_step2": SPMD_LAUNCHES, "ckpt_resumed": SPMD_LAUNCHES,
}
# Phase 29: the disk must hold the snapshot this many times over (its
# temp directory is renamed into place, not copied).
CKPT_FREE_FACTOR = 1.5
ZS_ORACLE_LAUNCHES = {k: 2 * ZS_V for k in SPMD_LAUNCHES}
# At dp=2 ZeRO-3 stores half of each chosen block leaf and ZeRO-1 half of
# each leaf's state (each segment padded to a multiple of dp).
ZS_MEMORY_MAX = 0.55


@contextlib.contextmanager
def cell_clock(torch, pipe, events, fwd_keys, bwd_keys):
    """Within it, every cell of ``pipe``'s steps is timed on the card
    (synchronized before and after): ``(name, stage, micro-batch, start,
    end)`` into ``events``; the k-th forward cell is ``fwd_keys[k]``
    (``(stage, micro-batch)``; a global block for an interleaved pipe),
    the k-th backward ``bwd_keys[k]``."""
    def clocked(fn, name, keys):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            stage, mb = keys[sum(e[0] == name for e in events)]
            events.append((name, stage, mb, t0, time.perf_counter()))
            return out
        return run

    pipe._cell_forward = clocked(pipe._cell_forward, "fwd", fwd_keys)
    pipe._cell_backward = clocked(pipe._cell_backward, "bwd", bwd_keys)
    try:
        yield
    finally:
        del pipe._cell_forward, pipe._cell_backward


def fsdp_lane(spmd, pipe, tree):
    """This dp lane's fsdp storage shards of a tree of full block tensors
    (views; pre and post as they are)."""
    dp, d = pipe._dp, pipe._lane
    return dict(tree, blocks=spmd._tree_map(
        lambda a, dim: a if dim < 0 else a.narrow(dim, d * (a.shape[dim] // dp),
                                                  a.shape[dim] // dp),
        tree["blocks"], pipe._fsdp_dims))


def zero_sched_rank(torch, tfa, tt, spmd, mesh, seed: int, path: str) -> None:
    """Phase 27 on one rank of the pp=2 x dp=2 world, its report written
    to ``path`` as each part ends: each case's step ms, bytes staged by
    kind, peak and launches, the comparisons, block and optimizer bytes at
    each ZeRO level, and the cells of a 1F1B and an interleaved step timed
    one by one."""
    import torch.distributed as dist

    from torchgpipe_tpu_torch.parallel.interleaved import BWD, FWD, interleaved_tables

    t_start = time.perf_counter()
    rank, stage, m = mesh.rank, mesh.coords["pp"], SPMD_CHUNKS
    card = card_line()
    rep = {"rank": rank, "coords": mesh.coords, "cases": {}, "cmp": {}, "memory": {}}

    def adamw(ts):
        return torch.optim.AdamW(ts, lr=ZS_LR)

    def case(name, fn, profiled=False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tfa.reset_launches()
        by0, t0 = dict(mesh.staged_by), time.perf_counter()
        if profiled:   # which CUDA functions the step launched
            box = []
            rows = profile(torch, card, f"27 {name} rank {rank}", lambda: box.append(fn()),
                           top=0, cuda_only=True)[2]
            res = box[0]
            rep["profile"] = {k: sum(n for _, n, key in rows if pat in key)
                              for k, pat in SPMD_PROFILE.items()}
        else:
            res = fn()
        torch.cuda.synchronize()
        loss = res[0] if isinstance(res, tuple) else res
        rep["cases"][name] = {
            "ms": (time.perf_counter() - t0) * 1e3, "loss": loss.item(),
            "staged": {k: v - by0.get(k, 0) for k, v in mesh.staged_by.items()
                       if v != by0.get(k, 0)},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": kernel_launches(tfa), "profiled": profiled}
        return res

    def leaves(tree, key=None):
        return [a for k in ("pre", "blocks", "post") if key in (None, k)
                for _, a in spmd._items(tree[k])]

    def worst(got, want):
        return max(spmd_rel_diff(torch, a, b) for a, b in zip(leaves(got), leaves(want)))

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def memory(params, grads, opt, name, peak_of):
        """Block params, grads and optimizer state, all state, and the
        peak of case ``peak_of``."""
        pre = len(leaves(params, "pre"))
        blocks = range(pre, pre + len(leaves(params, "blocks")))

        def state(idx):
            return nbytes(v for i in idx for v in opt.state.get(opt.zero_segments[i], {})
                          .values() if isinstance(v, torch.Tensor) and v.ndim)

        rep["memory"][name] = {
            "block_param": nbytes(leaves(params, "blocks")),
            "block_grad": nbytes(leaves(grads, "blocks")), "block_state": state(blocks),
            "state": state(range(len(opt.zero_segments))),
            "peak_gib": rep["cases"][peak_of]["peak_gib"]}

    def cmp(name, got, want, loss_got, loss_want):
        rep["cmp"][name] = {"loss": [loss_got, loss_want], "worst": worst(got, want),
                            "bitwise": same(got, want) and loss_got == loss_want}

    def save():
        rep["s"] = time.perf_counter() - t_start
        rep.setdefault("parts_s", []).append(round(rep["s"], 1))   # at each part's end
        with open(path, "w") as f:
            json.dump(rep, f)

    def fresh(tied, schedule, copies=1, stagger=False, **kw):
        """A part's engine, ``copies`` placements of its params and its
        batch: the global tree drawn (the engine's layer templates freed
        after) once every rank has freed the last part's memory, with
        ``stagger`` the dp lanes in turn (four ranks share the card)."""
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        for turn in range(mesh.shape["dp"] if stagger else 1):
            if not stagger or mesh.coords["dp"] == turn:
                _, pipe = spmd_engine(torch, tt, spmd, mesh, tied, schedule, "dp", **kw)
                params, tokens = spmd_init(torch, pipe, seed)
                spmd_free_templates(pipe)
                placed = [pipe.place(params) for _ in range(copies)]
                del params
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        return pipe, placed, tokens

    def stash(pipe):
        """The results of ``pipe``'s train_steps from here on, as the
        ``make_train_step`` that calls them got them (until ``del
        pipe.train_step``): what a sharded update consumed, for its
        unsharded oracle."""
        box, run = [], pipe.train_step

        def keep(*a, **k):
            box.append(run(*a, **k))
            return box[-1]

        pipe.train_step = keep
        return box

    # 25b and 27d: untied, 2 blocks; fill-drain, 1F1B and zb at one set of
    # weights (the 1F1B step's cells timed one by one).
    fd, (local,), tokens = fresh(False, "fill_drain")
    rep["ready_s"] = time.perf_counter() - t_start
    loss_fd, g_fd = case("fill_drain", lambda: fd.train_step(local, tokens, tokens))
    e1 = spmd_engine(torch, tt, spmd, mesh, False, "1f1b", "dp", "meta")[1]
    events = []   # the world's second step: its cells warm
    with cell_clock(torch, e1, events, [(stage, i) for i in range(m)],
                    [(stage, i) for i in range(m)]):
        loss_1f, g_1f = case("1f1b", lambda: e1.train_step(local, tokens, tokens))
    rep["cells_1f1b"] = events
    cmp("1f1b_vs_fill_drain", g_1f, g_fd, loss_1f.item(), loss_fd.item())
    del g_fd
    for ckpt in ("never", "always"):
        ez = spmd_engine(torch, tt, spmd, mesh, False, "zb", "dp", "meta", checkpoint=ckpt)[1]
        loss_z, g = case(f"zb_{ckpt}", lambda: ez.train_step(local, tokens, tokens),
                         profiled=ckpt == "never" and rank == 0)
        cmp(f"zb_{ckpt}", g, g_1f, loss_z.item(), loss_1f.item())
        del g
    del g_1f, local
    save()

    # 27a: tied, fsdp; make_train_step(zero=3) against one AdamW over the
    # full tensors fed the step's own gradients, both gathered over dp.
    fp, (z3,), tokens = fresh(True, "fill_drain", fsdp=True)
    full = {k: spmd._tree_map(lambda a: a.detach().clone(),
                              fp._gather_fsdp(z3[k]) if k == "blocks" else z3[k])
            for k in ("pre", "blocks", "post")}
    step3 = fp.make_train_step(adamw, zero=3)
    box = stash(fp)
    case("zero3", lambda: step3(z3, tokens, tokens))
    del fp.train_step
    loss3, g3 = box.pop()
    gfull = dict(g3, blocks=fp._gather_fsdp(g3["blocks"]))
    opt = adamw(leaves(full))
    for t, g in zip(leaves(full), leaves(gfull)):
        t.grad = g
    opt.step()
    del opt, gfull
    cmp("zero3", z3, fsdp_lane(spmd, fp, full), loss3.item(), loss3.item())
    memory(z3, g3, step3.optimizer, "zero3", "zero3")
    del full
    # Phase 29 from 27a's state after its step.
    ckpt_rank(torch, tt, spmd, mesh, fp, z3, step3, adamw, seed, case, rep,
              os.path.join(os.path.dirname(path), "ckpt29"))
    del step3, z3
    save()

    # 27b: make_train_step(zero=1) against the zero=0 update of the same
    # gradients from the same weights; 27a's fsdp gradients against them.
    pn, (p1, p0), _ = fresh(True, "fill_drain", copies=2)
    p0 = spmd._tree_map(lambda a: a.cpu(), p0)
    step1 = pn.make_train_step(adamw, zero=1)
    box = stash(pn)
    case("zero1", lambda: step1(p1, tokens, tokens))
    del pn.train_step
    loss_n, gn = box.pop()
    cmp("fsdp_vs_plain", g3, fsdp_lane(spmd, fp, gn), loss3.item(), loss_n.item())
    del g3
    p0 = pn.place_tree(p0)
    opt0 = pn.zero_opt_state(adamw, p0, zero=0)
    pn._zero_apply(opt0, leaves(gn))
    cmp("zero1", p1, p0, loss_n.item(), loss_n.item())
    memory(p0, gn, opt0, "zero0", "zero1")
    memory(p1, gn, step1.optimizer, "zero1", "zero1")
    del opt0, step1, p0, p1, gn
    save()

    # 27c: interleaved, 4 blocks (2 a rank), untied, fsdp; its cells timed.
    il, (pi,), tokens = fresh(False, "interleaved", stagger=True, fsdp=True,
                              virtual_stages=ZS_V)
    tb = interleaved_tables(2, m, ZS_V)
    col = [(int(tb.kind[t, stage]), int(tb.chunk[t, stage]), int(tb.mb[t, stage]))
           for t in range(tb.ticks)]
    events = []
    with cell_clock(torch, il, events, [(c * 2 + stage, i) for k, c, i in col if k == FWD],
                    [(c * 2 + stage, i) for k, c, i in col if k == BWD]):
        loss_i, gi = case("interleaved", lambda: il.train_step(pi, tokens, tokens))
    rep["cells_interleaved"] = events
    del pi
    g_glob = il.gather(gi)
    del gi
    if rank == 0:   # phase 25's sequential oracle at 4 blocks
        gc.collect()
        torch.cuda.empty_cache()
        ref_loss, ref_grads, ref_ms, ref_launches = spmd_oracle(
            torch, tfa, tt, spmd, seed, tied=False, v=ZS_V)
        got = dict(spmd._items(g_glob))
        w = [spmd_rel_diff(torch, got[p].cuda(), want.cuda())
             for p, want in spmd._items(ref_grads)]
        rep["cmp"]["interleaved"] = {"loss": [loss_i.item(), ref_loss], "worst": max(w),
                                     "leaves": len(w), "of": len(got), "oracle_ms": ref_ms,
                                     "oracle_launches": ref_launches}
    save()


def ckpt_rank(torch, tt, spmd, mesh, pipe, params, step, adamw, seed, case, rep, root):
    """Phase 29 on one rank of phase 27's world, from 27a's state (fsdp,
    ZeRO-3 AdamW, one step taken): the snapshot's bytes a rank reckoned
    and the disk's free space checked (short: fail); a sharded snapshot
    (``CheckpointManager(sharded=True, keep_last_k=1)``); a second step,
    the reference; a fresh engine and optimizer restore the snapshot and
    take the second step again (``ckpt_resumed``): loss, every parameter
    shard and the optimizer state bitwise the reference's, launches as
    27a's; then one byte of one rank's file flipped, ``restore_latest``
    must answer None; the snapshot removed.  Save and restore seconds."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from torchgpipe_tpu_torch.resilience.checkpoint import CheckpointManager, _leaves
    from torchgpipe_tpu_torch.utils import serialization as ser

    rank = mesh.rank
    out = rep["ckpt"] = {}
    second = torch.from_numpy(np.random.default_rng(seed + 290).integers(
        0, GEMMA_7B["vocab"], (SPMD_BATCH, SPMD_SEQ)))
    state = pipe.train_state(params, step.optimizer)
    mine = 0
    for _, leaf in _leaves(state):   # what write_shards writes on this rank
        if isinstance(leaf, ser.Shard) and leaf.owner:
            mine += leaf.local.numel() * leaf.local.element_size()
        elif not isinstance(leaf, ser.Shard) and rank == 0:
            mine += leaf.numel() * leaf.element_size()
    total = torch.tensor([float(mine)])
    dist.all_reduce(total)
    if rank == 0:
        os.makedirs(root, exist_ok=True)
    dist.barrier()
    free = shutil.disk_usage(root).free
    out.update(bytes_rank=mine, bytes_all=int(total.item()), free_bytes=free)
    if free < CKPT_FREE_FACTOR * total.item():
        raise RuntimeError(f"phase 29: {free} B free under {root}, the snapshot needs "
                           f"{int(total.item())} B (x{CKPT_FREE_FACTOR})")
    print(f"spmd_ckpt rank {rank}: the snapshot holds {mine} B of this rank's "
          f"({int(total.item())} B in all); {free} B free under {root}", flush=True)
    run = os.path.join(root, "run")
    mgr = CheckpointManager(run, keep_last_k=1)
    dist.barrier()
    t0 = time.perf_counter()
    mgr.save(1, state, sharded=True, world_size=mesh.shape["pp"])
    out["save_s"] = time.perf_counter() - t0
    del state
    loss2 = case("ckpt_step2", lambda: step(params, second, second))
    want = [t.detach().to("cpu") for t in pipe._flat(params) + ckpt_opt(step.optimizer)]
    # A fresh engine and optimizer (the params' tensors in their shapes,
    # 27a's freed first: four ranks share the card).
    params2 = {k: spmd._tree_map(torch.empty_like, params[k]) for k in ("pre", "blocks", "post")}
    pipe2 = spmd_engine(torch, tt, spmd, mesh, True, "fill_drain", "dp", "meta", fsdp=True)[1]
    params.clear()
    step.optimizer.state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    step2 = pipe2.make_train_step(adamw, zero=3)
    step2.prepare(params2)
    dist.barrier()
    t0 = time.perf_counter()
    snap = CheckpointManager(run, keep_last_k=1).restore_latest(
        pipe2.train_state(params2, step2.optimizer))
    out["restore_s"] = time.perf_counter() - t0
    if snap is None or snap.step != 1:
        raise RuntimeError(f"phase 29: restore_latest gave {snap}, expected the snapshot of "
                           "step 1")
    pipe2.load_train_state(snap.tree, params2, step2.optimizer)
    del snap
    loss2b = case("ckpt_resumed", lambda: step2(params2, second, second))
    got = pipe2._flat(params2) + ckpt_opt(step2.optimizer)
    out["loss"] = [loss2.item(), loss2b.item()]
    out["tensors"] = len(want)
    out["bitwise"] = bool(torch.equal(loss2, loss2b)) and not bitwise(torch, got, want)
    del want, got
    dist.barrier()
    if rank == 0:   # one byte of the last rank's file
        victim = os.path.join(run, "step_0000000001", "sharded",
                              f"rank_{mesh.size(None) - 1:05d}.npz")
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
    dist.barrier()
    t0 = time.perf_counter()
    out["corrupt_restore"] = CheckpointManager(run, keep_last_k=1).restore_latest(
        pipe2.train_state(params2, step2.optimizer)) is None
    out["corrupt_s"] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root)
    dist.barrier()
    out["removed"] = not os.path.exists(root)
    del params2, step2, pipe2


def ckpt_opt(opt):
    """An optimizer's state tensors, in its parameters' order."""
    return [v for p in opt.zero_segments for v in opt.state[p].values()
            if isinstance(v, type(p))]


def phase_spmd_ckpt(card, zero_sched):
    """Phase 29's checks, on the reports of phase 27's world
    (:func:`ckpt_rank`): every rank's resumed step bitwise the reference
    step, the corrupted snapshot refused (None), the snapshot removed,
    and the resumed step's launches as 27a's."""
    reps = zero_sched["ckpt"]
    for r, c in reps.items():
        if not (c["bitwise"] and c["corrupt_restore"] and c["removed"]):
            fail(f"spmd_ckpt rank {r}: resumed bitwise {c['bitwise']} (losses {c['loss']}), "
                 f"corrupt snapshot refused {c['corrupt_restore']}, removed {c['removed']}")
        want = zero_sched["launches"][r]["zero3"]
        for name in ("ckpt_step2", "ckpt_resumed"):
            if zero_sched["launches"][r][name] != want:
                fail(f"spmd_ckpt rank {r}: {name} launched {zero_sched['launches'][r][name]}, "
                     f"27a's step {want}")
    c0 = reps[0]
    print(f"spmd_ckpt 29: a sharded snapshot of 27a's state (fsdp, zero=3 AdamW lr {ZS_LR}, "
          f"pp=2 x dp=2) through CheckpointManager(sharded=True, keep_last_k=1): bytes a rank "
          f"{[c['bytes_rank'] for c in reps.values()]} ({c0['bytes_all']} B in all, "
          f"{c0['free_bytes']} B free); save s {[round(c['save_s'], 2) for c in reps.values()]}, "
          f"restore s {[round(c['restore_s'], 2) for c in reps.values()]}; the resumed second "
          f"step bitwise the uninterrupted one on every rank (loss {c0['loss'][0]:.6f}, "
          f"{c0['tensors']} parameter and AdamW tensors a rank on rank 0); launches a rank as "
          f"27a's; one flipped byte in the last rank's file: restore_latest None on every rank "
          f"(in {[round(c['corrupt_s'], 2) for c in reps.values()]} s); snapshot removed "
          f"[{card}]", flush=True)
    print(json.dumps({"spmd_ckpt": reps}), flush=True)
    return reps


def phase_zero_sched(torch, card, seed: int):
    """Phase 27: ZeRO/FSDP and the interleaved and zero-bubble schedules
    on one world of four rank processes (:func:`zero_sched_rank`); 25b
    runs there too.  Gates: the launches of every case on every rank (a
    profile of the zb step: none on flash_simt.cu), 25b and 27d within
    SPMD_LOSS_REL / SPMD_GRAD_REL of 1F1B, 27a and 27b bitwise, 27a's
    fsdp step against the plain pipe's and 27c against the oracle within
    the same tolerances, ZeRO-3's block bytes and ZeRO-1's optimizer
    bytes at most ZS_MEMORY_MAX of zero=0's on every rank."""
    import tempfile

    from torchgpipe_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()   # the four ranks take the card
    parent_gib = torch.cuda.memory_reserved() / 2**30
    with tempfile.TemporaryDirectory() as out:
        reps, world_s = spmd_ranks(torch, seed, "z", 4, out)

    def close(loss, want, worst):
        return abs(loss - want) <= SPMD_LOSS_REL * abs(want) and worst <= SPMD_GRAD_REL

    for rep in reps:
        r, c = rep["rank"], rep["cmp"]
        for name, row in rep["cases"].items():
            expect_launches(row["launches"], ZS_LAUNCHES[name], f"27 {name} rank {r}")
            if not math.isfinite(row["loss"]):
                fail(f"spmd_zero_sched {name} rank {r}: loss {row['loss']}")
        for name in ("1f1b_vs_fill_drain", "zb_never", "zb_always", "fsdp_vs_plain"):
            if not close(*c[name]["loss"], c[name]["worst"]):
                fail(f"spmd_zero_sched {name} rank {r}: losses {c[name]['loss']}, worst "
                     f"gradient leaf {c[name]['worst']:.3e} of its max (tols "
                     f"{SPMD_LOSS_REL}, {SPMD_GRAD_REL})")
        for name in ("zero3", "zero1"):
            if not c[name]["bitwise"]:
                fail(f"spmd_zero_sched {name} rank {r}: the update is not bitwise the "
                     f"unsharded one (losses {c[name]['loss']}, worst leaf "
                     f"{c[name]['worst']:.3e})")
        mem = rep["memory"]
        ratios = {"zero3_block": mem["zero3"]["block_param"] / mem["zero0"]["block_param"],
                  "zero1_state": mem["zero1"]["state"] / mem["zero0"]["state"]}
        rep["ratios"] = ratios
        if max(ratios.values()) > ZS_MEMORY_MAX:
            fail(f"spmd_zero_sched rank {r}: memory ratios {ratios} against zero=0 "
                 f"(at most {ZS_MEMORY_MAX})")
    want = {k: ZS_LAUNCHES["zb_never"].get(k, 0) for k in SPMD_PROFILE}
    if reps[0]["profile"] != want:
        fail(f"spmd_zero_sched rank 0: the zb step's profile launched {reps[0]['profile']} "
             f"of {SPMD_PROFILE}, expected {want}")
    il = reps[0]["cmp"]["interleaved"]
    if not close(*il["loss"], il["worst"]) or il["leaves"] != il["of"]:
        fail(f"spmd_zero_sched 27c: interleaved {il} against the sequential oracle")
    expect_launches(il["oracle_launches"], ZS_ORACLE_LAUNCHES, "27c oracle")
    # simulate_pipeline of the measured cells: the 1F1B step's on 2
    # stages, the interleaved step's as 4 global blocks.
    lane0 = [rep for rep in reps if rep["coords"]["dp"] == 0]
    cells = {k: [tracing.TimelineEvent(*e) for rep in lane0 for e in rep[k]]
             for k in ("cells_1f1b", "cells_interleaved")}
    proj = {s: tracing.simulate_pipeline(cells["cells_1f1b"], 2, s)
            for s in ("fill_drain", "1f1b", "zb")}
    proj["interleaved"] = tracing.simulate_pipeline(cells["cells_interleaved"], 2 * ZS_V,
                                                    "interleaved", ZS_V)
    step = {name: [round(rep["cases"][name]["ms"], 1) for rep in reps]
            for name in reps[0]["cases"]}
    staged = {name: reps[0]["cases"][name]["staged"] for name in reps[0]["cases"]}
    peak = {name: [round(rep["cases"][name]["peak_gib"], 2) for rep in reps]
            for name in reps[0]["cases"]}
    mem = {rep["rank"]: rep["memory"] for rep in reps}
    c0 = reps[0]["cmp"]
    print(f"spmd_zero_sched: Gemma-7B width (dim 3072, 16 heads of 256, ffn 24576, vocab "
          f"256000), bf16, batch {SPMD_BATCH} x seq {SPMD_SEQ}, chunks {SPMD_CHUNKS}, pp=2 x "
          f"dp=2 over gloo (4 processes on this card) [{card}]", flush=True)
    print(f"spmd_zero_sched 25b: 1F1B loss {c0['1f1b_vs_fill_drain']['loss'][0]:.6f} vs "
          f"fill-drain {c0['1f1b_vs_fill_drain']['loss'][1]:.6f}, worst gradient leaf by rank "
          f"{[round(rep['cmp']['1f1b_vs_fill_drain']['worst'], 6) for rep in reps]} of its "
          f"max", flush=True)
    for name in ("zb_never", "zb_always"):
        print(f"spmd_zero_sched 27d {name}: loss {c0[name]['loss'][0]:.6f} vs 1F1B "
              f"{c0[name]['loss'][1]:.6f}; worst leaf by rank "
              f"{[rep['cmp'][name]['worst'] for rep in reps]}; bitwise by rank "
              f"{[rep['cmp'][name]['bitwise'] for rep in reps]}", flush=True)
    print(f"spmd_zero_sched 27a: fsdp zero=3 AdamW (lr {ZS_LR}) bitwise the unsharded "
          f"AdamW of the gathered tensors fed the same gradients, on every rank (loss "
          f"{c0['zero3']['loss'][0]:.6f}); fsdp vs plain: losses "
          f"{c0['fsdp_vs_plain']['loss']}, worst leaf by rank "
          f"{[rep['cmp']['fsdp_vs_plain']['worst'] for rep in reps]}, bitwise by rank "
          f"{[rep['cmp']['fsdp_vs_plain']['bitwise'] for rep in reps]}; 27b: zero=1 bitwise "
          f"the zero=0 update on every rank", flush=True)
    print(f"spmd_zero_sched 27c: interleaved v={ZS_V} (4 blocks), fsdp, untied: loss "
          f"{il['loss'][0]:.6f} vs the sequential oracle's {il['loss'][1]:.6f}; {il['leaves']} "
          f"gradient leaves, worst {il['worst']:.3e} of its max; the oracle {il['oracle_ms']:.1f}"
          f" ms, launches {il['oracle_launches']}", flush=True)
    print(f"spmd_zero_sched: step ms by case, ranks 0-3 {step}; bytes staged through the "
          f"host by kind, rank 0 {staged}; peak GiB by case, ranks 0-3 {peak}", flush=True)
    print(f"spmd_zero_sched: block params / grads / optimizer state, all state, peak GiB by "
          f"rank and ZeRO level {mem}; ratios to zero=0 {[rep['ratios'] for rep in reps]}",
          flush=True)
    print(f"spmd_zero_sched: launches a rank (rank 0) "
          f"{ {n: {k: v for k, v in row['launches'].items() if v} for n, row in reps[0]['cases'].items()} }"
          f"; the zb 'never' step's profile on rank 0 {reps[0]['profile']}", flush=True)
    print(f"spmd_zero_sched: simulate_pipeline (makespan s, busy, bubble) of the 1F1B "
          f"step's cells on 2 stages and the interleaved step's as 4 global blocks (zb: B "
          f"and W halves of each measured backward) {proj}; the world {world_s:.1f}s, "
          f"started in {max(rep['ready_s'] for rep in reps):.1f}s (rank 0's seconds at the "
          f"end of 25b/27d, 27a, 27b, 27c: {reps[0]['parts_s']}), this process holding "
          f"{parent_gib:.2f} GiB; the phase {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)
    result = {"card": card, "step_ms": step, "staged_bytes": staged, "peak_gib": peak,
              "memory": mem,
              "ratios": [rep["ratios"] for rep in reps], "cmp": {rep["rank"]: rep["cmp"]
                                                                for rep in reps},
              "launches": {rep["rank"]: {n: row["launches"] for n, row in rep["cases"].items()}
                           for rep in reps},
              "profile": reps[0]["profile"], "projections": proj,
              "world_s": world_s, "ckpt": {rep["rank"]: rep["ckpt"] for rep in reps}}
    print(json.dumps({"spmd_zero_sched": result}), flush=True)
    return result


# --------------------------------------------------------------------- #
# phase 28: expert parallelism in the SPMD engine                        #
# --------------------------------------------------------------------- #

# Phase 22's Mixtral-8x7B widths (MIXTRAL: dim 4096, 32/8 heads, hidden
# 14336, vocab 32000; 8 experts, top-2, balance weight 0.02) in bf16, 2
# of its 32 blocks, one a stage; batch 8 x seq 1024 in 4 micro-batches,
# 'except_last', fill-drain.  One world of four rank processes over gloo
# on this card, pp=2 x ep=2: each rank holds its stage's block with 4 of
# the 8 experts (3 x 4096 x 14336 bf16 a expert: 1.41 GB a rank) and one
# row of each micro-batch.  Dispatch 'sparse' at capacity factor E/k = 4
# (capacity = the lane's tokens: no token drops): Mixtral's own
# 'dropless' takes no ep axis (its ragged segments have data-dependent
# sizes; the reference refuses it), and phase 22 holds 'sparse' at E/k
# to 'dropless'.
EP_MOE = dict(MIXTRAL_MOE, dispatch="sparse", capacity_factor=8 / 2, ep_axis="ep")
EP_WORLD, EP_DEADLINE_S = 4, 360
# A rank's launches a step, written before the phase first ran: its one
# block under 'except_last' at MIXTRAL_CHUNKS micro-batches, head dim 128
# on the bf16 tensor-core kernels: 4 forwards and 3 recomputes, 4 dQ and
# 4 dK/dV; eval_loss 4 forwards.  The oracle (below) runs each of the 8
# rows through both blocks without checkpoints: 16 of each.
EP_LAUNCHES = {"flash_fwd": 2 * MIXTRAL_CHUNKS - 1, "flash_bwd_dq": MIXTRAL_CHUNKS,
               "flash_bwd_dkv": MIXTRAL_CHUNKS}
EP_EVAL_LAUNCHES = {"flash_fwd": MIXTRAL_CHUNKS}
EP_ORACLE_LAUNCHES = {k: 2 * MIXTRAL_BATCH for k in EP_LAUNCHES}
# The oracle runs the unsharded model (ep_axis None, the same dispatch)
# row by row in the order the lanes hold the rows, so each row's routing,
# capacity and products are the lane's.  The loss: phase 22's 1e-6
# relative (the float32 mean over the same bf16 logits in another order).
# The gradients cannot keep phase 22's 2^-7 of a leaf's max (there the
# two steps sum the same micro-batches' bf16 gradients in the same
# order): a rank sums its 4 rows' bf16 gradients (3 roundings of the
# running sum, each up to 2^-9 of it) and then the 2 ep lanes' (1 more),
# the oracle its 8 rows' (7): up to 11 x 2^-9 = 2.1% of max |g| apart,
# so EP_GRAD_REL = 2^-5 (3.1%; measured at first 1.36%).
EP_LOSS_REL, EP_GRAD_REL = 1e-6, 2 ** -5


def moe_ep_engine(torch, tt, spmd, mesh, device: str, ep: bool = True):
    """Phase 28's engine: ``llama_moe_spmd`` at MIXTRAL widths on
    ``device`` ("meta": a template that draws nothing)."""
    from torchgpipe_tpu_torch.models import moe as tm

    cfg = tt.TransformerConfig(**MIXTRAL, dtype=torch.bfloat16)
    moe = tm.MoEConfig(**dict(EP_MOE, ep_axis="ep" if ep else None))
    block, pre, post = tm.llama_moe_spmd(cfg, moe, 2, device=device)
    pipe = spmd.SpmdGPipe(block, 2, mesh, chunks=MIXTRAL_CHUNKS, loss_fn=causal_lm_loss(tt),
                          pre=pre, post=post, checkpoint="except_last",
                          ep_axis="ep" if ep else None)
    return cfg, moe, pipe


def moe_ep_batch(torch, seed: int):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed + 28).integers(
        0, MIXTRAL["vocab"], (MIXTRAL_BATCH, MIXTRAL_SEQ)))


def moe_ep_oracle(torch, tfa, tt, spmd, seed: int, path: str):
    """Phase 28's sequential oracle here on the card: the same global
    params (the ranks' draw) through the unsharded MoE model (ep_axis
    None, the same 'sparse' dispatch and capacity factor), one row at a
    time in the lanes' order (micro-batch i's rows 2i and 2i + 1, lanes 0
    and 1): pre, both blocks, the head and the loss of each row, its
    gradient seeded with 1/8 (the mean over rows) and the balance
    penalty's with aux scale 1/8 (the engine's 1/m a cell, averaged over
    the ep lanes).  The gradient tree goes to ``path`` for the ranks,
    which each read their shard of it."""
    from torchgpipe_tpu_torch.auxgrad import aux_scale

    gc.collect()
    torch.cuda.empty_cache()
    _, _, pipe = moe_ep_engine(torch, tt, spmd, _Stand(2, 1, torch.device("cuda")), "cuda",
                               ep=False)
    params = pipe.init(torch.Generator(device="cuda").manual_seed(seed + 28),
                       ((MIXTRAL_BATCH, MIXTRAL_SEQ), torch.int64))
    spmd_free_templates(pipe)
    leaves = {k: spmd._tree_map(lambda a: a.detach().requires_grad_(), params[k])
              for k in ("pre", "blocks", "post")}
    del params
    tokens = moe_ep_batch(torch, seed).cuda()
    rows = tokens.shape[0]
    tfa.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = 0.0
    for r in range(rows):
        x = tokens[r:r + 1]
        with aux_scale(1.0 / rows):
            h = pipe._run_pre(leaves, x, True)
            for g in range(2):
                h = spmd._call(pipe.block, pipe._names["blocks"],
                               spmd._tree_map(lambda a: a[g], leaves["blocks"]), h)
            row = causal_lm_loss(tt)(pipe._run_post(leaves, h), x).float()
        (row / rows).backward()
        loss += row.item() / rows
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = kernel_launches(tfa)
    grads = {k: spmd._tree_map(lambda a: a.grad.detach().cpu(), leaves[k]) for k in leaves}
    del leaves, h
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    torch.save({"loss": loss, "grads": grads}, path)
    return {"loss": loss, "ms": ms, "peak_gib": peak, "launches": launches,
            "save_s": time.perf_counter() - t1}


def moe_ep_rank(torch, tfa, tt, spmd, mesh, seed: int, out: str) -> None:
    """Phase 28 on one rank of the pp=2 x ep=2 world: step 1 by
    ``train_step`` (its loss and every gradient of this rank's shard,
    expert leaves this lane's 4 experts, against the oracle's, read from
    its file), an SGD update, step 2 by ``make_train_step``, then
    ``eval_loss``; ``router_stats`` of this rank's block router on its
    lane's rows; each step's ms, bytes staged by kind (``'ep'`` the
    experts' all-to-alls, ``'grads'`` the gradient reductions), peak and
    launches, written to ``out/e_rank<r>.json``."""
    import torch.distributed as dist

    from torchgpipe_tpu_torch.models import moe as tm

    t_start = time.perf_counter()
    rank = mesh.rank
    rep = {"rank": rank, "coords": mesh.coords, "steps": []}
    path = os.path.join(out, f"e_rank{rank}.json")
    cfg, moe, pipe = moe_ep_engine(torch, tt, spmd, mesh, "cuda")
    params = pipe.init(torch.Generator(device="cuda").manual_seed(seed + 28),
                       ((MIXTRAL_BATCH, MIXTRAL_SEQ), torch.int64))
    local = pipe.place(params)
    del params
    spmd_free_templates(pipe)
    gc.collect()
    torch.cuda.empty_cache()
    tokens = moe_ep_batch(torch, seed)
    rep["expert_bytes"] = sum(a.numel() * a.element_size()
                              for path_, a in spmd._items(local["blocks"])
                              if path_[-1] in ("w_gate", "w_up", "w_down"))
    dist.barrier()
    rep["ready_s"] = time.perf_counter() - t_start

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tfa.reset_launches()
        by0, t0 = dict(mesh.staged_by), time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rep["steps"].append({
            "name": name, "ms": (time.perf_counter() - t0) * 1e3,
            "staged": {k: v - by0.get(k, 0) for k, v in mesh.staged_by.items()
                       if v != by0.get(k, 0)},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": kernel_launches(tfa)})
        return res

    def flat(tree):
        return [(k, p, a) for k in ("pre", "blocks", "post") for p, a in spmd._items(tree[k])]

    loss1, grads = timed("step1", lambda: pipe.train_step(local, tokens, tokens))
    # This rank's shard of the oracle's gradients, read from its file.
    ref = torch.load(os.path.join(out, "oracle.pt"), mmap=True, weights_only=True)
    worst = {}
    for (key, p, g), (_, spec) in zip(flat(grads), [
            (k, sp) for k in ("pre", "blocks", "post")
            for _, sp in spmd._items(spmd.broadcast_specs(pipe._specs[k], grads[k]))]):
        want = pipe._shard(spmd._get(ref["grads"][key], p), spec)
        worst["/".join(map(str, (key,) + p))] = spmd_rel_diff(torch, g, want)
    rep["step1"] = {"loss": loss1.item(), "oracle_loss": ref["loss"], "worst": worst}
    del ref
    with torch.no_grad():
        for (_, _, t), (_, _, g) in zip(flat(local), flat(grads)):
            t.sub_(TRAIN_LR * g)
    del grads
    step = pipe.make_train_step(lambda ts: torch.optim.SGD(ts, lr=TRAIN_LR))
    loss2 = timed("step2", lambda: step(local, tokens, tokens))
    loss3 = timed("eval", lambda: pipe.eval_loss(local, tokens, tokens))
    rep["losses"] = [loss1.item(), loss2.item(), loss3.item()]
    # router_stats of this rank's block router on its lane's rows of
    # micro-batch 0 (after the embedding and the block's ln2).
    with torch.no_grad():
        lane_rows = pipe._local_microbatches(tokens)[0]
        h = pipe._run_pre(local, lane_rows, False)
        blk = spmd._tree_map(lambda a: a[0], local["blocks"][0])
        load, importance, balance = tm.router_stats(
            blk["mlp"]["router"], tt._block_norm(cfg, blk, "ln2", h), moe)
    rep["router_stats"] = {"load": load.tolist(), "importance": importance.tolist(),
                           "balance": balance.item()}
    rep["s"] = time.perf_counter() - t_start
    with open(path, "w") as f:
        json.dump(rep, f)


def phase_moe_ep(torch, tfa, tt, card, seed: int):
    """Phase 28: expert parallelism (pp=2 x ep=2) at Mixtral-8x7B width on
    four gloo rank processes on this card (:func:`moe_ep_rank`), against
    the sequential oracle here (:func:`moe_ep_oracle`).  Gates: step 1's
    loss and every gradient shard within EP_LOSS_REL / EP_GRAD_REL of the
    oracle's, the loss lower after two SGD steps, every launch count,
    router_stats sane on every lane."""
    import tempfile

    from torchgpipe_tpu_torch import spmd

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        orc = moe_ep_oracle(torch, tfa, tt, spmd, seed, os.path.join(out, "oracle.pt"))
        expect_launches(orc["launches"], EP_ORACLE_LAUNCHES, "28's oracle")
        gc.collect()
        torch.cuda.empty_cache()   # the four ranks take the card
        reps, world_s = spmd_ranks(torch, seed, "e", EP_WORLD, out)
    for rep in reps:
        r, s1 = rep["rank"], rep["step1"]
        if abs(s1["loss"] - orc["loss"]) > EP_LOSS_REL * abs(orc["loss"]):
            fail(f"spmd_moe_ep rank {r}: step-1 loss {s1['loss']} vs the sequential "
                 f"oracle's {orc['loss']} (rel tol {EP_LOSS_REL})")
        bad = {k: v for k, v in s1["worst"].items() if not v <= EP_GRAD_REL}
        if bad:
            fail(f"spmd_moe_ep rank {r}: gradient shards beyond {EP_GRAD_REL} of each leaf's "
                 f"max against the oracle: {bad}")
        losses = rep["losses"]
        if not (all(math.isfinite(v) for v in losses) and losses[2] < losses[0]):
            fail(f"spmd_moe_ep rank {r}: losses {losses} (step 1, step 2, eval after two SGD "
                 "steps): not finite or not lower")
        for row, want in zip(rep["steps"], (EP_LAUNCHES, EP_LAUNCHES, EP_EVAL_LAUNCHES)):
            expect_launches(row["launches"], want, f"28 {row['name']} rank {r}")
        st = rep["router_stats"]
        if not (abs(sum(st["load"]) - 1) < 1e-5 and abs(sum(st["importance"]) - 1) < 1e-5
                and st["balance"] >= 1 - 1e-5 and math.isfinite(st["balance"])):
            fail(f"spmd_moe_ep rank {r}: router_stats {st}")
    by = {name: {f"r{rep['rank']}": row for rep in reps for row in rep["steps"]
                 if row["name"] == name} for name in ("step1", "step2", "eval")}
    steps = {n: [round(v["ms"], 1) for v in rows.values()] for n, rows in by.items()}
    staged = {n: {k: row["staged"] for k, row in rows.items()} for n, rows in by.items()}
    peaks = {n: [round(v["peak_gib"], 2) for v in rows.values()] for n, rows in by.items()}
    worst = max(v for rep in reps for v in rep["step1"]["worst"].values())
    print(f"spmd_moe_ep: Mixtral-8x7B width (dim 4096, 32/8 heads, hidden 14336, vocab "
          f"32000, 8 experts top-2, balance 0.02), bf16, 2 blocks, batch {MIXTRAL_BATCH} x "
          f"seq {MIXTRAL_SEQ}, chunks {MIXTRAL_CHUNKS}, except_last, fill-drain, dispatch "
          f"'sparse' at capacity factor E/k; pp=2 x ep=2 over gloo (4 processes on this "
          f"card: host staging, not multi-card scaling); {reps[0]['expert_bytes']} B of "
          f"expert weights a rank [{card}]", flush=True)
    print(f"spmd_moe_ep: step-1 loss {reps[0]['step1']['loss']:.7f} vs the sequential "
          f"oracle's {orc['loss']:.7f} (rel {abs(reps[0]['step1']['loss'] - orc['loss']) / abs(orc['loss']):.3e}, "
          f"tol {EP_LOSS_REL}); every rank's gradient shards, worst {worst:.3e} of its max "
          f"(tol {EP_GRAD_REL}); losses by rank (step 1, step 2, eval after two SGD steps) "
          f"{[rep['losses'] for rep in reps]}; router_stats by rank "
          f"{[rep['router_stats'] for rep in reps]}", flush=True)
    print(f"spmd_moe_ep: step ms by rank {steps}; bytes staged through the host by kind "
          f"('ep' the all-to-alls, 'grads' the gradient reductions) {staged}; peak GiB "
          f"{peaks}; launches a rank {reps[0]['steps'][0]['launches']}; the oracle "
          f"{orc['ms']:.1f} ms, peak {orc['peak_gib']:.2f} GiB, launches {orc['launches']}, "
          f"saved in {orc['save_s']:.1f}s; the world {world_s:.1f}s (started in "
          f"{max(rep['ready_s'] for rep in reps):.1f}s); the phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    result = {"card": card, "oracle": orc, "step1_loss": reps[0]["step1"]["loss"],
              "grad_worst_rel": worst, "losses": {r["rank"]: r["losses"] for r in reps},
              "step_ms": steps, "staged_bytes": staged, "peak_gib": peaks,
              "launches_a_rank": reps[0]["steps"][0]["launches"],
              "router_stats": {r["rank"]: r["router_stats"] for r in reps},
              "expert_bytes_a_rank": reps[0]["expert_bytes"], "world_s": world_s}
    print(json.dumps({"spmd_moe_ep": result}), flush=True)
    return result


PHASES = {
    "3": "fwd", "4": "decode", "5": "bwd", "5b": "simt", "6": "generate", "6b": "generate_int8",
    "6c": "speculative", "6d": "beam", "7": "profile", "9": "serving",
    "9b": "int8_weights", "8": "train", "10": "train_1f1b", "11": "resnet101",
    "12": "train_graph", "13": "precision", "14": "offload", "15": "lora", "16": "unet",
    "17": "timeline", "18": "vit_l16", "19": "amoebanetd", "20": "t5",
    "21": "gpt2_xl_generate", "22": "mixtral_moe", "23": "distributed", "24": "fleet",
    "25": "spmd", "26": "spmd_tp_sp", "27": "spmd_zero_sched", "28": "spmd_moe_ep",
    "29": "spmd_ckpt",
}
PHASE_ORDER = list(PHASES)
PHASE_NEEDS = {"6b": ["6"], "6c": ["6"], "6d": ["6"], "7": ["6"], "9": ["6"], "24": ["6"],
               "9b": ["6", "9"], "12": ["10"], "13": ["11", "12"], "14": ["10"],
               "15": ["8"], "17": ["16"], "29": ["27"]}


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
    # A rank process of phase 23 (started by that phase, not by hand).
    ap.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-ports", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-out", default=None, help=argparse.SUPPRESS)
    # A rank process of phase 25 (started by that phase).
    for opt in ("--spmd-rank", "--spmd-world", "--spmd-port"):
        ap.add_argument(opt, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-case", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-out", default=None, help=argparse.SUPPRESS)
    # A rank process of phase 26 (started by that phase).
    for opt in ("--tpsp-rank", "--tpsp-port"):
        ap.add_argument(opt, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tpsp-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:
        dist_rank_main(args)
        return
    if args.spmd_rank is not None:
        spmd_rank_main(args)
        return
    if args.tpsp_rank is not None:
        tp_sp_rank_main(args)
        return
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
        from torchgpipe_tpu_torch.utils import hw
    except ImportError as e:
        fail(f"torchgpipe_tpu_torch is not importable beside this script ({e})")
    global PEAK_BF16_FLOPS
    PEAK_BF16_FLOPS = hw.peak_bf16_flops_for_name(H100_SXM)

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
                                                 *gen_model(), r["9"])),
               ("24", lambda: phase_fleet(torch, tfa, tt, card, args.seed,
                                          *gen_model()[:2]))],
              "6-9b, 24 (generate .. int8_weights, fleet)")
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
    timed([("23", lambda: phase_distributed(torch, tfa, tt, card, args.seed)),
           ("25", lambda: phase_spmd(torch, tfa, tt, tg, card, args.seed)),
           ("26", lambda: phase_tp_sp(torch, tfa, tt, card, args.seed)),
           ("27", lambda: phase_zero_sched(torch, card, args.seed)),
           ("29", lambda: phase_spmd_ckpt(card, r["27"])),
           ("28", lambda: phase_moe_ep(torch, tfa, tt, card, args.seed))],
          "23, 25-29 (distributed, spmd, spmd_tp_sp, spmd_zero_sched, spmd_ckpt, "
          "spmd_moe_ep)")

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
    dist, spmd_run, tp_sp, zero_sched = r["23"], r["25"], r["26"], r["27"]
    moe_ep = r["28"]

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
             "d80_llama_generate": simt["paths"]["d80_llama"]["generate"],
             "f16_llama_train": simt["paths"]["f16_llama"]["train"],
             "f16_llama_generate": simt["paths"]["f16_llama"]["generate"],
             "distributed": dist["launches_sum"],
             "spmd_rank": spmd_run["launches_a_rank"],
             "spmd_generate": spmd_run["generate_launches"],
             "spmd_tp_rank": tp_sp["launches_tp"],
             "spmd_ring_rank0": tp_sp["launches_ring"][0],
             "spmd_ring_rank1": tp_sp["launches_ring"][1],
             "spmd_ulysses_rank": tp_sp["launches_ulysses"],
             **{f"spmd_{name}_rank": launches for name, launches in
                zero_sched["launches"][0].items()},
             "spmd_moe_ep_rank": moe_ep["launches_a_rank"]}

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
                                "pad_d32": bwd_path(bwd["pad_d32"], key, head_dim="32->64"),
                                "ring_block": bwd_path(bwd["ring_block"], key, causal=False),
                                "tp_lane": bwd_path(bwd["tp_lane"], key)}}

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
                                   "vit_l16", "gpt2_xl_prefill", "pad_d80", "pad_d32",
                                   "ring_diag", "ring_block", "tp_lane")}},
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
    wrows, wworst = simt["wide_rows"], simt["wide_worst"]

    def f16_entry(name, key, line, source, wrapper):
        row = wrows["f16_train_microbatch"]
        fwd_ = key == "fwd"
        lib = row["lib_fwd"] if fwd_ else row["lib_bwd"]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": f"{ref}:{line}", "instantiation": "float16",
                "launches": paths["f16_llama_train"][wrapper],
                "launches_by_path": {p: paths[p].get(wrapper, 0)
                                     for p in ("f16_llama_train", "f16_llama_generate")},
                "max_abs_err": wworst["f16_f16" if fwd_ else "f16_f16_bwd"],
                "ms": row["ms"][key], "plain_ms": row["plain_fwd" if fwd_ else "plain_bwd"],
                "plain_covers": "forward" if fwd_ else "all three gradients",
                "bound_ms": row["bounds"][key][0], "bound_by": row["bounds"][key][1],
                "library_ms": lib[2], "library_backend": lib[1],
                "library_ms_by_backend": lib[0],
                "shape": "f16 b=2 s=1024 h=32 g=8 d=128 causal"}

    def big_dims(key, dims=(384, 512)):
        # flash_simt.cu at head dims 384 and 512 (bf16): the same kernel's
        # sixteen-lane instantiation, timed beside its bound, plain and SDPA;
        # at 640 and 1024 its chunked kernels.
        out = {}
        for d in dims:
            row = wrows[f"bf16_d{d}"]
            lib = row["lib_fwd"] if key == "fwd" else row["lib_bwd"]
            out[f"d{d}"] = {
                "shape": f"bf16 b=1 s=512 h=8 g=4 d={d} causal", "ms": row["ms"][key],
                "plain_ms": row["plain_fwd" if key == "fwd" else "plain_bwd"],
                "bound_ms": row["bounds"][key][0], "bound_by": row["bounds"][key][1],
                "bound_fma_ms": row["fma"][key], "library_ms": lib[2],
                "library_backend": lib[1], "smem_dynamic_bytes": smem_simt(
                    {"fwd": 0, "dq": 1, "dkv": 2}[key], d)}
        return out

    def wide_entry(name, key, line, takes, row_name, shape, err):
        row = wrows[row_name]
        fwd_ = key == "fwd"
        lib = row["lib_fwd"] if fwd_ else row["lib_bwd"]
        return {"name": name, "route": "cuda", "source": src + "flash_simt.cu",
                "replaces": f"{ref}:{line}", "launches": paths["spmd_rank"][name],
                "launches_by_path": by_path(name), "max_abs_err": err,
                "ms": row["ms"][key],
                "plain_ms": row["plain_fwd" if fwd_ else "plain_bwd"],
                "plain_covers": "forward" if fwd_ else "all three gradients",
                "bound_ms": row["bounds"][key][0], "bound_by": row["bounds"][key][1],
                "bound_fma_ms": row["fma"][key], "library_ms": lib[2],
                "library_backend": lib[1], "library_ms_by_backend": lib[0], "takes": takes,
                "shape": shape, "head_dims_384_512": big_dims(key),
                "head_dims_640_1024": big_dims(key, (640, 1024))}

    def d256_entry(name, key, line, source):
        row, long = wrows["gemma_microbatch"], wrows["gemma_long"]
        fwd_ = key == "fwd"
        lib, llib = ((row["lib_fwd"], long["lib_fwd"]) if fwd_ else
                     (row["lib_bwd"], long["lib_bwd"]))
        err = {"fwd": "", "dq": "_dq", "dkv": "_dkv"}[key]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": f"{ref}:{line}", "instantiation": "head dim 256, bf16 and f16",
                "launches": paths["spmd_rank"][name], "launches_by_path": by_path(name),
                "max_abs_err": max(wworst[f"wide_tc_{t}{err}"] for t in ("bf16", "f16")),
                "ms": row["ms"][key], "earlier_kernel_ms": row["ms"][key + "_simt"],
                "plain_ms": row["plain_fwd" if fwd_ else "plain_bwd"],
                "plain_covers": "forward" if fwd_ else "all three gradients",
                "bound_ms": row["bounds"][key][0], "bound_by": row["bounds"][key][1],
                "library_ms": lib[2], "library_backend": lib[1],
                "library_ms_by_backend": lib[0],
                "shape": "bf16 b=2 s=512 h=g=16 d=256 causal (phase 25's micro-batch)",
                "long_shape": {"shape": "bf16 b=1 s=4096 h=g=16 d=256 causal",
                               "ms": long["ms"][key],
                               "earlier_kernel_ms": long["ms"][key + "_simt"],
                               "plain_ms": long["plain_fwd" if fwd_ else "plain_bwd"],
                               "bound_ms": long["bounds"][key][0],
                               "bound_by": long["bounds"][key][1],
                               "share_of_bound": long["bounds"][key][0] / long["ms"][key],
                               "library_ms": llib[2], "library_backend": llib[1]}}

    def decode_row_entry(name, row_name, wrapper, path, **extra):
        row = wrows[row_name]
        return {"name": name, "route": "cuda", "replaces": f"{ref}:1024",
                "launches": paths[path].get(wrapper, 0),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["lib"][2],
                "library_backend": row["lib"][1], "library_ms_by_backend": row["lib"][0],
                **extra}

    kernels += [
        f16_entry("flash_fwd_f16", "fwd", 69, "flash_fwd.cu", "flash_fwd"),
        f16_entry("flash_bwd_dq_f16", "dq", 538, "flash_bwd.cu", "flash_bwd_dq"),
        f16_entry("flash_bwd_dkv_f16", "dkv", 592, "flash_bwd.cu", "flash_bwd_dkv"),
        decode_row_entry("flash_decode_f16", "f16_generate", "flash_decode",
                         "f16_llama_generate", source=src + "flash_decode.cu",
                         instantiation="float16", max_abs_err=wworst["decode_f16"],
                         launches_by_path={"f16_llama_generate": paths[
                             "f16_llama_generate"].get("flash_decode", 0)},
                         shape="f16 cache [4, 544, 8, 128] live 528 g=1"),
        d256_entry("flash_fwd_d256", "fwd", 69, "flash_fwd.cu"),
        d256_entry("flash_bwd_dq_d256", "dq", 538, "flash_bwd.cu"),
        d256_entry("flash_bwd_dkv_d256", "dkv", 592, "flash_bwd.cu"),
        wide_entry("flash_fwd_wide", "fwd", 69, WIDE_TAKES, "bf16_d192",
                   "bf16 b=2 s=512 h=16 g=8 d=192 causal",
                   max(wworst["wide_simt_bf16"], wworst["wide_simt_f32"])),
        wide_entry("flash_bwd_dq_wide", "dq", 538, WIDE_TAKES, "bf16_d192",
                   "bf16 b=2 s=512 h=16 g=8 d=192 causal",
                   max(wworst["wide_simt_bf16_dq"], wworst["wide_simt_f32_dq"])),
        wide_entry("flash_bwd_dkv_wide", "dkv", 592, WIDE_TAKES, "bf16_d192",
                   "bf16 b=2 s=512 h=16 g=8 d=192 causal",
                   max(wworst["wide_simt_bf16_dkv"], wworst["wide_simt_f32_dkv"])),
        decode_row_entry("flash_decode_d256", "gemma_generate", "flash_decode_d256",
                         "spmd_generate", source=src + "flash_decode.cu",
                         instantiation="head dim 256: bf16, f16 and int8 caches",
                         max_abs_err=wworst["decode_d256"],
                         launches_by_path=by_path("flash_decode_d256"),
                         earlier_kernel_ms=wrows["gemma_generate"]["simt_ms"],
                         shape="bf16 cache [2, 144, 16, 256] live 136 g=1 (25c)",
                         long_cache={"shape": "bf16 cache [1, 4160, 16, 256] live 4096 g=1",
                                     **{k: wrows["gemma_long_cache"][k] for k in (
                                         "ms", "simt_ms", "plain_ms", "bound_ms", "bound_by")},
                                     "share_of_bound": wrows["gemma_long_cache"]["bound_ms"]
                                     / wrows["gemma_long_cache"]["ms"],
                                     "library_ms": wrows["gemma_long_cache"]["lib"][2],
                                     "library_backend": wrows["gemma_long_cache"]["lib"][1]}),
        decode_row_entry("flash_decode_wide", "bf16_d192_generate", "flash_decode_wide",
                         "spmd_generate", source=src + "flash_simt.cu",
                         max_abs_err=wworst["decode_wide"],
                         launches_by_path=by_path("flash_decode_wide"),
                         takes="head dims 129-255 and the multiples of 128 above 256 "
                               "(bf16, f16, f32 and int8 caches) and f32 caches at 256",
                         shape="bf16 cache [2, 144, 8, 192] live 136 g=1",
                         head_dims_384_512={
                             f"d{d}": {"shape": f"bf16 cache [1, 320, 4, {d}] live 300 g=1",
                                       **{k: wrows[f"bf16_d{d}_generate"][k] for k in (
                                           "ms", "plain_ms", "bound_ms", "bound_by")},
                                       "library_ms": wrows[f"bf16_d{d}_generate"]["lib"][2]}
                             for d in (384, 512)},
                         head_dims_640_1024={
                             f"d{d}": {"shape": f"bf16 cache [1, 320, 4, {d}] live 300 g=1",
                                       **{k: wrows[f"bf16_d{d}_generate"][k] for k in (
                                           "ms", "plain_ms", "bound_ms", "bound_by")},
                                       "library_ms": wrows[f"bf16_d{d}_generate"]["lib"][2]}
                             for d in (640, 1024)}),
    ]
    smem = smem_dynamic(_build)
    for k in kernels:
        k["ptxas"] = {f: resources[f] for f in KERNEL_FUNCS[k["name"]][1]}
        if k["name"] in smem:
            k["smem_dynamic_bytes"] = smem[k["name"]]
    for k in kernels:
        if k["name"] in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tf32",
                         "flash_bwd_dkv_tf32", "flash_bwd_dq_d256", "flash_bwd_dkv_d256"):
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
