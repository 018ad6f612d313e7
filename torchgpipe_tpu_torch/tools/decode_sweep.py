#!/usr/bin/env python3
"""Device time of the decode kernel against the width of its split, on one
NVIDIA GPU.

    python3 torchgpipe_tpu_torch/tools/decode_sweep.py [--wants 4,6,8,12,16]

At chip_smoke.py's two decode timing shapes (cache [4, max_len, 8, 128],
g=1, live 1088 of 1152 cycling four caches past L2, and live 32704 of
32768), with a bf16 and an int8 cache, each ``want`` (the most chunks a
(batch row, kv head) is cut into; the wrapper picks it from
``ops/flash_attention.DECODE_WAVE``) is timed twice on the device clock
(``torch.profiler``, the chunk kernel and the merge kernel apart).  Prints
one line per (shape, cache, want) with the card's name and power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def kernel_ms(torch, fn, reps: int = 40):
    """Per-call device time of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0) / 1e3 / reps
        if ms > 0:
            name = "merge" if "merge" in e.key else "chunks" if "flash_decode" in e.key else e.key
            out[name] = out.get(name, 0.0) + ms
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wants", default="4,6,8,12,16")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep: no CUDA device")
    import chip_smoke as cs
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.ops import _build
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    _build.build_all()
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    chosen = tfa.decode_want
    for max_len, live, nsets in ((1152, 1088, 4), (32768, 32704, 1)):
        q = torch.randn(4, 1, 32, 128, generator=gen, device="cuda").bfloat16()
        sets = {
            "bf16": [(torch.randn(4, max_len, 8, 128, generator=gen, device="cuda").bfloat16(),
                      torch.randn(4, max_len, 8, 128, generator=gen, device="cuda").bfloat16(),
                      {}) for _ in range(nsets)],
            "int8": [],
        }
        for _ in range(nsets):
            (ck, ks), (cv, vs) = (cs.int8_cache(torch, tg, gen, 4, max_len, 8, 128)
                                  for _ in range(2))
            sets["int8"].append((ck, cv, dict(k_scale=ks, v_scale=vs)))
        for kind, caches in sets.items():
            picked = chosen(4, 8, 1, tfa._sm_count(q.device), kind == "int8")
            for w in (int(x) for x in args.wants.split(",")):
                tfa.decode_want = lambda *a, w=w: w
                it = {"i": 0}

                def call():
                    it["i"] = (it["i"] + 1) % nsets
                    ck, cv, kw = caches[it["i"]]
                    tfa.flash_decode_attention(q, ck, cv, live - 1, **kw)

                runs = [kernel_ms(torch, call) for _ in range(2)]
                tfa.decode_want = chosen
                print(f"decode_sweep live={live} {kind} want={w}"
                      f"{' (the wrapper picks this)' if w == picked else ''}: "
                      + "; ".join(f"total {sum(r.values()):.4f} ms ("
                                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(r.items())) + ")"
                                  for r in runs)
                      + f" [{card}]", flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
