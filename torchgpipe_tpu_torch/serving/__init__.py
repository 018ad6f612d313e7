"""Continuous-batching inference serving over the slot-masked decode step.

Counterpart of ``torchgpipe_tpu/serving``: Orca-style iteration-level
batching (OSDI '22) over a slot-pooled KV cache (the PagedAttention idea,
arXiv:2309.06180, specialised to one fixed-size page per request), with a
statically bounded set of programs regardless of request churn — on a
CUDA device, one captured CUDA graph per program.

    from torchgpipe_tpu_torch import serving
    eng = serving.Engine(cfg, model, num_slots=8, max_len=256)
    rid = eng.submit(prompt, max_new_tokens=64, eos_id=2,
                     on_token=lambda rid, t: print(t))
    eng.run()
    tokens = eng.result(rid)

Modules: :mod:`~torchgpipe_tpu_torch.serving.cache_pool` (slot banks +
free-list), :mod:`~torchgpipe_tpu_torch.serving.scheduler` (admission /
chunked-prefill interleave / eviction),
:mod:`~torchgpipe_tpu_torch.serving.engine` (the program loop, streaming,
drain/resume), :mod:`~torchgpipe_tpu_torch.serving.metrics` (TTFT / TPOT
/ occupancy / throughput), :mod:`~torchgpipe_tpu_torch.serving.qos`
(tiers, tenant budgets, preemption).
"""

from __future__ import annotations

from torchgpipe_tpu_torch.serving.cache_pool import CachePool
from torchgpipe_tpu_torch.serving.engine import Engine
from torchgpipe_tpu_torch.serving.metrics import RequestTimes, ServingMetrics
from torchgpipe_tpu_torch.serving.qos import QosConfig, QosPolicy
from torchgpipe_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = [
    "CachePool",
    "Engine",
    "QosConfig",
    "QosPolicy",
    "Request",
    "RequestTimes",
    "Scheduler",
    "ServingMetrics",
]
