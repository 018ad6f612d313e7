"""Fleet serving: the layer above one engine.

Counterpart of ``torchgpipe_tpu/fleet``.  :mod:`torchgpipe_tpu_torch.
serving` ends at ONE continuous-batching engine; this package puts N of
them behind one ``submit()``:

* :mod:`~torchgpipe_tpu_torch.fleet.router` — session affinity,
  power-of-two-choices on the shared :class:`~torchgpipe_tpu_torch.obs.
  MetricsRegistry` series, drain-aware failover through
  ``Engine.restore_requests``, the SLO observe -> act loop;
* :mod:`~torchgpipe_tpu_torch.fleet.prefix_cache` — a radix trie over
  the :class:`~torchgpipe_tpu_torch.serving.cache_pool.CachePool`
  refcounts: requests sharing a system prompt reuse KV rows through one
  captured ``prefix_copy`` program;
* :mod:`~torchgpipe_tpu_torch.fleet.migration` — the prefill -> decode
  handoff of phase-disaggregated serving (one captured
  ``migrate_ingest`` program);
* :mod:`~torchgpipe_tpu_torch.fleet.speculative` — a draft model over
  the same slot pool, verified through the engine's own prefill
  program;
* :mod:`~torchgpipe_tpu_torch.fleet.autoscaler` — replica count as a
  control loop (Little's law on a declared service time, SLO-burn
  override, hysteresis, cooldown);
* :mod:`~torchgpipe_tpu_torch.fleet.rollout` — rolling weight updates
  (drain -> ``swap_params`` -> readmit, health-gated rollback);
* :mod:`~torchgpipe_tpu_torch.fleet.trace` — seeded synthetic traces
  (ragged, bursty, shared-prefix tenants), the reference's byte for byte.

    from torchgpipe_tpu_torch import fleet, obs, serving
    shared = obs.MetricsRegistry()
    router = fleet.Router({
        name: serving.Engine(cfg, model, num_slots=4, max_len=64,
                             registry=shared.labeled(replica=name),
                             device="cpu")
        for name in ("r0", "r1")
    }, registry=shared)
    rid = router.submit(prompt, 32, session="user-1")
    router.run()
    tokens = router.result(rid)

Replicas may serve one shared ``model`` (the engines read its
parameters in place).
"""

from __future__ import annotations

from torchgpipe_tpu_torch.fleet.autoscaler import Autoscaler
from torchgpipe_tpu_torch.fleet.migration import (
    MigrationError,
    migrate,
    stage_rows,
    validate_pools,
)
from torchgpipe_tpu_torch.fleet.prefix_cache import RadixPrefixCache
from torchgpipe_tpu_torch.fleet.rollout import RolloutController
from torchgpipe_tpu_torch.fleet.router import (
    Replica,
    ReplicaDied,
    Router,
    RouterRecord,
)
from torchgpipe_tpu_torch.fleet.speculative import SpeculativeEngine
from torchgpipe_tpu_torch.fleet.trace import (
    TraceConfig,
    TraceRequest,
    TraceStats,
    prefill_heavy_config,
    synthetic_trace,
    tenant_prefixes,
    trace_summary,
)

__all__ = [
    "Autoscaler",
    "MigrationError",
    "RadixPrefixCache",
    "Replica",
    "ReplicaDied",
    "RolloutController",
    "Router",
    "RouterRecord",
    "SpeculativeEngine",
    "TraceConfig",
    "TraceRequest",
    "TraceStats",
    "migrate",
    "prefill_heavy_config",
    "stage_rows",
    "synthetic_trace",
    "tenant_prefixes",
    "trace_summary",
    "validate_pools",
]
