"""QoS classes on the serving scheduler: tiers, budgets, preemption.

Counterpart of ``torchgpipe_tpu/serving/qos.py`` (the same Python).
Three mechanisms, all host-side policy over the existing machinery (the
captured programs never see a tier — QoS changes WHICH request occupies
a slot, never a shape):

* **Latency tiers** — every request carries a ``tier``
  (``interactive`` | ``standard`` | ``batch``).  Admission is ordered
  by tier priority instead of pure FIFO: when slots are scarce an
  interactive request admits before a standard one ahead of it in the
  queue; within a tier, arrival order holds.  An all-``standard``
  workload admits exactly as before — FIFO is the degenerate case.
* **Per-tenant token budgets** — :class:`QosPolicy` accounts every
  emitted token against the request's ``tenant`` on a registry counter
  (``qos_tenant_tokens{tenant=...}``).  A tenant past its declared
  budget is DEMOTED to the batch tier — never silently dropped; its
  requests still run, they just stop outranking paying traffic.  The
  counter lives on the fleet's BASE registry, so a tenant's spend
  survives its requests migrating replicas (drain, failover,
  autoscale) — the series is keyed by tenant, not by replica.
* **Preemptible background work** — a batch-tier request yields its
  slot under pressure: when higher-priority work is queued and no slot
  is free, the engine evicts one preemptible active request through
  the SAME snapshot/teacher-force path drain uses
  (:meth:`Engine.preempt_request`) and immediately requeues it.
  Greedy decode is prefix-deterministic, so the resumed stream is
  BITWISE what an unpreempted run emits (``tests/test_torch_qos.py``).

One :class:`QosPolicy` instance serves a whole fleet of engines (the
replicas behind a ``fleet.Router``): build it on
the SHARED base registry and pass the same object to every engine (a
per-replica labeled view would split a tenant's spend into per-replica
series that cannot be summed back by the read path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from torchgpipe_tpu_torch.obs.registry import MetricsRegistry

# Tier names in priority order: admission prefers earlier tiers.
TIERS: Tuple[str, ...] = ("interactive", "standard", "batch")
TIER_PRIORITY = {name: i for i, name in enumerate(TIERS)}


def check_tier(tier: str) -> str:
    """Validate a tier name (didactic error over a silent default)."""
    if tier not in TIER_PRIORITY:
        raise ValueError(
            f"unknown QoS tier {tier!r} — declared tiers are {TIERS}"
        )
    return tier


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Declarative QoS policy knobs.

    ``tenant_budgets`` maps tenant → token budget (emitted tokens);
    a tenant absent from the map is unbudgeted.  ``preemptible_tiers``
    names the tiers that yield slots under pressure (batch only, by
    default — interactive/standard streams are never evicted for
    priority).  ``demote_tier`` is where over-budget tenants land.
    """

    tenant_budgets: Mapping[str, int] = dataclasses.field(
        default_factory=dict
    )
    preemptible_tiers: Tuple[str, ...] = ("batch",)
    demote_tier: str = "batch"

    def __post_init__(self) -> None:
        check_tier(self.demote_tier)
        for t in self.preemptible_tiers:
            check_tier(t)
        for tenant, budget in self.tenant_budgets.items():
            if int(budget) < 1:
                raise ValueError(
                    f"tenant {tenant!r}: token budget must be >= 1, "
                    f"got {budget!r}"
                )


class QosPolicy:
    """Fleet-wide QoS accounting over one shared registry.

    Pass the SAME instance to every engine (``Engine(qos=policy)``) —
    the tenant-token counter is keyed by tenant alone, so spend follows
    the tenant across replicas and survives drain/failover migration.
    Reads never mint series (`spent` of an unseen tenant is 0.0 with no
    registry write — the phantom-series contract).
    """

    def __init__(
        self,
        config: Optional[QosConfig] = None,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config or QosConfig()
        self.registry = registry or MetricsRegistry()
        self._c_tokens = self.registry.counter(
            "qos_tenant_tokens", labels=("tenant",),
            help="tokens emitted per tenant (budget accounting)",
        )
        self._c_demotions = self.registry.counter(
            "qos_demotions_total", labels=("tenant",),
            help="admissions demoted to the batch tier (over budget)",
        )
        self._c_preemptions = self.registry.counter(
            "qos_preemptions_total",
            help="preemptible requests evicted for higher-tier work",
        )

    # -------------------------------------------------------------- #
    # tenant budget accounting                                       #
    # -------------------------------------------------------------- #

    def spend(self, tenant: Optional[str], n: int = 1) -> None:
        """Charge ``n`` emitted tokens to ``tenant`` (no-op when the
        request carries no tenant)."""
        if tenant is not None and n > 0:
            self._c_tokens.inc(n, tenant=tenant)

    def spent(self, tenant: Optional[str]) -> int:
        """Tokens charged to ``tenant`` so far (0 for unseen tenants —
        a pure read, mints no series)."""
        if tenant is None:
            return 0
        return int(self._c_tokens.value(tenant=tenant))

    def budget(self, tenant: Optional[str]) -> Optional[int]:
        if tenant is None:
            return None
        b = self.config.tenant_budgets.get(tenant)
        return None if b is None else int(b)

    def over_budget(self, tenant: Optional[str]) -> bool:
        b = self.budget(tenant)
        return b is not None and self.spent(tenant) >= b

    # -------------------------------------------------------------- #
    # tier resolution                                                #
    # -------------------------------------------------------------- #

    def effective_tier(self, tier: str, tenant: Optional[str]) -> str:
        """The tier admission actually uses: the declared one, demoted
        to ``demote_tier`` while the tenant is over budget.  Demotion
        never outranks the declared tier (a batch request stays batch)."""
        check_tier(tier)
        if self.over_budget(tenant):
            demoted = self.config.demote_tier
            if TIER_PRIORITY[demoted] > TIER_PRIORITY[tier]:
                return demoted
        return tier

    def note_demotion(self, tenant: Optional[str]) -> None:
        self._c_demotions.inc(tenant="" if tenant is None else tenant)

    def note_preemption(self) -> None:
        self._c_preemptions.inc()

    def preemptible(self, tier: str) -> bool:
        return tier in self.config.preemptible_tiers


__all__ = ["QosConfig", "QosPolicy", "TIERS", "TIER_PRIORITY", "check_tier"]
