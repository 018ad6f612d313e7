"""SLO-priced fleet autoscaler: replica count as a control loop.

Counterpart of ``torchgpipe_tpu/fleet/autoscaler.py``.  The
:class:`~torchgpipe_tpu_torch.fleet.router.Router` owns every MECHANISM
an elastic fleet needs — ``drain_replica`` parks a replica without
dropping an in-flight request, ``Engine.resume_serving`` un-parks one
with its captured programs and KV pool intact, and the SLO layer
(:class:`~torchgpipe_tpu_torch.obs.slo.SloMonitor`) measures burn.
:class:`Autoscaler` adds the POLICY:

* **Pricing.**  Desired replica count comes from Little's law: arrival
  rate λ over a sliding window × the declared per-request
  ``service_time_s``, divided by one replica's slot capacity, padded by
  ``headroom``.  (The reference can also price off a measured
  ``CostModel``; that path, ``cost_model=``/``pipe=``, belongs to the
  static-analysis and tuning layer, ROADMAP.md queue A item 5.6, and is
  refused here.)
* **SLO burn override.**  While a burn-rate alert is firing, desired is
  bumped one above the active count regardless of λ.
* **Hysteresis + cooldown.**  A resize needs ``hold_ticks``
  CONSECUTIVE ticks agreeing on the same direction, and at most one
  resize per ``cooldown_s``.
* **Bounds.**  Never above the replicas the router has, never below
  ``max(min_replicas, router.slo_min_in_rotation)``.
* **Per-role pools.**  On a phase-disaggregated fleet every term goes
  per pool: the prefill pool is priced by the ADMISSION window, the
  decode pool by the router's ``fleet_migrations`` rate, and SLO-burn
  alerts bump only the pool their objective's ``phase`` blames.

Scale-down reuses :meth:`Router.drain_replica` verbatim; scale-up clears
the parked replica's ``draining`` flag and re-opens admissions.  Every
decision lands on the registry (``autoscaler_desired_replicas`` /
``autoscaler_active_replicas`` gauges,
``autoscaler_resizes_total{direction}``) and the router's flight
recorder (``autoscale`` events).
"""

from __future__ import annotations

import collections
import math
from typing import Any, Deque, List, Mapping, Optional, Tuple

from torchgpipe_tpu_torch.fleet.router import Router
from torchgpipe_tpu_torch.models.transformer import not_ported


class Autoscaler:
    """Price replica count against measured cost + arrival rate.

    Drive it like the router's SLO loop: call :meth:`observe_arrival`
    as requests land (the trace-replay loop does this naturally) and
    :meth:`tick` once per router step.  ``tick`` returns the action it
    took (``"up:<replica>"`` / ``"down:<replica>"``) or ``None``.

    ``service_time_s`` prices a request; ``cost_model=`` and ``pipe=``
    (measured pricing) raise ``NotImplementedError`` naming ROADMAP.md
    queue A item 5.6.  ``tokens_per_request`` (default 8) is taken and
    stored as ``int`` in the reference's place; in the reference only the
    ``CostModel`` price reads it (the decode tokens a request costs), so
    nothing here reads it until that pricing is ported (item 5.6).
    """

    def __init__(
        self,
        router: Router,
        *,
        slo: Optional[Any] = None,
        cost_model: Optional[Any] = None,
        pipe: Optional[Any] = None,
        service_time_s: Optional[float] = None,
        tokens_per_request: int = 8,
        window_s: float = 1.0,
        headroom: float = 1.3,
        min_replicas: int = 1,
        max_replicas: Optional[int] = None,
        hold_ticks: int = 3,
        cooldown_s: float = 0.0,
        recorder: Optional[Any] = None,
        tier_weights: Optional[Mapping[str, float]] = None,
    ) -> None:
        if cost_model is not None or pipe is not None:
            raise not_ported(
                "the autoscaler's measured CostModel pricing "
                "(cost_model=, pipe=)", "5.6"
            )
        if service_time_s is None:
            raise ValueError(
                "the autoscaler needs a price: pass service_time_s= "
                "(declared seconds of replica time per request)"
            )
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if headroom < 1.0:
            raise ValueError(
                "headroom < 1 plans to miss the SLO it protects"
            )
        if hold_ticks < 1:
            raise ValueError("hold_ticks must be >= 1")
        self.router = router
        self.slo = slo
        self.service_time_s = service_time_s
        self.tokens_per_request = int(tokens_per_request)
        self.window_s = float(window_s)
        self.headroom = float(headroom)
        n_total = len(router.replicas)
        self.min_replicas = max(
            int(min_replicas), int(router.slo_min_in_rotation)
        )
        self.max_replicas = min(
            int(max_replicas) if max_replicas is not None else n_total,
            n_total,
        )
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"min_replicas {self.min_replicas} (after the "
                f"slo_min_in_rotation floor) exceeds max_replicas "
                f"{self.max_replicas}"
            )
        self.hold_ticks = int(hold_ticks)
        self.cooldown_s = float(cooldown_s)
        self.recorder = (
            recorder if recorder is not None else router.recorder
        )
        self.parked: List[str] = []
        self._clock = router._clock
        # QoS-tier demand pricing (serving/qos.py): each arrival enters
        # the window with its tier's weight, so an interactive-heavy
        # mix — which must hold a tighter latency SLO — prices more
        # replicas than the same λ of batch traffic.  Unweighted (every
        # tier 1.0) without a map; unknown tiers weigh 1.0.
        self.tier_weights = (
            dict(tier_weights) if tier_weights is not None else None
        )
        if self.tier_weights is not None:
            for w in self.tier_weights.values():
                if float(w) <= 0.0:
                    raise ValueError("tier weights must be > 0")
        self._arrivals: Deque[Tuple[float, float]] = collections.deque()
        # Phase-disaggregated fleets are priced per pool; a unified
        # fleet is the degenerate single-pool case of the same loop.
        self.disaggregated = bool(getattr(router, "disaggregated", False))
        self.roles = dict(getattr(router, "roles", {})) or {
            name: "unified" for name in router.replicas
        }
        self.role_order = (
            ("prefill", "decode") if self.disaggregated else ("unified",)
        )
        for role in self.role_order:
            n_pool = sum(1 for v in self.roles.values() if v == role)
            if self.disaggregated and self.min_replicas > n_pool:
                raise ValueError(
                    f"min_replicas {self.min_replicas} (after the "
                    f"slo_min_in_rotation floor) exceeds the {role} "
                    f"pool's {n_pool} replicas"
                )
        # Per-role hysteresis state: [pending direction, agreeing ticks].
        self._trend = {role: [0, 0] for role in self.role_order}
        # Decode arrivals = migration handoffs; rate is read as counter
        # deltas over the window, sampled each tick: (t, count) pairs.
        self._migrations: Deque[tuple] = collections.deque([(
            -math.inf,
            float(getattr(router, "_c_migrations", None).value())
            if getattr(router, "_c_migrations", None) is not None else 0.0,
        )])
        self._last_resize_at: Optional[float] = None
        registry = router.registry
        self._g_desired = registry.gauge(
            "autoscaler_desired_replicas",
            help="replica count the pricing asks for (pre-damping)",
        )
        self._g_active = registry.gauge(
            "autoscaler_active_replicas",
            help="replicas currently serving (not parked/degraded/dead)",
        )
        self._c_resizes = registry.counter(
            "autoscaler_resizes_total",
            help="park/unpark actions the autoscaler performed",
            labels=("direction",),
        )
        self._g_active.set(float(self._active()))

    # ------------------------------------------------------------------ #
    # measurement                                                        #
    # ------------------------------------------------------------------ #

    def observe_arrival(
        self, n: int = 1, now: Optional[float] = None,
        tier: Optional[str] = None,
    ) -> None:
        """Record ``n`` request arrivals (at ``now``, default the
        router's clock) into the sliding rate window.  With
        ``tier_weights`` configured, each arrival carries its tier's
        weight into the demand math (``tier=None`` weighs 1.0)."""
        t = self._clock() if now is None else float(now)
        w = 1.0
        if self.tier_weights is not None and tier is not None:
            w = float(self.tier_weights.get(tier, 1.0))
        for _ in range(max(int(n), 0)):
            self._arrivals.append((t, w))

    def arrival_rate(self, now: Optional[float] = None) -> float:
        """WEIGHTED arrivals per second over the trailing ``window_s``
        (plain arrivals/s when no tier weights are configured)."""
        t = self._clock() if now is None else float(now)
        cutoff = t - self.window_s
        while self._arrivals and self._arrivals[0][0] < cutoff:
            self._arrivals.popleft()
        return sum(w for _, w in self._arrivals) / self.window_s

    def migration_rate(self, now: Optional[float] = None) -> float:
        """Prefill→decode handoffs per second over the trailing
        ``window_s`` — the decode pool's OWN arrival rate, sampled as
        deltas of the router's ``fleet_migrations`` counter.  Nobody
        calls :meth:`observe_arrival` for migrations; the router's
        counter is the ground truth, so the decode pool cannot be
        mis-priced by a caller forgetting to report handoffs."""
        counter = getattr(self.router, "_c_migrations", None)
        if counter is None:
            return 0.0
        t = self._clock() if now is None else float(now)
        self._migrations.append((t, float(counter.value())))
        cutoff = t - self.window_s
        # Keep one sample at/before the cutoff as the window baseline.
        while len(self._migrations) >= 2 and self._migrations[1][0] <= cutoff:
            self._migrations.popleft()
        return max(
            0.0,
            (self._migrations[-1][1] - self._migrations[0][1])
            / self.window_s,
        )

    def request_service_time_s(self) -> float:
        """Seconds of replica time one request costs: the declared
        ``service_time_s``."""
        return float(self.service_time_s)

    # ------------------------------------------------------------------ #
    # policy                                                             #
    # ------------------------------------------------------------------ #

    def _active(self, role: Optional[str] = None) -> int:
        return sum(
            1 for name, r in self.router.replicas.items()
            if r.in_rotation
            and (role is None or self.roles.get(name) == role)
        )

    def _pool_size(self, role: str) -> int:
        return sum(1 for v in self.roles.values() if v == role)

    def _slots_per_replica(self, role: Optional[str] = None) -> int:
        for name, rep in self.router.replicas.items():
            if role is not None and self.roles.get(name) != role:
                continue
            pool = getattr(rep.engine, "pool", None)
            slots = getattr(pool, "num_slots", None)
            if slots:
                return int(slots)
        return 1

    def _alert_blames(self, role: str) -> bool:
        """Whether any firing SLO alert's objective blames ``role`` —
        phase-less objectives blame every pool (and a unified fleet's
        single pool absorbs everything)."""
        alerts = self.slo.active_alerts()
        if not alerts:
            return False
        if not self.disaggregated:
            return True
        phase_of = {
            o.name: getattr(o, "phase", None)
            for o in getattr(self.slo, "objectives", ())
        }
        for alert in alerts:
            name = alert[0] if isinstance(alert, tuple) else alert
            if phase_of.get(name) in (None, role):
                return True
        return False

    def desired_replicas(
        self, now: Optional[float] = None, role: Optional[str] = None,
    ) -> int:
        """The UNDAMPED verdict this tick: Little's-law demand, bumped
        above active while an SLO alert burns, clamped to bounds.  On a
        disaggregated fleet pass ``role`` — the prefill pool is priced
        by the admission window, the decode pool by the migration rate
        (omitting it sums both pools' verdicts, the fleet total)."""
        if role is None and self.disaggregated:
            return sum(
                self.desired_replicas(now, r) for r in self.role_order
            )
        lam = (
            self.migration_rate(now) if role == "decode"
            else self.arrival_rate(now)
        )
        demand = lam * self.request_service_time_s() * self.headroom
        want = max(
            self.min_replicas,
            math.ceil(demand / self._slots_per_replica(role) - 1e-9),
        )
        if self.slo is not None and self._alert_blames(role or "unified"):
            want = max(want, self._active(role) + 1)
        cap = (
            min(self.max_replicas, self._pool_size(role))
            if role is not None and self.disaggregated
            else self.max_replicas
        )
        return min(max(want, self.min_replicas), cap)

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One policy evaluation: damp each pool's instantaneous
        desired count through hysteresis + cooldown, then park or
        un-park at most ONE replica fleet-wide.  Pools are visited in
        fixed order (prefill first) so a tick where both pools want to
        move is deterministic.  Returns the action taken or ``None``."""
        t = self._clock() if now is None else float(now)
        total_desired = 0
        action: Optional[str] = None
        for role in self.role_order:
            pool = None if not self.disaggregated else role
            desired = self.desired_replicas(t, pool)
            active = self._active(pool)
            total_desired += desired
            trend = self._trend[role]
            direction = (desired > active) - (desired < active)
            if direction == 0:
                trend[0] = trend[1] = 0
                continue
            if direction == trend[0]:
                trend[1] += 1
            else:
                trend[0], trend[1] = direction, 1
            if action is not None or trend[1] < self.hold_ticks:
                continue
            if (
                self._last_resize_at is not None
                and t - self._last_resize_at < self.cooldown_s
            ):
                continue
            action = (
                self._scale_up(pool) if direction > 0
                else self._scale_down(pool)
            )
            if action is not None:
                self._last_resize_at = t
                trend[0] = trend[1] = 0
        self._g_desired.set(float(total_desired))
        self._g_active.set(float(self._active()))
        return action

    # ------------------------------------------------------------------ #
    # actuation                                                          #
    # ------------------------------------------------------------------ #

    def _record(self, detail: str) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record("autoscale", detail=detail)
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass

    def _scale_down(self, role: Optional[str] = None) -> Optional[str]:
        # The floor is PER POOL: a starved decode pool cannot be robbed
        # to feed prefill, however hard the admission window burns.
        if self._active(role) <= self.min_replicas:
            return None
        # Deterministic victim: the last in-rotation replica by name —
        # scale-up un-parks in the reverse order, so the fleet breathes
        # through the same replicas and their warm captured programs.
        candidates = sorted(
            name for name, rep in self.router.replicas.items()
            if rep.in_rotation
            and (role is None or self.roles.get(name) == role)
        )
        victim = candidates[-1]
        moved = self.router.drain_replica(victim)
        self.parked.append(victim)
        self._c_resizes.inc(direction="down")
        pool = "" if role is None else f" [{role}]"
        self._record(
            f"down {victim}{pool}: {len(moved)} in-flight moved, "
            f"{self._active()} active"
        )
        return f"down:{victim}"

    def _scale_up(self, role: Optional[str] = None) -> Optional[str]:
        cap = (
            min(self.max_replicas, self._pool_size(role))
            if role is not None else self.max_replicas
        )
        if self._active(role) >= cap:
            return None
        # LIFO within the pool: the most recently parked (warmest)
        # compatible replica returns first.
        name = next(
            (n for n in reversed(self.parked)
             if role is None or self.roles.get(n) == role),
            None,
        )
        if name is None:
            return None
        self.parked.remove(name)
        rep = self.router.replicas[name]
        rep.draining = False
        rep.engine.resume_serving()
        self._c_resizes.inc(direction="up")
        pool = "" if role is None else f" [{role}]"
        self._record(f"up {name}{pool}: {self._active()} active")
        return f"up:{name}"


__all__ = ["Autoscaler"]
