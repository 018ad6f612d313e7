"""Live train->serve weight rollout: version the fleet, never drop it.

Counterpart of ``torchgpipe_tpu/fleet/rollout.py``.  The serving fleet
picks up new weights without a restart, a recapture or a dropped
request:

* **The programs read the weights in place.**  Every captured serving
  program reads the engine's parameter tensors, so writing a same-shape
  version into them changes no program — :meth:`Engine.swap_params` is
  a copy plus a version bump.  :func:`~torchgpipe_tpu_torch.analysis.
  serving.certify_swap` certifies the signature at publish time; a
  re-shaped model is REFUSED and must cold-start a fresh engine.
* **The drain path moves requests without losing tokens.**  A rolling
  update is the router's drain with a swap in the middle: drain ->
  ``swap_params`` -> readmit, one replica per tick; the fleet serves
  version N and N+1 concurrently mid-rollout and every request finishes
  somewhere.

:class:`RolloutController` adds the policy (observe ->
at-most-one-action-per-tick): :meth:`publish` registers a new version
(monotonic, ``certify_swap``-gated); :meth:`tick` first runs the HEALTH
GATE — an SLO burn-rate alert blaming a replica already on the new
version triggers :meth:`rollback` — then at most one
drain -> swap -> readmit; the baseline advances only when EVERY alive
replica serves the target.

Two differences from the reference follow from in-place weights:

* the rollback floor keeps its own copy of every parameter a publish
  would overwrite (the reference keeps the old arrays, which nothing
  overwrites);
* replicas that SHARE one model's parameter tensors change version
  together: a visit drains, swaps and readmits every replica of the
  group at once (a swap into shared tensors is seen by all of them).
  Replicas on separate weights visit one per tick, as in the reference.

Every swap and rollback lands on the registry
(``rollout_version{replica=...}``, ``rollout_target_version``,
``rollout_swaps_total``, ``rollout_rollbacks_total``) and the flight
recorder (``rollout`` events); each request's ``req_submit`` /
``req_finish`` spans carry ``version=``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torchgpipe_tpu_torch.fleet.router import Router
from torchgpipe_tpu_torch.serving.engine import Engine, _flat, _ParamLayer


def publish(controller: "RolloutController", params: Any,
            version: int) -> int:
    """Module-level convenience: the train loop's one-liner
    (``rollout.publish(ctl, params, v)``) — see
    :meth:`RolloutController.publish`."""
    return controller.publish(params, version)


class RolloutController:
    """Rolling weight updates over a :class:`Router`'s fleet.

    Drive it like the autoscaler: :meth:`publish` when training emits
    a candidate, :meth:`tick` once per router step.  ``tick`` returns
    the action it took (``"swap:<replica>:v<version>"`` /
    ``"rollback:v<version>"`` / ``"complete:v<version>"``) or ``None``.

    ``slo`` defaults to the router's own monitor — the same burn-rate
    verdicts that degrade a replica also veto its new weights.  The
    health gate only fires while a rollout is IN FLIGHT (target !=
    baseline) and only on replicas already at the target version, so a
    pre-existing breach elsewhere cannot mis-blame fresh weights.
    """

    def __init__(
        self,
        router: Router,
        *,
        slo: Optional[Any] = None,
        recorder: Optional[Any] = None,
    ) -> None:
        self.router = router
        self.slo = slo if slo is not None else router.slo
        self.recorder = (
            recorder if recorder is not None else router.recorder
        )
        # Version 0 (or whatever the engines booted at) is the rollback
        # floor: capture the currently-served params so `rollback` can
        # always swap BACK, not just stop swapping forward.
        first = next(iter(router.replicas.values())).engine
        self.baseline = int(getattr(first, "version", 0))
        self.target = self.baseline
        self.published: Dict[int, Any] = {
            self.baseline: first.serving_layers()
        }
        registry = router.registry
        self._g_version = registry.gauge(
            "rollout_version",
            help="param version each replica currently serves",
            labels=("replica",),
        )
        self._g_target = registry.gauge(
            "rollout_target_version",
            help="param version the rollout is converging the fleet to",
        )
        self._c_swaps = registry.counter(
            "rollout_swaps_total",
            help="drain→swap_params→readmit actions performed",
            labels=("replica",),
        )
        self._c_rollbacks = registry.counter(
            "rollout_rollbacks_total",
            help="rollouts reverted to the baseline version",
        )
        for name, rep in router.replicas.items():
            self._g_version.set(
                float(getattr(rep.engine, "version", 0)), replica=name
            )
        self._g_target.set(float(self.target))

    # ------------------------------------------------------------------ #
    # publish / rollback                                                 #
    # ------------------------------------------------------------------ #

    def _record(self, detail: str) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record("rollout", detail=detail)
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass

    def publish(self, params: Any, version: int) -> int:
        """Register param ``version`` as the fleet's new target.

        Versions are monotonic (publishing at-or-below the current
        target raises — a rollback is :meth:`rollback`, not a
        re-publish), and the model is certified against a live
        engine's signature BEFORE anything changes: a shape/dtype
        mismatch raises ``ValueError`` with the first mismatching leaf
        named, and the fleet keeps serving exactly as before.  Returns
        the number of replicas the rollout will visit."""
        version = int(version)
        if version <= self.target:
            raise ValueError(
                f"published version {version} is not above the current "
                f"target {self.target} — versions are monotonic "
                "(use rollback() to go backward)"
            )
        from torchgpipe_tpu_torch.analysis.diagnostics import Severity
        from torchgpipe_tpu_torch.analysis.serving import certify_swap

        engine = next(
            rep.engine for rep in self.router.replicas.values()
            if rep.alive
        )
        findings = certify_swap(engine, params)
        errors = [f for f in findings if f.severity >= Severity.ERROR]
        if errors:
            raise ValueError(
                f"publish refused for version {version}: "
                + errors[0].message
            )
        self._keep_baseline(params)
        self.published[version] = params
        self.target = version
        self._g_target.set(float(version))
        n = sum(1 for r in self.router.replicas.values() if r.alive)
        self._record(f"publish v{version}: {n} replica(s) to visit")
        return n

    def _keep_baseline(self, params: Any) -> None:
        """Clone, in the baseline version, every tensor that is a live
        engine parameter and that ``params`` would overwrite: the swap
        writes in place, and the rollback floor must survive it."""
        live = {
            id(t)
            for rep in self.router.replicas.values()
            for layer in rep.engine.serving_layers()
            for _, t in _flat(layer.params())
        }
        kept = []
        for old, new in zip(self.published[self.baseline], list(params)):
            pairs = zip(_flat(old.params()), _flat(new.params()))
            with torch.no_grad():
                flat = {
                    k: (t.clone() if id(t) in live and n is not t else t)
                    for (k, t), (_, n) in pairs
                }
            kept.append(_ParamLayer(_unflat(flat)))
        self.published[self.baseline] = kept

    def rollback(self, reason: str = "requested") -> str:
        """Revert the fleet's target to the baseline version.  The
        actual swaps happen one per :meth:`tick` through the same
        drain→swap→readmit path (a rollback IS a rollout, aimed
        backward); the bad version's params stay registered for the
        postmortem but will never be targeted again."""
        bad = self.target
        self.target = self.baseline
        self._g_target.set(float(self.target))
        self._c_rollbacks.inc()
        self._record(
            f"rollback v{bad}->v{self.baseline}: {reason}"
        )
        return f"rollback:v{self.baseline}"

    # ------------------------------------------------------------------ #
    # the control loop                                                   #
    # ------------------------------------------------------------------ #

    def _version_of(self, name: str) -> int:
        return int(getattr(self.router.replicas[name].engine,
                           "version", 0))

    def versions(self) -> Dict[str, int]:
        """Param version per alive replica — the mid-rollout witness
        that the fleet serves two versions concurrently."""
        return {
            name: self._version_of(name)
            for name, rep in self.router.replicas.items()
            if rep.alive
        }

    def _pending(self) -> List[str]:
        """Alive replicas not yet at the target version, in name order
        (deterministic visit order).  Degraded/draining replicas are
        INCLUDED: a rollback must reach the very replica the SLO layer
        evicted, or it re-burns the moment it is readmitted."""
        return sorted(
            name for name, rep in self.router.replicas.items()
            if rep.alive and self._version_of(name) != self.target
        )

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One rollout action: health-gate first, then at most one
        replica swap, then (once converged) baseline finalization."""
        del now  # signature symmetry with Autoscaler.tick
        # 1) Health gate — only while a rollout is in flight, only on
        #    replicas ALREADY at the target: their burn is the new
        #    weights' burn.  One rollback per publish; the swaps back
        #    to baseline then proceed one per tick below.
        if self.slo is not None and self.target != self.baseline:
            if self.slo is not self.router.slo:
                self.slo.tick()
            breaching = set(self.slo.breaching(split_by="replica"))
            burned = sorted(
                name for name in breaching
                if name in self.router.replicas
                and self._version_of(name) == self.target
            )
            if burned:
                return self.rollback(
                    f"slo burn on updated replica(s) "
                    f"{', '.join(burned)}"
                )
        # 2) At most one swap.
        pending = self._pending()
        if pending:
            return self._swap(pending[0])
        # 3) Converged: advance the baseline (finalize) exactly once.
        if self.target != self.baseline:
            old = self.baseline
            self.baseline = self.target
            self._record(f"complete v{old}->v{self.target}")
            return f"complete:v{self.target}"
        return None

    def _sharers(self, name: str) -> List[str]:
        """``name`` and every alive replica whose engine serves the same
        parameter tensors (in name order)."""
        key = self.router.replicas[name].engine.weights_key()
        return sorted(
            n for n, rep in self.router.replicas.items()
            if rep.alive and rep.engine.weights_key() == key
        )

    def _swap(self, name: str) -> str:
        """Drain -> :meth:`Engine.swap_params` -> readmit, for one
        replica (and the replicas sharing its weights).  The drain is the
        router's own (same snapshot schema, same checkpoint hooks); the
        replicas re-enter rotation BEFORE the drained requests resubmit,
        so even a single-replica fleet rolls with zero dropped requests
        (the requests simply resume on the freshly-swapped replica
        itself)."""
        group = self._sharers(name)
        target = self.target
        snapshots = []
        for n in group:
            rep = self.router.replicas[n]
            was_draining = rep.draining
            rep.draining = True
            self.router._router_drains.add(n)
            try:
                snapshots.append((rep, was_draining, rep.engine.drain()))
            finally:
                self.router._router_drains.discard(n)
        kwargs: List[Dict[str, Any]] = []
        for rep, was_draining, snapshot in snapshots:
            rep.engine.swap_params(self.published[target], target)
            rep.draining = was_draining
            rep.engine.resume_serving()
            self._g_version.set(float(target), replica=rep.name)
            self._c_swaps.inc(replica=rep.name)
            kwargs += Engine.restore_requests(snapshot)
        if kwargs:
            self.router._resubmit(kwargs)
        self._record(
            f"swap {'+'.join(group)} -> v{target} "
            f"({len(kwargs)} in-flight moved)"
        )
        return f"swap:{name}:v{target}"


def _unflat(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Invert :func:`~torchgpipe_tpu_torch.serving.engine._flat`: ``a.b``
    paths back to nested dicts."""
    out: Dict[str, Any] = {}
    for path, t in flat.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


__all__ = ["RolloutController", "publish"]
