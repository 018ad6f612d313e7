"""Replica router: session affinity, power-of-two-choices, failover.

Counterpart of ``torchgpipe_tpu/fleet/router.py`` (host-side Python,
near-verbatim).  One :class:`~torchgpipe_tpu_torch.serving.engine.
Engine` is one set of slots; the router puts N of them behind one
``submit()``:

* **Placement** — power of two choices (Mitzenmacher): sample two
  replicas from ``np.random.RandomState(seed)`` (the reference's draws,
  so routing decisions compare one for one), route to the less loaded.
  Load is read from the shared :class:`~torchgpipe_tpu_torch.obs.
  MetricsRegistry`: a ``fleet_occupancy{replica=...}`` gauge per replica,
  tie-broken on the per-replica ``serving_tpot_seconds`` p50.
  ``session=`` pins a conversation to its replica.
* **Failover** — a replica dying mid-generation does not lose its
  in-flight requests: a snapshot in the :meth:`Engine.drain` schema
  (the engine's own drain when it can still run, else rebuilt from the
  router's streamed-token records) feeds :meth:`Engine.
  restore_requests`, and the requests resume on a SURVIVING replica,
  teacher-forced to their last emitted token.  Greedy decode is
  prefix-deterministic, so the resumed streams are what an undisturbed
  run produces.
* **Drain-aware scale-down** — :meth:`drain_replica` is the same path
  minus the death.
* **Disaggregation** — a fleet of ``role="prefill"`` and
  ``role="decode"`` engines hands each completed prompt to the decode
  pool through :func:`~torchgpipe_tpu_torch.fleet.migration.migrate`.
* **SLO observe -> act** — with ``slo=`` (an :class:`~torchgpipe_tpu_torch.
  obs.slo.SloMonitor`) a breaching replica is degraded out of rotation
  and readmitted once clean, never below ``slo_min_in_rotation``.

Death in tests is cooperative and deterministic:
``resilience.faults.inject(die_at_step=(replica, step))`` makes the
router raise :class:`ReplicaDied` before that replica's engine step
``step``.  A :class:`~torchgpipe_tpu_torch.obs.flightrec.FlightRecorder`
wired in records every route/failover/drain as a flight event.

Replicas may share one model's parameters (the engines serve them in
place and never copy them); each keeps its own pool, programs and graph
memory pool, so a dead or drained replica frees nothing another's
graphs replay.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchgpipe_tpu_torch.fleet import migration as _migration
from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.serving.engine import Engine
from torchgpipe_tpu_torch.serving.scheduler import Request


class ReplicaDied(RuntimeError):
    """A replica stopped serving (fault injection or a real crash
    surfaced by its engine step)."""

    def __init__(self, name: str, reason: str = "died") -> None:
        super().__init__(f"replica {name!r} {reason}")
        self.name = name
        self.reason = reason


@dataclasses.dataclass
class RouterRecord:
    """The router's own view of one request — enough to rebuild a
    drain-schema snapshot even when the owning replica is gone."""

    rid: str
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    replica: str
    session: Optional[str] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    on_token: Optional[Callable[[str, int], None]] = None
    moves: int = 0          # failover/drain resubmissions
    # QoS identity (serving/qos.py): carried through every failover /
    # drain resubmission, so a request keeps its latency class and its
    # tenant keeps being charged wherever the request lands.  ``tier``
    # tracks the EFFECTIVE tier (an over-budget demotion sticks here
    # via the drain snapshot, so a migrated request does not silently
    # re-promote).
    tier: str = "standard"
    tenant: Optional[str] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens or (
            self.eos_id is not None
            and bool(self.tokens)
            and self.tokens[-1] == self.eos_id
        )


@dataclasses.dataclass
class Replica:
    """One engine behind the router.

    ``degraded`` is the SLO layer's verdict (:mod:`torchgpipe_tpu_torch.obs.
    slo`): the replica is alive and could serve, but its burn-rate
    alert is (or recently was) firing, so it is held out of
    power-of-two-choices rotation until its windows come back clean —
    the serving mirror of ``ReplanOnDrift`` acting on measured drift.
    """

    name: str
    engine: Engine
    alive: bool = True
    draining: bool = False
    degraded: bool = False

    @property
    def in_rotation(self) -> bool:
        return self.alive and not self.draining and not self.degraded


class Router:
    """Route requests over N engine replicas; see the module docstring.

    ``replicas`` maps name -> built :class:`Engine`.  For the shared-
    registry load series, build each engine with
    ``registry=shared.labeled(replica=name)`` (the
    :meth:`~torchgpipe_tpu_torch.obs.MetricsRegistry.labeled` view) and pass
    the same ``registry=shared`` here; without one the router keeps a
    private registry and the gauges are still maintained (just not
    shared with anything else).
    """

    def __init__(
        self,
        replicas: Dict[str, Engine],
        *,
        registry: Optional[Any] = None,
        seed: int = 0,
        session_affinity: bool = True,
        recorder: Optional[Any] = None,
        slo: Optional[Any] = None,
        slo_min_in_rotation: int = 1,
        slo_cooldown_s: float = 0.0,
    ) -> None:
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas: Dict[str, Replica] = {
            name: Replica(name=name, engine=eng)
            for name, eng in replicas.items()
        }
        # Phase roles (disaggregated serving): the fleet is either all
        # unified or a prefill pool + a decode pool — a mixed fleet
        # would make placement ambiguous (may a unified replica take
        # admissions? migrations?), so it is refused didactically.
        self.roles: Dict[str, str] = {
            name: getattr(eng, "role", "unified")
            for name, eng in replicas.items()
        }
        role_set = set(self.roles.values())
        self.disaggregated = role_set != {"unified"}
        if self.disaggregated:
            if "unified" in role_set:
                raise ValueError(
                    "mixed fleet: unified replicas cannot serve beside "
                    "prefill/decode pools — build the whole fleet one "
                    "way or the other"
                )
            if role_set != {"prefill", "decode"}:
                missing = {"prefill", "decode"} - role_set
                raise ValueError(
                    f"disaggregated fleet needs both pools; missing "
                    f"{sorted(missing)} — every admission prefills in "
                    "the prefill pool and decodes in the decode pool"
                )
        self.pools: Dict[str, List[str]] = {}
        for name, role in self.roles.items():
            self.pools.setdefault(role, []).append(name)
        if self.disaggregated:
            # Fail an incompatible fleet at BUILD time, not mid-handoff:
            # every prefill replica must be able to migrate to every
            # decode replica (same cfg/max_len/kv layout).
            for p in self.pools["prefill"]:
                for d in self.pools["decode"]:
                    _migration.validate_pools(
                        replicas[p], replicas[d]
                    )
        if registry is None:
            from torchgpipe_tpu_torch.obs.registry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self.recorder = recorder
        self.session_affinity = session_affinity
        self._rng = np.random.RandomState(seed)
        self._sessions: Dict[str, str] = {}
        self._records: Dict[str, RouterRecord] = {}
        self._rid_counter = 0
        # Per-replica productive engine steps, owned by the ROUTER —
        # the die_at_step fault hook keys on this, so death timing is
        # a property of the replica's own progress, independent of how
        # callers share ServingMetrics instances across replicas.
        self._replica_steps: Dict[str, int] = {
            name: 0 for name in replicas
        }
        # Replicas whose Engine.drain() the router itself is running
        # (failover / drain_replica): their drain hook must not fire a
        # SECOND resubmission on top of the one those paths do.
        self._router_drains: set = set()
        for name in replicas:
            self.replicas[name].engine.drain_hooks.append(
                self._drain_hook_for(name)
            )
        self._g_occupancy = registry.gauge(
            "fleet_occupancy",
            help="per-replica load: (active + queued) / slots",
            labels=("replica",),
        )
        self._c_routed = registry.counter(
            "fleet_routed_requests", help="requests placed",
            labels=("replica",),
        )
        self._c_failovers = registry.counter(
            "fleet_failovers", help="replica deaths failed over")
        self._c_moved = registry.counter(
            "fleet_moved_requests",
            help="in-flight requests resumed on another replica")
        self._c_migrations = registry.counter(
            "fleet_migrations",
            help="prefill→decode KV handoffs at prompt completion")
        # SLO observe->act wiring (obs.slo.SloMonitor): the router
        # ticks the monitor once per step() and acts on its verdicts —
        # a breaching replica is degraded out of rotation (in-flight
        # requests drained onto survivors), a clean one re-admitted
        # after the cooldown.  ``slo_min_in_rotation`` is the brake:
        # the SLO layer may never evict the last healthy replica
        # (degrading the whole fleet to protect latency serves nobody).
        self.slo = slo
        self.slo_min_in_rotation = int(slo_min_in_rotation)
        self.slo_cooldown_s = float(slo_cooldown_s)
        self._degraded_at: Dict[str, float] = {}
        self._clock: Callable[[], float] = getattr(
            registry, "clock", time.monotonic
        )
        self._c_slo_evicted = registry.counter(
            "fleet_slo_evictions",
            help="replicas degraded out of rotation by a burn-rate "
                 "alert", labels=("replica",),
        )
        self._c_slo_readmitted = registry.counter(
            "fleet_slo_readmissions",
            help="degraded replicas re-admitted after recovery",
            labels=("replica",),
        )
        self._g_degraded = registry.gauge(
            "fleet_degraded",
            help="1 while a replica is held out of rotation by the "
                 "SLO layer", labels=("replica",),
        )

    # ------------------------------------------------------------------ #
    # placement                                                          #
    # ------------------------------------------------------------------ #

    def _record_event(self, kind: str, detail: str = "",
                      rid: Optional[str] = None) -> None:
        if self.recorder is not None:
            self.recorder.record(kind, detail=detail, rid=rid)

    def _update_load_gauges(self) -> None:
        for rep in self.replicas.values():
            eng = rep.engine
            load = (
                len(eng.scheduler.active) + len(eng.scheduler.queue)
            ) / max(eng.pool.num_slots, 1)
            self._g_occupancy.set(load, replica=rep.name)

    def _load(self, name: str) -> Tuple[float, float]:
        """(occupancy gauge, TPOT p50 tiebreak) for one replica, read
        back from the registry series the router maintains — the same
        numbers a scrape sees."""
        occ = self._g_occupancy.value(replica=name)
        tpot = 0.0
        hist = self.registry.get("serving_tpot_seconds")
        if hist is not None and "replica" in getattr(
            hist, "label_names", ()
        ):
            got = hist.percentile(0.5, replica=name)
            tpot = got if got is not None else 0.0
        return float(occ), float(tpot)

    def pick_replica(
        self, session: Optional[str] = None,
        role: Optional[str] = None,
    ) -> str:
        """Power-of-two-choices over in-rotation replicas (session
        affinity first, when enabled and the pinned replica survives).

        In a disaggregated fleet the pick is POOL-scoped: admissions
        and resumptions default to the prefill pool (every entry into
        the fleet prefills first), and session pins bind only the
        DECODE placement — sessions re-prefill anywhere, but their
        multi-turn continuation rows live in one decode replica's pool,
        so a pin names a decode replica and prefill picks neither read
        nor write it."""
        if role is None and self.disaggregated:
            role = "prefill"
        pool = (
            [r.name for r in self.replicas.values()]
            if role is None else self.pools.get(role, [])
        )
        live = [n for n in pool if self.replicas[n].in_rotation]
        if not live:
            what = f"{role} replica" if role else "replica"
            raise ReplicaDied("<all>", f"no {what} in rotation")
        pin_applies = session is not None and (
            not self.disaggregated or role == "decode"
        )
        if (
            pin_applies
            and self.session_affinity
            and self._sessions.get(session) in live
        ):
            return self._sessions[session]
        self._update_load_gauges()
        if len(live) == 1:
            choice = live[0]
        else:
            i, j = self._rng.choice(len(live), size=2, replace=False)
            a, b = live[int(i)], live[int(j)]
            choice = min(a, b, key=self._load)
        if pin_applies:
            self._sessions[session] = choice
        return choice

    def _decode_target(self, session: Optional[str]) -> Optional[str]:
        """The decode replica to ingest one parked request: the
        session-pinned replica when its pin survives (waiting for ITS
        slot preserves multi-turn KV locality), else power-of-two-
        choices over decode replicas WITH a free slot (ingest cannot
        queue — the KV payload needs a slot now).  ``None`` means the
        pool is momentarily full: re-park and retry next step (decode
        progresses every step, so slots free up — no deadlock).
        Raises :class:`ReplicaDied` when no decode replica is in
        rotation at all."""
        live = [
            n for n in self.pools.get("decode", ())
            if self.replicas[n].in_rotation
        ]
        if not live:
            raise ReplicaDied("<all>", "no decode replica in rotation")
        if session is not None and self.session_affinity:
            pinned = self._sessions.get(session)
            if pinned in live:
                if self.replicas[pinned].engine.pool.num_free > 0:
                    return pinned
                return None      # wait for the pinned replica's slot
        free = [
            n for n in live
            if self.replicas[n].engine.pool.num_free > 0
        ]
        if not free:
            return None
        self._update_load_gauges()
        if len(free) == 1:
            choice = free[0]
        else:
            i, j = self._rng.choice(len(free), size=2, replace=False)
            choice = min(free[int(i)], free[int(j)], key=self._load)
        if session is not None and self.session_affinity:
            self._sessions[session] = choice
        return choice

    # ------------------------------------------------------------------ #
    # request API                                                        #
    # ------------------------------------------------------------------ #

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        rid: Optional[str] = None,
        session: Optional[str] = None,
        eos_id: Optional[int] = None,
        on_token: Optional[Callable[[str, int], None]] = None,
        tier: str = "standard",
        tenant: Optional[str] = None,
    ) -> str:
        """Route one request; returns its fleet-wide id."""
        if rid is None:
            self._rid_counter += 1
            rid = f"q{self._rid_counter}"
        if rid in self._records:
            raise ValueError(f"duplicate request id {rid!r}")
        prior_pin = (
            self._sessions.get(session) if session is not None else None
        )
        name = self.pick_replica(session)
        record = RouterRecord(
            rid=rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id,
            replica=name,
            session=session,
            on_token=on_token,
            tier=tier,
            tenant=tenant,
        )
        # Register only after the engine ACCEPTS the request — like
        # Engine.submit, validation failures (e.g. prompt + budget
        # over max_len) must leave no phantom record behind, and the
        # session pin pick_replica just wrote must roll back too.
        try:
            self._submit_to(name, record, record.prompt,
                            record.max_new_tokens, emitted_prefix=())
        except Exception:
            if session is not None:
                if prior_pin is None:
                    self._sessions.pop(session, None)
                else:
                    self._sessions[session] = prior_pin
            raise
        self._records[rid] = record
        return rid

    def _recording_on_token(
        self, record: RouterRecord
    ) -> Callable[[str, int], None]:
        """The engine-facing token callback for one record: accumulate
        into the router's own view (failover's source of truth), relay
        to the client.  Re-created per placement — submission AND
        migration ingest — always closing over the same record, so the
        token list is continuous across replicas."""

        def recording_on_token(rid: str, tok: int) -> None:
            record.tokens.append(int(tok))
            if record.on_token is not None:
                try:
                    record.on_token(rid, tok)
                except Exception as exc:  # noqa: BLE001
                    # A broken CLIENT callback (closed socket, consumer
                    # bug) must not read as a dead REPLICA: letting it
                    # escape Engine.step would make Router.step evict
                    # the replica, resubmit elsewhere WITH the same
                    # callback, and cascade until the whole fleet is
                    # out of rotation.  Stop streaming to that client;
                    # the record keeps accumulating the tokens.
                    record.on_token = None
                    self._record_event(
                        "callback_error",
                        detail=f"{rid}: {exc!r} — streaming stopped",
                        rid=rid,
                    )

        return recording_on_token

    def _submit_to(
        self,
        name: str,
        record: RouterRecord,
        prompt: np.ndarray,
        max_new_tokens: int,
        emitted_prefix: Sequence[int],
    ) -> None:
        record.replica = name
        self.replicas[name].engine.submit(
            prompt, max_new_tokens,
            rid=record.rid, eos_id=record.eos_id,
            on_token=self._recording_on_token(record),
            emitted_prefix=list(emitted_prefix),
            tier=record.tier, tenant=record.tenant,
        )
        self._c_routed.inc(replica=name)
        self._record_event(
            "route", detail=f"{record.rid}->{name}", rid=record.rid
        )

    def result(self, rid: str) -> np.ndarray:
        """Every token ``rid`` has produced, across any failovers."""
        return np.asarray(self._records[rid].tokens, np.int32)

    def status(self, rid: str) -> str:
        record = self._records[rid]
        eng = self.replicas[record.replica].engine
        if rid in eng._requests:
            return eng.status(rid)
        return "finished" if record.done else "queued"

    def cancel(self, rid: str) -> bool:
        record = self._records.get(rid)
        if record is None:
            return False
        return self.replicas[record.replica].engine.cancel(rid)

    # ------------------------------------------------------------------ #
    # the loop                                                           #
    # ------------------------------------------------------------------ #

    @property
    def idle(self) -> bool:
        return all(
            rep.engine.scheduler.idle
            and not rep.engine.migration_pending
            for rep in self.replicas.values()
            if rep.alive
        )

    def step(self) -> bool:
        """One iteration of every in-rotation replica (a dead replica's
        failover happens inline).  Returns False when nothing ran."""
        did = False
        for index, rep in enumerate(self.replicas.values()):
            if not rep.in_rotation:
                continue
            try:
                if faults.should_die(
                    index, self._replica_steps[rep.name]
                ):
                    raise ReplicaDied(rep.name, "fault injection")
                # The serving latency fault (slow_replica_at): sleep
                # BEFORE the engine step so every token this replica
                # emits is wall-clock late — the deterministic
                # straggler the SLO burn-rate gate drives.  Host-side
                # only; never touches a device buffer.
                delay = faults.replica_delay_s(index)
                # The rollout regression fault (bad_version_at): extra
                # latency WHILE this replica runs the bad param version
                # — activates the moment swap_params lands it, clears
                # the moment a rollback swaps it away.
                delay += faults.bad_version_delay_s(
                    index, int(getattr(rep.engine, "version", 0))
                )
                if delay > 0.0:
                    time.sleep(delay)
                if rep.engine._preempted():
                    # The replica's own drain request (SIGTERM via its
                    # PreemptionHandler, or request_drain()) — honored
                    # here because the router drives step(), never the
                    # engine's run() loop that normally checks this.
                    self.drain_replica(rep.name)
                    did = True
                    continue
                ran = rep.engine.step()
                if ran:
                    self._replica_steps[rep.name] += 1
                if self.disaggregated and rep.engine.role == "prefill":
                    # Hand freshly completed prompts to the decode pool
                    # right after this replica's step — a prompt never
                    # waits a full router round parked.
                    ran = self._drive_migrations(rep) or ran
                did = ran or did
            except Exception as death:  # noqa: BLE001 — any engine
                # error that escapes the engine's own transient-retry
                # guard means this replica is broken: evict it and
                # keep the fleet serving (the documented "real crash
                # surfaced by its engine step" contract).
                self.failover(rep.name, death)
                did = True
        self._slo_tick()
        return did

    def _drive_migrations(self, rep: Replica) -> bool:
        """Migrate every request ``rep`` (a prefill replica) has parked
        at prompt completion to the decode pool.  A request whose
        target pool is momentarily full — or whose session-pinned
        decode replica has no slot yet — re-parks and retries next
        step; a decode replica that FAILS mid-ingest is failed over
        (its own failover path) and the request re-parks, donor slot
        intact.  Returns True when at least one handoff completed."""
        eng = rep.engine
        if not eng.migration_pending:
            return False
        moved = False
        parked: List[Request] = []
        for req in eng.take_migration_ready():
            record = self._records.get(req.rid)
            session = record.session if record is not None else None
            try:
                target = self._decode_target(session)
            except ReplicaDied:
                # No decode replica in rotation: stay parked — the
                # pool coming back (readmit / scale-up) picks these up.
                self._record_event(
                    "migrate_wait",
                    detail=f"{req.rid}: no decode replica in rotation",
                    rid=req.rid,
                )
                parked.append(req)
                continue
            if target is None:          # decode pool full right now
                parked.append(req)
                continue
            try:
                _migration.migrate(
                    eng, self.replicas[target].engine, req,
                    on_token=(
                        self._recording_on_token(record)
                        if record is not None else None
                    ),
                )
            except Exception as death:  # noqa: BLE001 — the TARGET
                # broke mid-ingest (the donor slot is untouched: the
                # handoff frees it only after ingest succeeds).  Evict
                # the decode replica and re-park the request.
                self.failover(target, death)
                parked.append(req)
                continue
            if record is not None:
                record.replica = target
            self._c_migrations.inc()
            self._record_event(
                "kv_migrate",
                detail=(
                    f"{req.rid}: {rep.name}->{target} "
                    f"rows={req.prompt_len}"
                ),
                rid=req.rid,
            )
            moved = True
        eng._migration_ready.extend(parked)
        return moved

    def reset_replica_steps(self) -> None:
        """Re-zero the per-replica step clocks ``die_at_step`` keys on
        — e.g. between an untimed warmup pass and a timed fault region
        so a death step means "step
        within THIS region" rather than "since router construction"."""
        for name in self._replica_steps:
            self._replica_steps[name] = 0

    def run(self, max_steps: Optional[int] = None) -> str:
        """Step until idle or ``max_steps``; returns ``'idle'`` |
        ``'budget'``."""
        steps = 0
        while not self.idle:
            if not self.step():
                break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return "budget"
        return "idle"

    # ------------------------------------------------------------------ #
    # failover / drain                                                   #
    # ------------------------------------------------------------------ #

    def _drain_hook_for(self, name: str) -> Callable[[Dict[str, Any]], None]:
        """The :attr:`Engine.drain_hooks` callback the router registers
        on every replica: an ENGINE-initiated drain (e.g. the replica's
        preemption handler firing on SIGTERM) takes the replica out of
        rotation and resumes its in-flight requests on the survivors —
        without this, a self-draining replica would strand them.
        Router-initiated drains (failover / drain_replica) are guarded
        out: those paths consume the snapshot themselves."""

        def hook(snapshot: Dict[str, Any]) -> None:
            if name in self._router_drains:
                return
            self.replicas[name].draining = True
            kwargs = [
                kw for kw in Engine.restore_requests(snapshot)
                if kw["rid"] in self._records
            ]
            self._record_event(
                "drain",
                detail=f"{name} (engine-initiated): "
                       f"{len(kwargs)} in-flight",
            )
            try:
                self._resubmit(kwargs)
            except ReplicaDied:
                # No survivor in rotation: the snapshot is still
                # persisted by the engine's own CheckpointManager (when
                # wired) — don't break the drain's snapshot contract.
                self._record_event(
                    "drain", detail=f"{name}: no survivor to resume on"
                )

        return hook

    def _router_snapshot(self, names: Sequence[str]) -> Dict[str, Any]:
        """A drain-schema snapshot rebuilt from the router's own
        records — what failover falls back to when the dead replica
        cannot execute :meth:`Engine.drain` (hard crash).  Identical
        schema, so the SAME ``Engine.restore_requests`` parses both."""
        tree: Dict[str, Dict[str, np.ndarray]] = {}
        meta: Dict[str, Dict[str, Any]] = {}
        for rid in names:
            r = self._records[rid]
            tree[rid] = {
                "prompt": np.asarray(r.prompt, np.int32),
                "generated": np.asarray(r.tokens, np.int32),
            }
            meta[rid] = {
                "max_new_tokens": r.max_new_tokens,
                "eos_id": r.eos_id,
                "emitted_prefix": [],
                "prompt_len": int(r.prompt.size),
                "generated_len": len(r.tokens),
                "tier": r.tier,
                "tenant": r.tenant,
            }
        return {"tree": tree, "requests": meta}

    def _unfinished_on(self, name: str) -> List[str]:
        eng = self.replicas[name].engine
        return [
            r.rid
            for r in (*eng.scheduler.queue,
                      *eng.scheduler.active.values(),
                      # migration-parked work (prefill role; absent on
                      # policy-test engine facades)
                      *getattr(eng, "_migration_ready", ()))
        ]

    def _resubmit(self, kwargs: List[Dict[str, Any]]) -> None:
        for kw in kwargs:
            rid = kw["rid"]
            record = self._records[rid]
            # Drop only a STALE pin (one naming a replica out of
            # rotation): the first moved request of a session then
            # re-pins, and the session's remaining requests follow it —
            # a failover must not scatter one session across survivors.
            if record.session is not None:
                pinned = self.replicas.get(
                    self._sessions.get(record.session, "")
                )
                if pinned is None or not pinned.in_rotation:
                    self._sessions.pop(record.session, None)
            # The snapshot carries the EFFECTIVE tier (an over-budget
            # demotion mutated on the scheduler's Request): fold it
            # back into the record so the resubmission — and any later
            # failover — keeps the class the request actually ran at.
            record.tier = kw.get("tier", record.tier)
            source = record.replica
            # EVERY resumption re-prefills (the snapshot teacher-forces
            # prompt + emitted tokens), so in a disaggregated fleet the
            # target is always the PREFILL pool — decode replicas never
            # run prefill programs.  A resumed stream then re-migrates
            # to a decode survivor at prompt completion, which is where
            # "decode in-flight resumes on decode survivors" lands.
            target = self.pick_replica(
                record.session,
                role="prefill" if self.disaggregated else None,
            )
            self._submit_to(
                target, record, kw["prompt"], kw["max_new_tokens"],
                emitted_prefix=kw["emitted_prefix"],
            )
            record.moves += 1
            self._c_moved.inc()
            self._record_event(
                "req_move", detail=f"{source}->{target}", rid=rid
            )

    def failover(self, name: str,
                 error: Optional[BaseException] = None) -> List[str]:
        """Take ``name`` out of rotation and resume its in-flight
        requests elsewhere.  Prefers the engine's own cooperative drain
        (which also persists through its CheckpointManager, when wired);
        a replica too dead to drain falls back to the router-side
        snapshot.  Returns the moved rids."""
        rep = self.replicas[name]
        rep.alive = False
        self._c_failovers.inc()
        pending = self._unfinished_on(name)
        self._record_event(
            "failover",
            detail=f"{name}: {len(pending)} in-flight "
                   f"({error or 'requested'})",
        )
        snapshot: Optional[Dict[str, Any]] = None
        self._router_drains.add(name)
        try:
            snapshot = rep.engine.drain()
        except Exception:  # noqa: BLE001 — replica too dead to drain
            snapshot = None
        finally:
            self._router_drains.discard(name)
        if snapshot is None or set(snapshot["requests"]) != set(pending):
            snapshot = self._router_snapshot(pending)
        kwargs = Engine.restore_requests(snapshot)
        try:
            self._resubmit(kwargs)
        except ReplicaDied:
            # No survivor in rotation (e.g. a single-replica fleet, or
            # the last one died).  Nothing is lost: every request stays
            # in the router's records with its emitted tokens, so
            # `_router_snapshot` can rebuild them on demand — don't let
            # a second ReplicaDied escape the failover and crash run().
            self._record_event(
                "failover",
                detail=f"{name}: no survivor to resume on "
                       f"({len(kwargs)} request(s) stay recorded)",
            )
            kwargs = []
        if self.recorder is not None and hasattr(self.recorder, "dump"):
            try:
                self.recorder.dump()
            except Exception:  # noqa: BLE001 — never mask the failover
                pass
        return [kw["rid"] for kw in kwargs]

    def drain_replica(self, name: str) -> List[str]:
        """Graceful scale-down: stop routing to ``name``, drain it
        cooperatively (its CheckpointManager hook fires as usual), and
        resume its in-flight requests on the survivors."""
        rep = self.replicas[name]
        rep.draining = True
        pending = self._unfinished_on(name)
        self._router_drains.add(name)
        try:
            snapshot = rep.engine.drain()
        finally:
            self._router_drains.discard(name)
        self._record_event(
            "drain", detail=f"{name}: {len(pending)} moved"
        )
        kwargs = Engine.restore_requests(snapshot)
        self._resubmit(kwargs)
        return [kw["rid"] for kw in kwargs]

    # ------------------------------------------------------------------ #
    # SLO observe -> act                                                 #
    # ------------------------------------------------------------------ #

    def degrade(self, name: str, reason: str = "slo breach") -> List[str]:
        """Take a BREACHING replica out of rotation without killing it:
        mark it degraded, drain it cooperatively, and resume its
        in-flight requests on the survivors (the exact failover path —
        greedy streams stay bitwise).  Recorded on the registry
        (``fleet_slo_evictions``/``fleet_degraded``) and the flight
        recorder (``slo_evict``); :meth:`readmit` is the inverse."""
        rep = self.replicas[name]
        if rep.degraded:
            return []
        rep.degraded = True
        self._degraded_at[name] = self._clock()
        self._c_slo_evicted.inc(replica=name)
        self._g_degraded.set(1.0, replica=name)
        pending = self._unfinished_on(name)
        self._record_event(
            "slo_evict",
            detail=f"{name}: {reason} ({len(pending)} in-flight moved)",
        )
        self._router_drains.add(name)
        try:
            snapshot = rep.engine.drain()
        except Exception:  # noqa: BLE001 — a replica too broken to
            snapshot = None  # drain falls back to the router's records
        finally:
            self._router_drains.discard(name)
        if snapshot is None or set(snapshot["requests"]) != set(pending):
            snapshot = self._router_snapshot(pending)
        kwargs = Engine.restore_requests(snapshot)
        try:
            self._resubmit(kwargs)
        except ReplicaDied:
            # No survivor (the min-in-rotation brake should prevent
            # this, but a concurrent death can race it): the requests
            # stay recorded, same contract as failover.
            self._record_event(
                "slo_evict",
                detail=f"{name}: no survivor to resume on",
            )
            kwargs = []
        return [kw["rid"] for kw in kwargs]

    def readmit(self, name: str) -> None:
        """Return a recovered degraded replica to rotation: its windows
        came back clean, so it may serve again (its captured programs
        and pool are intact — :meth:`Engine.resume_serving` just
        re-opens admissions)."""
        rep = self.replicas[name]
        if not rep.degraded:
            return
        rep.degraded = False
        self._degraded_at.pop(name, None)
        rep.engine.resume_serving()
        self._c_slo_readmitted.inc(replica=name)
        self._g_degraded.set(0.0, replica=name)
        self._record_event("slo_readmit", detail=name)

    def _slo_tick(self) -> None:
        """One SLO evaluation + act pass (end of every :meth:`step`).
        Breaching replicas degrade (never below ``slo_min_in_rotation``
        healthy ones); degraded replicas whose alerts cleared re-admit
        after the cooldown."""
        if self.slo is None:
            return
        self.slo.tick()
        # Only replica-split objectives may drive eviction: a tenant-
        # split breach whose tenant id collides with a replica name
        # must not read as that replica's verdict.  In a disaggregated
        # fleet the verdict is additionally PHASE-SCOPED: a replica is
        # blamed only by objectives declared for its own pool (TTFT →
        # prefill, TPOT → decode; phase-less objectives blame anyone),
        # so a prefill burst inflating TTFT can never evict a healthy
        # decode replica.
        if self.disaggregated:
            breaching = set()
            for role, names in self.pools.items():
                breaching |= (
                    set(self.slo.breaching(split_by="replica",
                                           phase=role))
                    & set(names)
                )
        else:
            breaching = self.slo.breaching(split_by="replica")
        now = self._clock()
        for name, rep in self.replicas.items():
            if rep.degraded and rep.alive and name not in breaching:
                since = now - self._degraded_at.get(name, now)
                if since >= self.slo_cooldown_s:
                    self.readmit(name)
            elif rep.in_rotation and name in breaching:
                # The min-in-rotation brake counts the breacher's OWN
                # pool: evicting the last prefill replica (or the last
                # decode one) stops the whole fleet just as surely as
                # evicting the last unified replica.
                in_rotation = sum(
                    1 for r in self.replicas.values()
                    if r.in_rotation
                    and self.roles[r.name] == self.roles[name]
                )
                if in_rotation <= self.slo_min_in_rotation:
                    self._record_event(
                        "slo_evict_skipped",
                        detail=f"{name}: breaching but only "
                               f"{in_rotation} replica(s) in rotation",
                    )
                    continue
                self.degrade(name)


__all__ = ["Replica", "ReplicaDied", "Router", "RouterRecord"]
