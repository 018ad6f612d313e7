"""Cooperative preemption: SIGTERM/SIGINT -> checkpoint-and-exit between
steps.

Counterpart of ``torchgpipe_tpu/resilience/preemption.py`` (the same
standard-library code).  Preemptible cloud machines deliver a SIGTERM and
a short grace window before the machine vanishes; an untouched Python
default would kill the process mid-step, mid-checkpoint, mid-anything.  :class:`PreemptionHandler`
converts the signal into a FLAG the training loop polls at its one safe
point — the step boundary — so the run saves a consistent snapshot and
exits cleanly, to be resumed by the next incarnation via
:meth:`~torchgpipe_tpu_torch.resilience.checkpoint.CheckpointManager.
restore_latest`.

The canonical loop::

    with PreemptionHandler() as stop:
        for step in range(start, total):
            state = train_step(state, *batch)
            if step % save_every == 0 or stop.check(step):
                mgr.save(step, state_arrays)
            if stop.preempted:
                break   # clean exit inside the grace window

The serving engine takes the handler as ``Engine(preemption=...)``: its
``request_drain`` is registered with :meth:`add_callback`, and ``run``
drains between iterations once the flag latches.

Notes:

* ``check(step)`` also honors a simulated preemption injected via
  :func:`torchgpipe_tpu_torch.resilience.faults.inject` (``preempt_at_step=k``)
  — the CI stand-in for a real SIGTERM, used by the kill-and-resume
  round-trip tests.
* Signals are swallowed only ONCE per signal number: a second SIGINT
  raises ``KeyboardInterrupt`` (the impatient-operator contract), a
  second SIGTERM stays cooperative (the platform usually follows up with
  SIGKILL anyway).
* ``signal.signal`` works from the main thread only; constructing the
  handler elsewhere raises — poll :mod:`faults` or call
  :meth:`simulate` from worker threads instead.
"""

from __future__ import annotations

import collections
import signal
import threading
import weakref
from types import FrameType
from typing import Any, Callable, Deque, Dict, Iterable, Optional

from torchgpipe_tpu_torch.resilience import faults


class PreemptionHandler:
    """Latches termination signals into a flag polled between steps."""

    def __init__(
        self,
        signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
    ) -> None:
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self.signum: Optional[int] = None
        self._seen: Dict[int, int] = {}
        self._previous: Dict[int, Any] = {}
        self._installed = False
        # Hooks not yet delivered.  A deque because popleft() is one
        # atomic C call: signal handlers run between bytecodes on this
        # same thread, so claim-then-invoke with plain ints could
        # double-fire a hook when a signal lands mid-claim — popping
        # hands each hook to exactly one _fire frame.
        self._pending: Deque[Callable[[], Optional[Callable[[], None]]]] \
            = collections.deque()

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # interpreter shutting down
                pass
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    # ------------------------------------------------------------------ #
    # signal path                                                        #
    # ------------------------------------------------------------------ #

    def _on_signal(self, signum: int, frame: Optional[FrameType]) -> None:
        del frame
        self._seen[signum] = self._seen.get(signum, 0) + 1
        self.signum = signum
        self._flag.set()
        self._fire()
        if signum == signal.SIGINT and self._seen[signum] > 1:
            raise KeyboardInterrupt  # second ctrl-C: stop waiting politely

    def simulate(self) -> None:
        """Set the flag programmatically (tests, custom watchdogs)."""
        self._flag.set()
        self._fire()

    # ------------------------------------------------------------------ #
    # drain hooks                                                        #
    # ------------------------------------------------------------------ #

    def add_callback(self, fn: Callable[[], None]) -> None:
        """Register a drain hook fired at most ONCE — when preemption
        first latches (signal, :meth:`simulate`, or a fault-injected
        step), or immediately if it already has.  Hooks may run in
        signal context — they must only flip flags / enqueue work (the
        serving engine's ``request_drain`` contract), never block or
        touch device state; exceptions are swallowed (a broken observer
        must not lose the preemption grace window).

        Bound methods are held by ``weakref.WeakMethod``: a
        process-lifetime handler must not pin every engine ever wired
        to it (a dead serving engine's hook is skipped, and the engine
        — KV pool included — stays collectable).  Plain functions,
        closures, and bound methods WeakMethod cannot hold (C-level
        methods, ``__slots__`` receivers without ``__weakref__``) are
        held strongly."""
        ref: Callable[[], Optional[Callable[[], None]]]
        try:
            ref = weakref.WeakMethod(fn)  # type: ignore[arg-type]
        except TypeError:
            ref = lambda fn=fn: fn  # noqa: E731 — uniform resolve shape
        self._pending.append(ref)
        if self._flag.is_set():
            self._fire()

    def _fire(self) -> None:
        # At-most-once per CALLBACK, not per handler: a hook registered
        # after the flag latched still gets its delivery, and each
        # popleft() hands its hook to exactly one frame even when a
        # signal re-enters this loop mid-iteration.
        while True:
            try:
                ref = self._pending.popleft()
            except IndexError:
                return
            fn = ref()
            if fn is None:          # referent collected: skip
                continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — see add_callback
                pass

    # ------------------------------------------------------------------ #
    # polling                                                            #
    # ------------------------------------------------------------------ #

    @property
    def preempted(self) -> bool:
        """True once a signal arrived or a preemption was simulated."""
        return self._flag.is_set()

    def check(self, step: Optional[int] = None) -> bool:
        """Poll at a step boundary.  Latches (and then reports) a
        fault-injected preemption for ``step`` as well as real signals."""
        if step is not None and faults.should_preempt(step):
            self._flag.set()
            self._fire()
        return self._flag.is_set()
