"""Supervised execution of the PAL kernel loops.

The seed runtime was strictly fail-stop: ``PAL._guard`` turned ANY
exception in any kernel thread into a workflow-wide StopToken.  For
days-long AL campaigns with failure-prone ab initio oracles that policy
conflates three very different severities.  This module separates them:

  task failure   — one ``oracle.run_calc`` raising.  Retried in place with
                   exponential backoff + jitter (``FailurePolicy.
                   task_retries``); exhausted retries surface as a failure
                   sentinel on the results channel and the Manager's
                   TaskLedger redispatches or fails THAT task.  The worker
                   never dies for a task.
  loop crash     — a kernel loop (oracle worker, trainer, exchange, ...)
                   raising out of its main loop.  The supervisor logs it,
                   records a :class:`FaultRecord`, runs the loop's
                   ``on_crash`` cleanup (e.g. requeue the rank's in-flight
                   ledger tasks) and RESTARTS the loop in the same thread
                   after a backoff.  The trainer resumes from its
                   device-resident replay ring + last stacked TrainState;
                   an oracle re-registers a fresh endpoint.
  run failure    — more than ``max_crashes`` crashes of one loop inside
                   ``crash_window_s``.  Only then does the supervisor
                   escalate to the fail-stop path (StopToken), because at
                   that point restarting is hiding a systemic problem.

Counters (``monitor``): ``runtime.thread_crashes`` (kept from the seed —
healthy-run tests assert it stays 0), ``runtime.thread_restarts``,
``supervisor.escalations`` and per-class ``supervisor.crashes.<class>``.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """Per-loop-class failure handling knobs (see ``PALRunConfig``).

    ``task_retries``      in-place retries for one oracle task before the
                          worker gives up and reports a task failure.
    ``task_backoff_s``    first retry delay; grows by ``backoff_factor``
                          per attempt, capped at ``backoff_max_s``, with
                          ``jitter`` relative randomization (decorrelates
                          thundering-herd retries across workers).
    ``max_crashes``       crash count within ``crash_window_s`` at which
                          the supervisor stops restarting and escalates
                          to a StopToken.  1 == fail-stop.
    ``restart_backoff_s`` first restart delay (same growth/jitter rules).
    """

    task_retries: int = 2
    task_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    max_crashes: int = 3
    crash_window_s: float = 30.0
    restart_backoff_s: float = 0.1


@dataclasses.dataclass
class FaultRecord:
    """One observed crash, kept for ``PAL.report()['last_fault']``."""

    thread: str
    loop_class: str
    error: str
    time: float
    restarts: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Supervisor:
    """Restart-with-backoff driver for named kernel loops.

    ``run(name, loop_class, fn, *args)`` executes ``fn`` in the CALLING
    thread under supervision: the thread object survives crashes (so
    ``PAL.shutdown`` joins the same handles it started), only the loop
    body is re-entered.  Backoff sleeps wait on ``stop_event`` so a
    shutdown interrupts them immediately.

    ``escalate`` is the fail-stop callback (``PAL._signal_stop``); it
    receives ``(name, reason)`` and is invoked once the loop burns through
    its crash budget.
    """

    def __init__(self, monitor, escalate: Callable[[str, str], None],
                 stop_event: threading.Event, *,
                 policies: Optional[Dict[str, FailurePolicy]] = None,
                 seed: int = 0):
        self.monitor = monitor
        self.escalate = escalate
        self.stop_event = stop_event
        self.policies = dict(policies or {})
        self.default_policy = self.policies.get("default", FailurePolicy())
        self._lock = threading.Lock()
        self._crash_times: Dict[str, deque] = {}
        self._restarts: Dict[str, int] = {}
        self._rng = random.Random(seed)
        self.last_fault: Optional[FaultRecord] = None
        self.faults: List[FaultRecord] = []
        self._health: Dict[str, Callable[[], Any]] = {}

    # -------------------------------------------------------------- policy
    def policy(self, loop_class: str) -> FailurePolicy:
        return self.policies.get(loop_class, self.default_policy)

    def backoff_delay(self, policy: FailurePolicy, attempt: int,
                      base: Optional[float] = None) -> float:
        """Exponential backoff with relative jitter: ``base * factor^n``,
        capped, then scaled by ``1 ± jitter``."""
        b = policy.task_backoff_s if base is None else base
        d = min(b * (policy.backoff_factor ** max(attempt, 0)),
                policy.backoff_max_s)
        with self._lock:
            j = 1.0 + policy.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d * j, 0.0)

    # ----------------------------------------------------------- bookkeeping
    def _record_crash(self, name: str, loop_class: str,
                      err: BaseException) -> FaultRecord:
        now = time.monotonic()
        with self._lock:
            times = self._crash_times.setdefault(name, deque())
            times.append(now)
            pol = self.policy(loop_class)
            while times and now - times[0] > pol.crash_window_s:
                times.popleft()
            rec = FaultRecord(thread=name, loop_class=loop_class,
                              error=repr(err), time=time.time(),
                              restarts=self._restarts.get(name, 0))
            self.last_fault = rec
            self.faults.append(rec)
        if self.monitor is not None:
            self.monitor.incr("runtime.thread_crashes")
            self.monitor.incr(f"supervisor.crashes.{loop_class}")
        return rec

    def _crashes_in_window(self, name: str) -> int:
        with self._lock:
            return len(self._crash_times.get(name, ()))

    def total_restarts(self) -> int:
        with self._lock:
            return sum(self._restarts.values())

    def register_health(self, name: str, fn: Callable[[], Any]):
        """Attach a component health probe (e.g. the serving queue's
        ``health``): ``snapshot()['components'][name]`` carries its latest
        payload, so one supervisor snapshot is the whole degradation
        surface."""
        with self._lock:
            self._health[name] = fn

    def snapshot(self) -> Dict[str, Any]:
        """Observability payload for ``PAL.report()``."""
        with self._lock:
            probes = dict(self._health)
            snap = {
                "last_fault": (self.last_fault.as_dict()
                               if self.last_fault else None),
                "faults_total": len(self.faults),
                "restarts": dict(self._restarts),
            }
        # probes run OUTSIDE self._lock: each takes its component's own
        # lock (the serving queue's health() does) and nesting the
        # supervisor lock around them invites lock-order inversions
        if probes:
            comps: Dict[str, Any] = {}
            for name, fn in probes.items():
                try:
                    comps[name] = fn()
                except BaseException as e:  # noqa: BLE001 — probe, not fatal
                    comps[name] = {"error": repr(e)}
            snap["components"] = comps
        return snap

    # ----------------------------------------------------------------- run
    def run(self, name: str, loop_class: str, fn: Callable, *args,
            on_crash: Optional[Callable[[BaseException], None]] = None,
            should_stop: Optional[Callable[[], bool]] = None):
        """Drive ``fn(*args)`` under supervision in the current thread.

        Returns when ``fn`` returns cleanly, when a stop is requested, or
        after escalation.  ``on_crash`` runs between the crash and the
        restart (exceptions in it are logged, never fatal); ``should_stop``
        adds loop-private stop conditions (ElasticPool worker events) on
        top of the global ``stop_event``.
        """
        pol = self.policy(loop_class)

        def stopping() -> bool:
            return self.stop_event.is_set() or (
                should_stop is not None and should_stop())

        while not stopping():
            try:
                fn(*args)
                return                              # clean exit
            except BaseException as e:  # noqa: BLE001 — supervision boundary
                rec = self._record_crash(name, loop_class, e)
                log.warning("supervised loop %r (%s) crashed: %r",
                            name, loop_class, e, exc_info=True)
                if on_crash is not None:
                    try:
                        on_crash(e)
                    except BaseException as ce:  # noqa: BLE001
                        log.error("on_crash cleanup for %r failed: %r",
                                  name, ce)
                n_window = self._crashes_in_window(name)
                if n_window >= pol.max_crashes:
                    if self.monitor is not None:
                        self.monitor.incr("supervisor.escalations")
                    self.escalate(
                        name,
                        f"crashed {n_window} times within "
                        f"{pol.crash_window_s}s (last: {rec.error}) — "
                        f"exceeds FailurePolicy.max_crashes={pol.max_crashes}")
                    return
                if stopping():
                    return
                with self._lock:
                    self._restarts[name] = self._restarts.get(name, 0) + 1
                if self.monitor is not None:
                    self.monitor.incr("runtime.thread_restarts")
                delay = self.backoff_delay(pol, n_window - 1,
                                           base=pol.restart_backoff_s)
                log.info("restarting %r in %.3fs (crash %d/%d in window)",
                         name, delay, n_window, pol.max_crashes)
                self.stop_event.wait(delay)

    def spawn(self, name: str, loop_class: str, fn: Callable, *args,
              **kw) -> threading.Thread:
        """Convenience: a daemon thread running ``run(...)``."""
        t = threading.Thread(
            target=self.run, args=(name, loop_class, fn) + args, kwargs=kw,
            name=name, daemon=True)
        t.start()
        return t


def policies_from_config(cfg) -> Dict[str, FailurePolicy]:
    """Map ``PALRunConfig`` knobs onto per-loop-class policies.  With
    ``supervise=False`` every class gets ``max_crashes=1`` — the first
    crash escalates, reproducing fail-stop behavior through
    the same code path."""
    supervise = getattr(cfg, "supervise", True)
    base = dict(
        task_retries=int(getattr(cfg, "oracle_task_retries", 2)),
        task_backoff_s=float(getattr(cfg, "oracle_task_backoff_s", 0.05)),
        max_crashes=(int(getattr(cfg, "loop_max_crashes", 3))
                     if supervise else 1),
        crash_window_s=float(getattr(cfg, "loop_crash_window_s", 30.0)),
        restart_backoff_s=float(getattr(cfg, "loop_restart_backoff_s", 0.1)),
    )
    pol = FailurePolicy(**base)
    return {"default": pol, "oracle": pol, "trainer": pol,
            "exchange": pol, "manager": pol, "generator": pol,
            "prediction": pol}
