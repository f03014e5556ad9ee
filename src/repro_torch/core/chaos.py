"""Deterministic seeded fault injection for the PAL runtime.

Robustness that is not exercised is fiction: this module turns "what if an
oracle dies mid-campaign" into a REPRODUCIBLE test input.  A
:class:`FaultPlan` is a declarative schedule of :class:`FaultEvent`s —
"on the 3rd task oracle1 runs, raise"; "on the 2nd trainer round, crash
the loop"; "poison committee member 0" — executed by a
:class:`ChaosInjector` that the runtime consults at fixed instrumentation
sites.  Because events key on per-site call counts (not wall clock), the
same plan produces the same fault sequence on every run, which is what
lets tests/test_chaos.py assert exact recovery behavior and
benchmarks/fault_recovery.py measure throughput retention under a
STANDARD plan.

Instrumentation sites (rank = worker rank or channel name where noted):

  ``oracle.loop``     top of an oracle worker's recv loop (rank = worker)
  ``oracle.task``     before each ``oracle.run_calc`` (rank = worker);
                      a ``raise`` here is a TRANSIENT task failure — the
                      per-task retry path absorbs it
  ``oracle.label``    label corruption point (``nan_label`` events)
  ``trainer.loop``    once per trainer round, before ``train()``
  ``trainer.nan_member`` consumed by the runtime to call
                      ``CommitteeTrainer.poison_member(arg)``
  ``exchange.loop``   top of each exchange iteration
  ``fleet.step``      before each fused exploration-fleet step (``take``
                      site: ``nan_walker`` poisons walker ``int(arg)``,
                      which the fleet's restart gate must reset — never a
                      crash; generic kinds run via ``execute``)
  ``transport.send``  inside ``Channel.isend`` (rank = channel name);
                      installed process-wide via ``transport.install_chaos``

Event kinds:

  ``raise``   raise :class:`ChaosFault` (transient; retried where retries
              exist)
  ``crash``   raise :class:`ChaosCrash` (kills the enclosing loop — the
              supervisor's restart path is what absorbs it)
  ``delay``/``hang``  sleep ``arg`` seconds (``hang`` is the same sleep,
              named for plans that target the heartbeat/ledger timeout)
  ``nan_label``   corrupt the oracle label to NaN (``corrupt_label``)
  ``nan_member``  poison committee member ``int(arg)`` (``take`` site)
  ``nan_walker``  poison fleet walker ``int(arg)`` to NaN (``take`` site;
              the next fused step resets it to its trusted state)

Nothing here imports the runtime — the injector is a passive oracle the
runtime queries, so it is equally usable against a bare Manager or
ServingQueue in unit tests.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class ChaosFault(RuntimeError):
    """Injected transient failure (absorbed by task-level retries)."""


class ChaosCrash(RuntimeError):
    """Injected loop-level crash (absorbed by supervised restarts)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at the ``nth`` call of ``site`` (per rank,
    1-based), do ``kind``.  ``rank`` empty = first rank to reach ``nth``
    fires it (each event fires exactly once either way)."""

    site: str
    nth: int
    kind: str                    # raise | crash | delay | hang | nan_label | nan_member
    rank: str = ""
    arg: float = 0.0             # seconds (delay/hang) or member index (nan_member)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults; ``seed`` namespaces any future
    randomized extension (kept in the type so plans hash/compare whole)."""

    events: Tuple[FaultEvent, ...]
    seed: int = 0

    @staticmethod
    def acceptance(member: int = 0, fleet: bool = False) -> "FaultPlan":
        """The acceptance plan: 3 transient oracle failures, 1
        oracle-thread crash, 1 trainer crash mid-schedule, 1 NaN-weights
        member.  A supervised run absorbs ALL of it without a StopToken.

        ``fleet=True`` appends the exploration-fleet event (a poisoned
        walker on the 3rd fused step) for runs driving a ``WalkerFleet``
        — opt-in so plans against fleetless runs still fire completely."""
        events = [
            FaultEvent("oracle.task", 2, "raise", rank="oracle0"),
            FaultEvent("oracle.task", 4, "raise", rank="oracle1"),
            FaultEvent("oracle.task", 6, "raise", rank="oracle0"),
            FaultEvent("oracle.loop", 9, "crash", rank="oracle1"),
            FaultEvent("trainer.loop", 2, "crash"),
            FaultEvent("trainer.nan_member", 1, "nan_member", arg=member),
        ]
        if fleet:
            events.append(FaultEvent("fleet.step", 3, "nan_walker", arg=0.0))
        return FaultPlan(events=tuple(events))


class ChaosInjector:
    """Executes a :class:`FaultPlan` against per-(site, rank) call counters.

    Thread-safe: every kernel loop queries it concurrently.  ``fired``
    records ``(site, rank, event)`` tuples in firing order for test
    assertions; counters survive loop restarts (a restarted oracle keeps
    counting from where its predecessor died, so "nth call" means nth
    over the campaign, not per incarnation).
    """

    def __init__(self, plan: FaultPlan, monitor=None):
        self.plan = plan
        self.monitor = monitor
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._consumed: set = set()
        self.fired: List[Tuple[str, str, FaultEvent]] = []

    # ------------------------------------------------------------ matching
    def _match(self, site: str, rank: str) -> Optional[FaultEvent]:
        with self._lock:
            key = (site, rank)
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            for i, ev in enumerate(self.plan.events):
                if i in self._consumed or ev.site != site or ev.nth != n:
                    continue
                if ev.rank and ev.rank != rank:
                    continue
                self._consumed.add(i)
                self.fired.append((site, rank, ev))
                if self.monitor is not None:
                    self.monitor.incr(f"chaos.{ev.kind}")
                return ev
        return None

    # ----------------------------------------------------------------- API
    def check(self, site: str, rank: str = ""):
        """Counter tick + fault execution for raise/crash/delay/hang sites.
        Call it INSIDE the try-scope whose recovery path should absorb the
        fault."""
        ev = self._match(site, rank)
        if ev is not None:
            self.execute(ev, rank=rank)

    def execute(self, ev: FaultEvent, rank: str = ""):
        """Run a matched event's generic effect (raise/crash/delay/hang).
        Public so ``take`` sites — whose special kinds the caller realizes
        itself (``nan_member``, ``nan_walker``) — can still honor generic
        kinds without ticking the counter twice."""
        if ev.kind in ("delay", "hang"):
            time.sleep(float(ev.arg))
        elif ev.kind == "raise":
            raise ChaosFault(f"injected transient fault at {ev.site}"
                             f"{f' ({rank})' if rank else ''} n={ev.nth}")
        elif ev.kind == "crash":
            raise ChaosCrash(f"injected crash at {ev.site}"
                             f"{f' ({rank})' if rank else ''} n={ev.nth}")

    def corrupt_label(self, label, rank: str = ""):
        """``oracle.label`` site: returns the label, NaN-filled when a
        ``nan_label`` event fires (the Manager's finite check must catch
        it and requeue the task)."""
        ev = self._match("oracle.label", rank)
        if ev is None or ev.kind != "nan_label":
            return label
        bad = np.array(label, dtype=np.float32, copy=True)
        bad[...] = np.nan
        return bad

    def take(self, site: str, rank: str = "") -> Optional[FaultEvent]:
        """Counter tick returning the matched event (or None) instead of
        executing it — for events the RUNTIME performs (``nan_member``)."""
        return self._match(site, rank)

    def summary(self) -> List[str]:
        with self._lock:
            return [f"{s}:{r or '*'}:{e.kind}@{e.nth}" for s, r, e in self.fired]
