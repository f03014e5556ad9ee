"""Fault tolerance & elasticity for kernel pools (beyond-paper features the
paper lists as future work; DESIGN.md §2).

* ``TaskLedger``: every dispatched oracle job carries a deadline; expired
  jobs are requeued (straggler mitigation / dead-node tolerance) up to
  ``max_retries``, then surfaced as failed.
* ``Heartbeat``: worker liveness; a worker missing ``max_misses`` beats is
  marked dead and its in-flight work requeued.
* ``ElasticPool``: add/remove worker threads at runtime (elastic scaling of
  oracle/generator pools).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Task:
    task_id: int
    payload: Any
    dispatched_at: float
    deadline: float
    worker: str
    retries: int = 0


class TaskLedger:
    """Tracks in-flight oracle jobs; requeues stragglers."""

    def __init__(self, timeout: float, max_retries: int = 2):
        self.timeout = timeout
        self.max_retries = max_retries
        self._inflight: Dict[int, Task] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.requeued = 0
        self.failed: List[Task] = []
        self.completed = 0

    def dispatch(self, payload: Any, worker: str,
                 retries: int = 0) -> int:
        now = time.time()
        with self._lock:
            tid = next(self._ids)
            self._inflight[tid] = Task(tid, payload, now, now + self.timeout,
                                       worker, retries)
            return tid

    def complete(self, task_id: int) -> Optional[Task]:
        with self._lock:
            t = self._inflight.pop(task_id, None)
            if t is not None:
                self.completed += 1
            return t  # None => was already requeued (late straggler result)

    def fail(self, task: Task):
        """Record a task as terminally failed (reported failure with no
        retries left — the worker-reported analog of retry exhaustion in
        ``expired``)."""
        with self._lock:
            self.failed.append(task)

    def expired(self) -> List[Task]:
        """Pop tasks past their deadline: retryable ones are returned for
        requeue; ones out of retries land in ``failed``."""
        now = time.time()
        out: List[Task] = []
        with self._lock:
            for tid in [t for t, v in self._inflight.items()
                        if v.deadline < now]:
                t = self._inflight.pop(tid)
                if t.retries < self.max_retries:
                    self.requeued += 1
                    out.append(t)
                else:
                    self.failed.append(t)
        return out

    def requeue_worker(self, worker: str) -> List[Task]:
        """Pull every in-flight task owned by a (dead) worker."""
        with self._lock:
            tids = [tid for tid, t in self._inflight.items()
                    if t.worker == worker]
            out = [self._inflight.pop(tid) for tid in tids]
            self.requeued += len(out)
            return out

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def inflight_payloads(self) -> List[Any]:
        """Payloads of every dispatched-but-unfinished task (checkpoint
        path: in-flight oracle work is requeued into the snapshot so a
        restore never silently loses dispatched-but-unlabeled inputs)."""
        with self._lock:
            return [t.payload for t in self._inflight.values()]


class Heartbeat:
    """Worker liveness tracking (interval-based miss counting)."""

    def __init__(self, interval: float, max_misses: int = 3):
        self.interval = interval
        self.max_misses = max_misses
        self._last: Dict[str, float] = {}
        self._dead: set = set()
        self._lock = threading.Lock()

    def beat(self, worker: str):
        with self._lock:
            self._last[worker] = time.time()
            self._dead.discard(worker)

    def dead_workers(self) -> List[str]:
        now = time.time()
        with self._lock:
            newly = []
            for w, t in self._last.items():
                if w in self._dead:
                    continue
                if now - t > self.interval * self.max_misses:
                    self._dead.add(w)
                    newly.append(w)
            return newly

    def is_dead(self, worker: str) -> bool:
        with self._lock:
            return worker in self._dead

    def forget(self, worker: str):
        with self._lock:
            self._last.pop(worker, None)
            self._dead.discard(worker)


class ElasticPool:
    """A resizable pool of daemon worker threads.

    ``worker_fn(rank: str, stop: threading.Event)`` runs until its private
    stop event (remove) or the pool-wide stop event (shutdown) is set.
    """

    def __init__(self, name: str, worker_fn: Callable[[str, threading.Event],
                                                      None]):
        self.name = name
        self.worker_fn = worker_fn
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.stop_all = threading.Event()

    def add(self, n: int = 1) -> List[str]:
        ranks = []
        with self._lock:
            for _ in range(n):
                rank = f"{self.name}{next(self._ids)}"
                stop = threading.Event()

                def run(rank=rank, stop=stop):
                    self.worker_fn(rank, stop)

                th = threading.Thread(target=run, name=rank, daemon=True)
                self._workers[rank] = {"thread": th, "stop": stop}
                th.start()
                ranks.append(rank)
        return ranks

    def remove(self, rank: str, join: bool = True, timeout: float = 5.0):
        with self._lock:
            w = self._workers.pop(rank, None)
        if w is None:
            return
        w["stop"].set()
        if join:
            w["thread"].join(timeout)

    def shrink(self, n: int = 1):
        with self._lock:
            ranks = list(self._workers)[-n:]
        for r in ranks:
            self.remove(r)

    def ranks(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def size(self) -> int:
        with self._lock:
            return len(self._workers)

    def shutdown(self, timeout: float = 10.0):
        self.stop_all.set()
        with self._lock:
            items = list(self._workers.items())
        for rank, w in items:
            w["stop"].set()
        for rank, w in items:
            w["thread"].join(timeout)
        with self._lock:
            self._workers.clear()
