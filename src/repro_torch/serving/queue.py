"""Multi-tenant queue-batched committee serving (a host-side copy of the
reference's ``repro/serving/queue.py``).

``CommitteeServer.predict`` scores whatever batch each caller happens to
hand in — at request scale (many clients, tiny batches) that caps served
throughput at one engine dispatch per request.  ``ServingQueue`` turns N
tiny requests into ONE fused dispatch, and on top of the plain FIFO
microbatcher adds the three things a multi-tenant front needs:

**Per-client fairness** — ``submit(..., client=)`` tags every request
with its tenant.  Requests land in per-client FIFO queues and a
deficit-round-robin (DRR) scheduler composes each microbatch: every
backlogged client earns a row quantum per scheduling pass and spends it
on its head-of-line requests, so one flooding tenant can fill at most
its share of a microbatch and no tenant starves (a client's OWN requests
still resolve in submission order).  Per-client token buckets
(``rate_limit`` rows/s, ``rate_burst`` capacity) shed excess demand with
a typed ``RateLimited`` rejection before it ever queues.

**Adaptive latency** — instead of a statically tuned ``max_wait_ms``,
``latency_target_ms > 0`` installs a :class:`core.budget.
LatencyController`: the same multiplicative-PI controller that steers
the oracle budget, re-aimed at the observed per-request p99.  Every
``latency_window`` served requests the queue measures p99 and the
controller moves the effective deadline multiplicatively — p99 over
target shrinks it (smaller batches, less queueing), p99 under target
grows it (bigger batches, better amortization) — bounded to
``[wait_min_ms, wait_max_ms]``.  The queue trades batch size for
deadline automatically as load shifts.

**LSH answer cache** — a :class:`serving.cache.LSHAnswerCache` (same
fixed-random-projection bucketing as ``RollingReweightRule``)
short-circuits low-uncertainty repeat requests at ``submit`` time:
a request whose every row verifies against a cached confident answer
resolves immediately, paying zero device dispatches — and keeps being
served even while the circuit breaker is open.  The cache is
generation-tagged against the serving engine's weight version and
invalidates wholesale on ``refresh_from_device`` (stale answers never
outlive a weight refresh).  Uncertain rows (selected by the rule
pipeline, or ``scalar_std`` above the gate) are never cached — they must
keep reaching the device and, through it, the oracle-routing path.

Request boundaries are never split across dispatches (a request's rows
stay contiguous in one microbatch), and the scatter is by construction
order-preserving per client.  Uncertain-request routing to the oracle
buffer and budget-controller metering (``STREAM_SERVE`` rounds) happen
inside the wrapped ``CommitteeServer``, once per microbatch.

``health()`` snapshots the breaker state and EVERY counter — global and
per-client (``served`` / ``shed`` / ``cache_hits``) — under one lock, so
``PAL.report()['serve_queue_health']`` is a consistent picture, not a
torn read.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class ServingRejected(RuntimeError):
    """Base of the typed fast-fail rejections the queue can raise from
    ``submit`` — callers distinguish "the service said no, retry later /
    elsewhere" from a real engine error delivered through the Future."""


class QueueOverloaded(ServingRejected):
    """Load shedding: the pending backlog exceeds ``shed_pending`` rows.
    Raised immediately instead of blocking the caller (degradation-aware
    serving sheds excess traffic rather than growing tail latency)."""


class CircuitOpen(ServingRejected):
    """Circuit breaker: ``breaker_failures`` consecutive dispatch failures
    opened the circuit; requests fail fast until the ``breaker_reset_s``
    cooldown elapses and a half-open probe succeeds."""


class RateLimited(ServingRejected):
    """Per-client token-bucket limit: this client's demand exceeded its
    ``rate_limit`` rows/s (burst ``rate_burst``).  Raised immediately —
    one tenant's burst is shed at ITS bucket instead of inflating every
    other tenant's latency."""


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """Dispatch trigger + multi-tenant policy knobs.

    ``max_batch``   rows per microbatch; a flush takes whole pending
                    requests while they fit (a single request larger than
                    ``max_batch`` is dispatched alone — the engine's shape
                    buckets absorb it).  Best chosen as a power of two
                    matching ``FusedEngine``'s buckets so the queue creates
                    no new traces.
    ``max_wait_ms`` deadline: the oldest pending request is dispatched at
                    the latest this many ms after it was enqueued.  With
                    ``latency_target_ms`` set this is only the INITIAL
                    deadline — the controller steers it afterwards.
    ``max_pending`` backpressure bound: ``submit`` BLOCKS while the
                    pending backlog holds this many rows.  0 disables.
    ``shed_pending`` load-shedding bound: when the backlog already holds
                    this many rows, ``submit`` raises ``QueueOverloaded``
                    immediately instead of blocking.  0 disables.
    ``breaker_failures`` circuit breaker: after this many CONSECUTIVE
                    dispatch failures the circuit opens and ``submit``
                    raises ``CircuitOpen`` without enqueueing; after
                    ``breaker_reset_s`` one half-open probe is admitted.
                    0 disables.
    ``breaker_reset_s`` open-state cooldown before the half-open probe.
    ``rate_limit``  per-client token-bucket refill, rows/second; a submit
                    that finds its client's bucket short raises
                    ``RateLimited``.  0 disables rate limiting.
    ``rate_burst``  bucket capacity (rows); 0 defaults to
                    ``max(rate_limit, 1)`` — one second of burst.
    ``latency_target_ms`` served-p99 target; > 0 installs the adaptive
                    deadline controller (``core/budget.LatencyController``
                    — the oracle-budget multiplicative PI on latency).
                    0 keeps the static ``max_wait_ms``.
    ``wait_min_ms``/``wait_max_ms`` the controller's authority bounds on
                    the effective deadline.
    ``latency_window`` served requests per p99 measurement / controller
                    update.
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    max_pending: int = 4096
    shed_pending: int = 0
    breaker_failures: int = 0
    breaker_reset_s: float = 5.0
    rate_limit: float = 0.0
    rate_burst: float = 0.0
    latency_target_ms: float = 0.0
    wait_min_ms: float = 0.05
    wait_max_ms: float = 50.0
    latency_window: int = 64


class _Pending:
    __slots__ = ("rows", "future", "t_enqueue", "client")

    def __init__(self, rows: List[np.ndarray], future: Future,
                 t_enqueue: float, client: str):
        self.rows = rows
        self.future = future
        self.t_enqueue = t_enqueue
        self.client = client


class _TokenBucket:
    """Per-client rate limiter: ``rate`` rows/s refill, ``burst`` cap.
    Deterministic given an injected clock (tests drive virtual time)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)          # starts full
        self.t_last = now

    def try_take(self, n: int, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if n > self.tokens:
            return False
        self.tokens -= n
        return True


class ServingQueue:
    """Multi-tenant microbatching front of a
    :class:`repro_torch.serving.engine.CommitteeServer`.

    One dispatcher thread owns the server call; submitters only enqueue
    (or resolve straight from the answer cache).  ``close()`` (or
    context-manager exit) drains pending requests, then stops the
    dispatcher.

    ``cache=`` an optional :class:`repro_torch.serving.cache.LSHAnswerCache`;
    ``clock=`` overrides the token-bucket clock (monotonic seconds) for
    deterministic rate-limit tests.

    Counters (all mutated and snapshotted under ONE lock — ``health()``
    is a consistent picture): ``dispatches`` / ``batched_requests``
    (realized amortization), ``shed_requests`` / ``rate_limited`` /
    ``cache_hit_requests``, the breaker state, and per-client
    ``served`` / ``shed`` / ``cache_hits``.
    """

    def __init__(self, server, cfg: Optional[QueueConfig] = None, *,
                 monitor=None, cache=None, clock=time.monotonic):
        self.server = server
        self.cfg = cfg or QueueConfig()
        if self.cfg.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.monitor = monitor
        self.cache = cache
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)       # dispatcher wakeup
        self._space = threading.Condition(self._lock)    # submitter wakeup
        # per-client FIFO queues + DRR scheduling state (under self._lock)
        self._queues: Dict[str, collections.deque] = {}
        self._rr: List[str] = []               # client rotation order
        self._rr_pos = 0
        self._deficit: Dict[str, float] = {}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._per_client: Dict[str, Dict[str, int]] = {}
        self._pending_rows = 0
        self._n_pending = 0
        self._closed = False
        self.dispatches = 0
        self.batched_requests = 0
        # circuit breaker + shedding state (under self._lock)
        self._breaker_state = "closed"         # closed | open | half_open
        self._consec_failures = 0
        self._opened_at = 0.0
        self.breaker_opens = 0
        self.shed_requests = 0
        self.rate_limited = 0
        self.cache_hit_requests = 0
        self.dispatch_failures = 0
        # adaptive deadline (latency PI controller on observed p99)
        self._wait_ms = float(self.cfg.max_wait_ms)
        self._lat_ctrl = None
        self._lat_state = None
        self._lat_samples: List[float] = []
        self._p99_last: Optional[float] = None
        if self.cfg.latency_target_ms > 0.0:
            from repro_torch.core.budget import LatencyController

            self._lat_ctrl = LatencyController(
                target_ms=float(self.cfg.latency_target_ms),
                wait_min_ms=float(self.cfg.wait_min_ms),
                wait_max_ms=float(self.cfg.wait_max_ms))
            self._lat_state = self._lat_ctrl.init_state(self._wait_ms)
            self._wait_ms = self._lat_ctrl.wait_ms(self._lat_state)
        self._worker = threading.Thread(
            target=self._run, name="serving-queue", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- API
    def submit(self, batch_inputs: Sequence[np.ndarray], *,
               client: str = "", use_cache: bool = True) -> Future:
        """Enqueue one request (a sequence of input rows) for ``client``.
        Returns a Future resolving to ``(mean, UQResult)`` covering
        exactly these rows, in submission order.

        Raises the typed ``ServingRejected`` subclasses instead of
        queueing when degradation policy says no: ``CircuitOpen`` (engine
        failing), ``RateLimited`` (this client over its token bucket),
        ``QueueOverloaded`` (global backlog past the shed bound) — in
        that order.  A full answer-cache hit resolves immediately,
        bypassing every policy gate except the cache's own freshness
        (cached answers stay servable while the circuit is open: the
        device is what's broken, not the cached confident answers).

        Empty requests ride the queue like any other — they keep FIFO
        order with their submitter's non-empty requests and resolve to a
        zero-row result whose ``mean`` width matches their microbatch.
        Zero rows never pay an engine dispatch."""
        rows = [np.asarray(r) for r in batch_inputs]
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        # --- LSH answer cache: full-hit requests never reach the queue ----
        if self.cache is not None and rows:
            if not use_cache:
                self.cache.note_bypass(len(rows))
            else:
                hit = self._try_cache(rows, fut, client)
                if hit is not None:
                    return hit
        with self._cv:
            # circuit breaker: fail fast while open; one request through
            # as the half-open probe once the cooldown elapses
            if self._breaker_state == "open":
                if (time.monotonic() - self._opened_at
                        < self.cfg.breaker_reset_s):
                    if self.monitor is not None:
                        self.monitor.incr("serve.rejected_circuit_open")
                    raise CircuitOpen(
                        f"serving circuit open after "
                        f"{self._consec_failures} consecutive dispatch "
                        f"failures (cooldown {self.cfg.breaker_reset_s}s)")
                self._breaker_state = "half_open"
            # per-client token bucket: shed THIS client's excess before it
            # costs anyone else queue space
            if self.cfg.rate_limit > 0.0 and rows:
                bucket = self._buckets.get(client)
                if bucket is None:
                    burst = self.cfg.rate_burst or max(self.cfg.rate_limit,
                                                       1.0)
                    bucket = _TokenBucket(self.cfg.rate_limit, burst,
                                          self._clock())
                    self._buckets[client] = bucket
                if not bucket.try_take(len(rows), self._clock()):
                    self.rate_limited += 1
                    self._client_stat(client)["shed"] += 1
                    if self.monitor is not None:
                        self.monitor.incr("serve.rejected_rate_limited")
                    raise RateLimited(
                        f"client {client!r} over rate limit "
                        f"({self.cfg.rate_limit:g} rows/s, burst "
                        f"{bucket.burst:g}; request {len(rows)} rows)")
            # load shedding: typed fast-fail instead of queueing when the
            # backlog is already past the shed bound
            shed = self.cfg.shed_pending
            if shed > 0 and self._pending_rows >= shed:
                self.shed_requests += 1
                self._client_stat(client)["shed"] += 1
                if self.monitor is not None:
                    self.monitor.incr("serve.rejected_overload")
                raise QueueOverloaded(
                    f"serving backlog {self._pending_rows} rows >= "
                    f"shed_pending {shed}")
            # backpressure: block while the backlog is at the bound (an
            # oversized request is admitted once the queue is empty, so it
            # can never wait forever)
            bound = self.cfg.max_pending
            while (not self._closed and bound > 0 and self._pending_rows > 0
                   and self._pending_rows + len(rows) > bound):
                self._space.wait()
            if self._closed:
                raise RuntimeError("ServingQueue is closed")
            q = self._queues.get(client)
            if q is None:
                q = collections.deque()
                self._queues[client] = q
                self._rr.append(client)
                self._deficit.setdefault(client, 0.0)
            q.append(_Pending(rows, fut, time.perf_counter(), client))
            self._pending_rows += len(rows)
            self._n_pending += 1
            self._cv.notify()
        return fut

    def predict(self, batch_inputs: Sequence[np.ndarray], *,
                client: str = "") -> Tuple[np.ndarray, Any]:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(batch_inputs, client=client).result()

    # --------------------------------------------------------------- cache
    def _generation(self) -> Tuple[int, ...]:
        gen_fn = getattr(self.server, "weights_generation", None)
        return gen_fn() if gen_fn is not None else (0,)

    def _try_cache(self, rows, fut: Future, client: str) -> Optional[Future]:
        """Resolve ``fut`` from the cache when EVERY row hits (requests
        are atomic: all-cached or all-fresh).  Returns the resolved
        future, or None on any miss (partial hits are re-counted as
        bypass — those rows dispatch fresh with their request-mates)."""
        from repro_torch.core.acquisition import UQResult

        self.cache.note_generation(self._generation())
        entries = self.cache.lookup(rows)
        n_hit = sum(e is not None for e in entries)
        if n_hit < len(rows):
            if n_hit:
                self.cache.note_bypass(n_hit)
            return None
        mean = np.stack([e.mean for e in entries])
        sstd = np.stack([e.scalar_std for e in entries])
        cstd = np.stack([e.component_std for e in entries])
        fin = None
        if all(e.finite is not None for e in entries):
            fin = np.stack([e.finite for e in entries])
        uq = UQResult(mean, sstd, cstd, np.zeros(len(rows), bool), fin)
        with self._lock:
            self.cache_hit_requests += 1
            st = self._client_stat(client)
            st["cache_hits"] += 1
            st["served"] += 1
        if self.monitor is not None:
            self.monitor.incr("serve.cache_hits")
        fut.set_result((uq.mean, uq))
        return fut

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: Optional[float] = None):
        """Flush everything still pending, then stop the dispatcher.

        ``timeout`` bounds the wait for the drain (seconds; None = wait
        for it) — a caller with its own shutdown deadline (PAL.shutdown)
        must not hang behind a wedged dispatch.  The dispatcher is a
        daemon thread, so an abandoned drain cannot keep the process
        alive."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
            self._space.notify_all()     # unblock backpressured submitters
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort: don't leak the dispatcher thread
        try:
            self.close()
        except BaseException:  # noqa: BLE001  (interpreter teardown)
            pass

    # --------------------------------------------------------- dispatcher
    def _oldest_enqueue_locked(self) -> Optional[float]:
        heads = [q[0].t_enqueue for q in self._queues.values() if q]
        return min(heads) if heads else None

    def _deadline_left_locked(self) -> Optional[float]:
        """Seconds until the oldest pending request's deadline (None when
        nothing is pending).  Uses the EFFECTIVE deadline — static
        ``max_wait_ms`` or the controller-steered value."""
        oldest = self._oldest_enqueue_locked()
        if oldest is None:
            return None
        return self._wait_ms / 1e3 - (time.perf_counter() - oldest)

    def _due_locked(self) -> bool:
        if self._n_pending == 0:
            return False
        if self._pending_rows >= self.cfg.max_batch:
            return True
        left = self._deadline_left_locked()
        return left is not None and left <= 0.0

    def _take_locked(self) -> List[_Pending]:
        """Compose one microbatch by deficit round-robin over the
        backlogged clients: each scheduling pass credits every open
        client a row quantum (its share of ``max_batch``), which it
        spends on whole head-of-line requests — so a flooding tenant is
        bounded to its share while idle tenants' credit never hoards
        (deficit resets when a client's queue empties).  A request larger
        than ``max_batch`` is dispatched alone when it reaches the front
        (the engine's shape buckets absorb it)."""
        max_b = self.cfg.max_batch
        order = [c for c in self._rr if self._queues.get(c)]
        if not order:
            return []
        start = self._rr_pos % len(order)
        order = order[start:] + order[:start]    # rotate the head client
        self._rr_pos += 1
        quantum = max(1, max_b // len(order))
        took: List[_Pending] = []
        rows = 0
        open_ = set(order)
        while rows < max_b and open_:
            for c in order:
                if c not in open_:
                    continue
                q = self._queues[c]
                # credit capped at max_batch: enough to afford any request
                # that can fit, never an unbounded hoard
                self._deficit[c] = min(self._deficit[c] + quantum,
                                       float(max_b))
                while q:
                    need = len(q[0].rows)
                    if took and rows + need > max_b:
                        open_.discard(c)      # no space left this batch
                        break
                    if took and need > self._deficit[c]:
                        break                 # share spent; next pass
                    p = q.popleft()
                    took.append(p)
                    rows += need
                    self._deficit[c] -= need
                    if rows >= max_b:
                        break
                if not q:
                    self._deficit[c] = 0.0    # idle clients don't hoard
                    open_.discard(c)
                if rows >= max_b:
                    break
        self._pending_rows -= rows
        self._n_pending -= len(took)
        return took

    def _run(self):
        while True:
            with self._cv:
                while not self._closed and not self._due_locked():
                    self._cv.wait(self._deadline_left_locked())
                if self._closed and self._n_pending == 0:
                    return
                took = self._take_locked()
                if took:
                    self._space.notify_all()     # backlog shrank
            if took:
                self._dispatch(took)

    def _dispatch(self, took: List[_Pending]):
        from repro_torch.core.acquisition import UQResult

        merged = [r for p in took for r in p.rows]
        # generation BEFORE the dispatch: if a weight refresh lands while
        # we compute, the fill is tagged stale and the next lookup's
        # note_generation drops it
        gen = self._generation() if self.cache is not None else None
        try:
            if not merged:      # all-empty microbatch: server short-circuit
                res = self.server.predict([])
                for p in took:
                    p.future.set_result(res)
                return          # no engine dispatch -> not a dispatch
            _, uq = self.server.predict(merged)
        except BaseException as e:  # noqa: BLE001 — deliver, don't die
            self._note_dispatch_failure()
            for p in took:
                p.future.set_exception(e)
            return
        self._note_dispatch_success(took)
        if self.monitor is not None:
            self.monitor.incr("serve.queue_dispatches")
            self.monitor.incr("serve.queue_batched_requests", len(took))
        if self.cache is not None:
            self.cache.fill(merged, uq, gen)
        fin = uq.finite_members
        off = 0
        now = time.perf_counter()
        lats = []
        for p in took:
            n = len(p.rows)
            sl = slice(off, off + n)
            part = UQResult(uq.mean[sl], uq.scalar_std[sl],
                            uq.component_std[sl], uq.mask[sl],
                            fin[sl] if fin is not None else None)
            p.future.set_result((part.mean, part))
            if n:
                lats.append((now - p.t_enqueue) * 1e3)
            off += n
        if self._lat_ctrl is not None and lats:
            self._observe_latency(lats)

    def _observe_latency(self, lats_ms: List[float]):
        """Feed served-request latencies to the deadline controller; one
        PI update per ``latency_window`` samples (the controller's host math runs
        in the dispatcher thread, off the submit path)."""
        self._lat_samples.extend(lats_ms)
        if len(self._lat_samples) < self.cfg.latency_window:
            return
        samples, self._lat_samples = self._lat_samples, []
        p99 = float(np.percentile(samples, 99))
        self._lat_state = self._lat_ctrl.update(self._lat_state, p99)
        new_wait = self._lat_ctrl.wait_ms(self._lat_state)
        with self._lock:
            self._p99_last = p99
            self._wait_ms = new_wait
        if self.monitor is not None:
            self.monitor.incr("serve.latency_updates")

    # ----------------------------------------------------- circuit breaker
    def _client_stat(self, client: str) -> Dict[str, int]:
        st = self._per_client.get(client)
        if st is None:
            st = {"served": 0, "shed": 0, "cache_hits": 0}
            self._per_client[client] = st
        return st

    def _note_dispatch_failure(self):
        with self._lock:
            self.dispatch_failures += 1
            if self.cfg.breaker_failures <= 0:
                return
            self._consec_failures += 1
            if (self._breaker_state == "half_open"
                    or self._consec_failures >= self.cfg.breaker_failures):
                if self._breaker_state != "open":
                    self.breaker_opens += 1
                    if self.monitor is not None:
                        self.monitor.incr("serve.breaker_opens")
                self._breaker_state = "open"
                self._opened_at = time.monotonic()

    def _note_dispatch_success(self, took: List[_Pending]):
        """Breaker reset + dispatch/amortization/per-client counters, all
        under the one lock ``health()`` snapshots — the report can never
        observe a dispatch count without its request counts."""
        with self._lock:
            self._consec_failures = 0
            if self._breaker_state != "closed":
                self._breaker_state = "closed"
            self.dispatches += 1
            self.batched_requests += len(took)
            for p in took:
                self._client_stat(p.client)["served"] += 1

    def health(self) -> dict:
        """Degradation-aware serving health (surfaced in ``PAL.report()``):
        breaker state plus every counter that explains it — taken under
        ONE lock so the snapshot is consistent.  ``clients`` maps tenant
        -> ``{served, shed, cache_hits}``; ``effective_wait_ms`` /
        ``p99_ms`` expose the adaptive-deadline controller; ``cache`` is
        the answer cache's own counters when one is installed."""
        with self._lock:
            h = {
                "breaker_state": self._breaker_state,
                "consecutive_failures": self._consec_failures,
                "breaker_opens": self.breaker_opens,
                "dispatch_failures": self.dispatch_failures,
                "shed_requests": self.shed_requests,
                "rate_limited": self.rate_limited,
                "cache_hit_requests": self.cache_hit_requests,
                "pending_rows": self._pending_rows,
                "dispatches": self.dispatches,
                "batched_requests": self.batched_requests,
                "effective_wait_ms": self._wait_ms,
                "p99_ms": self._p99_last,
                "clients": {c: dict(st)
                            for c, st in self._per_client.items()},
            }
        if self.cache is not None:
            h["cache"] = self.cache.stats()
        return h
