"""MPI-shaped non-blocking transport (paper SI S1, Figure 4).

The paper's kernels communicate via mpi4py Isend/Irecv/Test.  This module
keeps that API surface — ``Channel.isend`` / ``Channel.irecv`` returning
``Request`` objects with ``test()`` / ``wait()`` — so the controller logic is
a faithful port, while the realization is swappable:

* ``InProcessBackend`` (default): thread-safe queues.  JAX dispatch releases
  the GIL inside compiled code, so kernel pools overlap on one host.
* A ``jax.distributed`` process-group backend is the documented multi-host
  path (same API; each kernel pool is a process group).  Not exercisable in
  this container — see DESIGN.md §2.

Matching the paper's constraint that "data transferred among kernels should
be arranged as 1-D Numpy numerical arrays", payloads are validated as numpy
arrays (or pytrees thereof) when ``strict_arrays`` is set; fixed_size_data
mirrors the paper's size-prenegotiation knob (SI S3) and is validated here.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np


class TransportError(RuntimeError):
    pass


# ---------------------------------------------------------------- chaos hook
# Process-wide fault-injection point (core/chaos.ChaosInjector), installed by
# the runtime when a FaultPlan is supplied.  ``Channel.isend`` consults it at
# the ``transport.send`` site (rank = channel name), which lets a plan
# exercise message-path failures without subclassing the transport.
_CHAOS = None


def install_chaos(injector) -> None:
    global _CHAOS
    _CHAOS = injector


def uninstall_chaos() -> None:
    global _CHAOS
    _CHAOS = None


class Request:
    """Non-blocking operation handle, mirroring mpi4py.MPI.Request."""

    def __init__(self):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    # -- producer side -----------------------------------------------------
    def _complete(self, value: Any = None):
        self._value = value
        self._done.set()

    def _fail(self, err: BaseException):
        self._error = err
        self._done.set()

    # -- consumer side (paper: req_data.Test() in the retrain loop) --------
    def test(self) -> bool:
        return self._done.is_set()

    Test = test  # mpi4py capitalization, used verbatim by ported user code

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("Request.wait timed out")
        if self._error is not None:
            raise self._error
        return self._value

    Wait = wait

    @property
    def value(self) -> Any:
        if not self._done.is_set():
            raise TransportError("value read before completion")
        if self._error is not None:
            raise self._error
        return self._value


def _check_payload(data: Any, fixed_size: Optional[Tuple[int, ...]]):
    """Paper: MPI messages require predetermined sizes to be efficient."""
    if isinstance(data, np.ndarray):
        if fixed_size is not None and tuple(data.shape) != fixed_size:
            raise TransportError(
                f"fixed_size_data violated: got {data.shape}, "
                f"expected {fixed_size}")


class Channel:
    """Point-to-point channel with non-blocking send/recv semantics."""

    def __init__(self, name: str = "chan", maxsize: int = 0,
                 fixed_size: Optional[Tuple[int, ...]] = None):
        self.name = name
        self._q: "queue.Queue[Tuple[Any, Request]]" = queue.Queue(maxsize)
        self._pending_recv: Deque[Request] = collections.deque()
        self._lock = threading.Lock()
        self.fixed_size = fixed_size
        self.sent = 0
        self.received = 0

    # ------------------------------------------------------------------ tx
    def isend(self, data: Any) -> Request:
        if _CHAOS is not None:
            _CHAOS.check("transport.send", rank=self.name)
        _check_payload(data, self.fixed_size)
        req = Request()
        with self._lock:
            if self._pending_recv:
                rreq = self._pending_recv.popleft()
                rreq._complete(data)
                req._complete()
                self.sent += 1
                self.received += 1
                return req
            self._q.put((data, req))
            self.sent += 1
        return req

    def send(self, data: Any):
        self.isend(data)  # queue-backed: send completes on enqueue

    # ------------------------------------------------------------------ rx
    def irecv(self) -> Request:
        req = Request()
        with self._lock:
            try:
                data, sreq = self._q.get_nowait()
            except queue.Empty:
                self._pending_recv.append(req)
                return req
            sreq._complete()
            req._complete(data)
            self.received += 1
        return req

    def recv(self, timeout: Optional[float] = None) -> Any:
        """Blocking receive.  On timeout the posted request is CANCELLED —
        otherwise it stays parked in the pending queue and silently consumes
        the next message (jobs delivered to a receiver that stopped waiting
        vanish; this deadlocked the oracle pool whenever dispatch started
        later than the workers' first poll)."""
        req = self.irecv()
        try:
            return req.wait(timeout)
        except TimeoutError:
            with self._lock:
                try:
                    self._pending_recv.remove(req)
                except ValueError:
                    pass  # raced: isend completed it under the lock
            if req.test():
                return req.value
            raise

    def poll(self) -> bool:
        with self._lock:
            return not self._q.empty()

    def qsize(self) -> int:
        return self._q.qsize()


class Communicator:
    """A set of named ranks with channels between them (one MPI_COMM analog).

    Collective helpers mirror the paper's controller usage: gather from a
    pool, broadcast/scatter to a pool.
    """

    def __init__(self, name: str = "comm"):
        self.name = name
        self._channels: Dict[Tuple[str, str], Channel] = {}
        self._lock = threading.Lock()

    def channel(self, src: str, dst: str) -> Channel:
        key = (src, dst)
        with self._lock:
            if key not in self._channels:
                self._channels[key] = Channel(f"{self.name}:{src}->{dst}")
            return self._channels[key]

    # ---------------------------------------------------------- collectives
    def gather(self, srcs: Iterable[str], dst: str,
               timeout: Optional[float] = None) -> List[Any]:
        """Blocking gather (sorted by rank, as the paper requires)."""
        return [self.channel(s, dst).recv(timeout) for s in srcs]

    def broadcast(self, src: str, dsts: Iterable[str], data: Any):
        for d in dsts:
            self.channel(src, d).isend(data)

    def scatter(self, src: str, dsts: Iterable[str], datas: Iterable[Any]):
        dsts, datas = list(dsts), list(datas)
        if len(dsts) != len(datas):
            raise TransportError(
                f"scatter arity mismatch: {len(dsts)} ranks, "
                f"{len(datas)} payloads")
        for d, x in zip(dsts, datas):
            self.channel(src, d).isend(x)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                f"{s}->{d}": {"sent": c.sent, "received": c.received,
                              "backlog": c.qsize()}
                for (s, d), c in self._channels.items()
            }


class StopToken:
    """Sentinel broadcast on shutdown (paper: stop_run signalling)."""

    def __init__(self, origin: str, reason: str = ""):
        self.origin = origin
        self.reason = reason
        self.timestamp = time.time()

    def __repr__(self):
        return f"StopToken(origin={self.origin!r}, reason={self.reason!r})"


_counter = itertools.count()


def unique_rank(prefix: str) -> str:
    return f"{prefix}{next(_counter)}"
