"""Ordered lanes of mesh calls: one order for every rank of a mesh.

In the reference, ``PAL`` on a mesh is one program under one controller:
whichever thread dispatches, the dispatch lays itself out over the whole
mesh.  Here a mesh is one process per device (``launch/mesh.py``), and a
call that reaches a collective (a sharded bucket, the trainer's gathers,
the fleet's) must be made by every rank of the mesh, in the same order.
PAL's exchange, Manager, serving and trainer threads run on rank 0 only,
so each call they make on a mesh object goes through a ``Lane``:

  * on the leader (the mesh's first rank) one thread owns the lane's
    objects.  Other threads submit ``(object, method, args)`` and block on
    a future.  For each call the lane thread first sends the call (a small
    header and the pickled host arguments, as one unit, on the lane's own
    gloo control group), then makes it;
  * on every other rank the lane's thread receives each call and makes it
    on its own objects, in the leader's order.  Results stay on that rank;
  * inside a call, ``decide`` sends the leader's yes/no to every rank (the
    trainer's stop-early decision after each step).

A lane makes calls from ``start``.  ``PAL`` starts the leader's lanes at
construction and a follower's in ``PAL.start()`` (``run()``), so no call
reaches a follower's objects before its owner is done with them; until
then the leader's first send waits for the follower's receive.  A
follower that has not started within ``TIMEOUT_S`` of that send breaks
the leader's lane with a ``LaneError`` that names it.

Each lane has its own control group and its own ``Mesh.twin`` for its
objects' collectives, so two lanes run side by side without sharing a
group.  Every wait on another rank is bounded by ``TIMEOUT_S``: the
control messages, the twin's collectives and a handoff.  An idle leader
sends a keep-alive every ``TIMEOUT_S / 4``.  A call that raises on any
rank breaks that rank's lane (``on_error``): its later calls raise, and a
peer waiting on it fails within the timeout.  The leader's ``close``
sends the stop token, which a follower hands to ``on_stop``.  Then
``close`` destroys the lane's groups on every rank (``release``), once
the lane's thread has ended, so a process that runs loop after loop keeps
no group or gloo thread of a finished one.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import functools
import pickle
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import distributed

TIMEOUT_S = 120.0
_CHUNK = 4096         # bytes of the first broadcast (length + payload head)


class LaneError(RuntimeError):
    """A lane call failed on this rank (its traceback in the message), or
    the lane broke before the call could be made."""


@dataclasses.dataclass
class _Call:
    name: str = ""
    method: str = ""
    args: tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    local: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stop: Any = None           # a stop token: the lane's last message
    future: concurrent.futures.Future = dataclasses.field(
        default_factory=concurrent.futures.Future)


class Lane:
    """One ordered lane over the ranks of ``mesh`` (see the module
    docstring).  ``mesh`` is the grid whose twin (``self.mesh``) the
    lane's objects are built on; ``device`` is bound in the lane's thread.
    ``on_stop(token)`` runs on a follower when the leader closes the lane;
    ``on_error(exc)`` runs on any rank whose lane breaks.  Every rank of
    the process group must make the same lanes in the same order."""

    def __init__(self, name: str, mesh, device: torch.device, *,
                 on_stop: Callable[[Any], None],
                 on_error: Callable[[BaseException], None]):
        self.name = name
        self.leader_rank = int(mesh.ranks.reshape(-1)[0])
        self.leader = dist.get_rank() == self.leader_rank
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        self.group = distributed.control_group(
            sorted(int(r) for r in mesh.ranks.reshape(-1)), timeout)
        self.mesh = mesh.twin(timeout)
        self.device = torch.device(device)
        self.objects: Dict[str, Any] = {}
        self._on_stop, self._on_error = on_stop, on_error
        self._queue: "queue.Queue[_Call]" = queue.Queue()
        self._lock = threading.Lock()
        self._error: Optional[LaneError] = None
        self._closed = False
        self._stopped = False      # the stop token went through
        self._thread: Optional[threading.Thread] = None
        # the leader's control cost: host seconds sending each call (the
        # first apart too: it waits for a follower's start), and the
        # per-step decisions' broadcasts (both counted on every rank)
        self.calls = 0
        self.send_s = 0.0
        self.first_send_s = 0.0
        self.decides = 0
        self.decide_s = 0.0

    # ------------------------------------------------------------- messages
    def _send(self, msg) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        head = torch.zeros(_CHUNK, dtype=torch.uint8)
        head[:8].view(torch.int64)[0] = len(data)
        first = data[:_CHUNK - 8]
        head[8:8 + len(first)] = torch.frombuffer(bytearray(first),
                                                  dtype=torch.uint8)
        dist.broadcast(head, src=self.leader_rank, group=self.group)
        if len(data) > len(first):
            rest = torch.frombuffer(bytearray(data[len(first):]),
                                    dtype=torch.uint8)
            dist.broadcast(rest, src=self.leader_rank, group=self.group)

    def _recv(self):
        head = torch.zeros(_CHUNK, dtype=torch.uint8)
        dist.broadcast(head, src=self.leader_rank, group=self.group)
        n = int(head[:8].view(torch.int64)[0])
        data = head[8:8 + min(n, _CHUNK - 8)].numpy().tobytes()
        if n > len(data):
            rest = torch.empty(n - len(data), dtype=torch.uint8)
            dist.broadcast(rest, src=self.leader_rank, group=self.group)
            data += rest.numpy().tobytes()
        return pickle.loads(data)

    def share(self, obj: Any = None) -> Any:
        """The leader's ``obj`` on every rank (a follower's is ignored).
        Only before ``start``: afterwards the control group is the lane
        thread's."""
        if self._thread is not None:
            raise RuntimeError(f"lane {self.name}: share() after start()")
        if self.leader:
            self._send(obj)
            return obj
        return self._recv()

    def decide(self, flag: bool) -> bool:
        """The leader's ``flag`` on every rank; only inside a lane call (on
        the lane's thread, where every rank makes the same decisions)."""
        if threading.current_thread() is not self._thread:
            raise RuntimeError(f"lane {self.name}: decide() outside a call")
        t = torch.tensor([bool(flag) if self.leader else 0],
                         dtype=torch.uint8)
        t0 = time.perf_counter()
        dist.broadcast(t, src=self.leader_rank, group=self.group)
        self.decide_s += time.perf_counter() - t0
        self.decides += 1
        return bool(t[0])

    # ---------------------------------------------------------------- calls
    def register(self, name: str, obj: Any) -> None:
        self.objects[name] = obj

    @property
    def open(self) -> bool:
        """Started, not closed and not broken: calls are taken."""
        return (self._thread is not None and not self._closed
                and self._error is None)

    def start(self) -> None:
        """Start the lane's thread (once: later calls do nothing)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._lead if self.leader else self._follow,
            name=f"lane-{self.name}", daemon=True)
        self._thread.start()

    def call(self, name: str, method: str, *args,
             _local: Optional[Dict[str, Any]] = None, **kwargs) -> Any:
        """Leader: ``objects[name].method(*args, **kwargs)`` on every rank
        in the lane's order; returns the leader's result.  ``_local`` are
        leader-only keyword arguments (not sent)."""
        if not self.leader or self._thread is None:
            raise RuntimeError(f"lane {self.name}: only the leader's "
                               "started lane takes calls")
        if threading.current_thread() is self._thread:
            raise RuntimeError(f"lane {self.name}: a call inside a call")
        c = _Call(name, method, args, kwargs, dict(_local or {}))
        self._put(c)
        return c.future.result()

    def _put(self, c: _Call) -> None:
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._closed:
                raise LaneError(f"lane {self.name} is closed")
            if c.stop is not None:
                self._closed = True
            self._queue.put(c)

    def _run(self, c: _Call) -> Any:
        fn = getattr(self.objects[c.name], c.method)
        return fn(*c.args, **c.kwargs, **c.local)

    def _bind_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _lead(self) -> None:
        self._bind_device()
        c = None
        try:
            while True:
                try:
                    c = self._queue.get(timeout=TIMEOUT_S / 4)
                except queue.Empty:
                    c = None
                    self._send(("ping",))
                    continue
                if c.stop is not None:
                    self._send(("stop", c.stop))
                    self._stopped = True
                    c.future.set_result(None)
                    return
                t0 = time.perf_counter()
                self._send(("call", c.name, c.method, c.args, c.kwargs))
                dt = time.perf_counter() - t0
                if self.calls == 0:
                    self.first_send_s = dt
                self.send_s += dt
                self.calls += 1
                c.future.set_result(self._run(c))
        except BaseException as e:  # noqa: BLE001 — reported, lane broken
            self._fail(e, c)

    def _follow(self) -> None:
        self._bind_device()
        try:
            while True:
                msg = self._recv()
                if msg[0] == "ping":
                    continue
                if msg[0] == "stop":
                    self._closed = self._stopped = True
                    self._on_stop(msg[1])
                    return
                _, name, method, args, kwargs = msg
                self.calls += 1
                self._run(_Call(name, method, args, kwargs))
        except BaseException as e:  # noqa: BLE001 — reported, lane broken
            self._fail(e, None)

    def _fail(self, e: BaseException, c: Optional[_Call]) -> None:
        err = LaneError(f"lane {self.name} on rank {dist.get_rank()}: "
                        f"{e!r}\n{traceback.format_exc()}")
        # the text is kept; the frames' locals (a group, buffers) are not
        traceback.clear_frames(e.__traceback__)
        err.__cause__ = e
        with self._lock:
            self._error = err
            pending = [c] if c is not None and not c.future.done() else []
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        self._on_error(err)             # before the callers see the error
        for p in pending:
            p.future.set_exception(err)

    def close(self, token: Any) -> bool:
        """Leader: send ``token`` as the lane's last message (after the
        calls queued before it) and join the thread.  Follower: join the
        thread (it ends at the leader's stop or a failure).  Both wait at
        most ``TIMEOUT_S``; a broken or closed lane sends nothing, and a
        lane never started joins nothing.  Then ``release``, whose result
        it returns."""
        if self._thread is not None:
            if self.leader and self._error is None:
                try:
                    self._put(_Call(stop=token))
                except LaneError:
                    pass                       # closed or broken already
            self._thread.join(TIMEOUT_S)
        return self.release()

    def release(self) -> bool:
        """Destroy the lane's process groups on this rank: the control
        group, then its mesh twin's (``Mesh.release``), in the order they
        were made.  When the stop token went through, the ranks first meet
        on the control group, so no rank closes a socket its peer still
        reads; a broken or never started lane destroys them at once (a
        peer still waiting on one fails then).  While the lane's thread
        still runs (a call that outlived ``close``'s join), nothing is
        destroyed: the thread may be blocked in a group.  Returns whether
        the groups are gone; a later call, once the thread has ended,
        destroys them."""
        if self.group is None:
            return True
        if self._thread is not None and self._thread.is_alive():
            return False
        group, self.group = self.group, None   # its gloo threads go with it
        if self._stopped and self._error is None:
            try:
                dist.all_reduce(torch.zeros(1), group=group)
            except RuntimeError:
                pass                # the peer is gone: nothing to wait for
        if dist.is_initialized():
            dist.destroy_process_group(group)
        self.mesh.release()
        return True


class Proxy:
    """``target`` on the leader with ``methods`` made ``lane`` calls of the
    lane object ``name``; every other attribute is the target's own (read
    on the leader only: counters and settings, never a collective)."""

    def __init__(self, lane: Lane, name: str, target: Any, methods):
        self._lane, self._name = lane, name
        self._methods = frozenset(methods)
        self.target = target

    def __getattr__(self, attr: str):
        if attr in self._methods:
            return functools.partial(self._lane.call, self._name, attr)
        return getattr(self.target, attr)


def local(obj: Any) -> Any:
    """The object behind a ``Proxy`` (``obj`` itself otherwise)."""
    return obj.target if isinstance(obj, Proxy) else obj
