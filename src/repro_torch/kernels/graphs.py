"""CUDA-graph capture for the whole port, with the kernels' launch counters
kept true.

``capture(stages, stream, warmup=...)`` is the one place the port opens a
CUDA-graph capture: every capture site (the committee trainer's step, the
LM training step, the committee engine's buckets and ``score_after``
programs, a sharded bucket's stages, ``CapturedProgram`` for the LM
serving engine and the oracles) goes through it.  Under
``platform.capture_lock`` (one capture at a time in the process, its
warm-up included) it runs the site's ``warmup`` (the kernel libraries
load, cuBLAS initialises and any constant a model caches is built: none of
that may happen under capture), then captures each stage as one CUDA
graph on ``stream`` in ``thread_local`` mode (``torch.cuda.graph`` empties
the allocator's caches first, so the warm-ups' temporaries go back to the
card before a graph's pool takes its own).  Around the captures it reads
each kernel wrapper's ``captured`` count, so the caller knows the launches
one replay makes.  A capture that fails raises; there is no retry and no
eager fallback.

The cyclic collector runs in whichever thread crosses its threshold, the
capturing one included, and a cycle it frees can hold CUDA graphs (a
dropped engine's, a finished run's).  Destroying a graph in the capturing
thread while its capture is open is refused (``CUDAGraph`` only warns,
"operation not permitted when stream is capturing") and invalidates the
capture.  So ``capture`` keeps the collector off while its graphs are
captured and restores its prior state after them, on error too.  Every
capture of the port goes through it under the one lock, so no collection
runs in any thread while any window is open; the garbage waits for the
next collection after the window.

A device-wide synchronize made by another thread while a capture is open
invalidates that capture (the synchronize fails with
``cudaErrorStreamCaptureUnsupported``, the capture with
``cudaErrorStreamCaptureInvalidated``; ``thread_local`` mode does not
shield it), so the port makes none: a caller waits for its own stream or
event, which leaves another thread's capture alone.

Two frees break the process when another thread makes them beside a
capture, and both happen when a finished owner is freed (by the
collector, in whatever thread it runs) while a live one captures.  torch
2.11's CUDA generator state keeps every graph in one
``std::unordered_set`` with no lock (``registered_graphs_``,
``ATen/cuda/CUDAGeneratorImpl.h``), which ``capture_begin`` (run without
the GIL) inserts into and a graph's destructor erases from.  And its
pinned host allocator records an event on every stream a freed block was
copied on (``CachingHostAllocatorImpl::free``,
``ATen/core/CachingHostAllocator.h``), also on a stream that another
thread is capturing: torch's pool hands out 32 streams per device in
turn, so a finished owner's stream is in time a live owner's.  So the
port destroys its graphs and frees the pinned buffers its engines copy
through only under the capture lock: every graph it captures is a
``Graph``, and a ``Graph`` or an engine's bucket that is dropped hands
what it held to ``release``, whose list is emptied under
``platform.capture_lock``, at once when the lock is free, else by
``capture`` before it opens its next window or after it closes it.
``pending()`` counts what waits.

``CapturedProgram(fn, stream)`` is one such graph with two runs of ``fn``
(or ``warmup``) as the warm-up; ``replay()`` replays the graph on the
current stream and adds its launches to the wrappers' counters with their
``count_replays``.  ``out`` is what ``fn`` returned under capture: tensors
the graph rewrites at every replay.

``PerShape(fn, device)`` runs ``fn`` of one device tensor as one
``CapturedProgram`` per input shape, on a stream of its own (an oracle
worker's: the legacy default stream cannot be captured).
"""
from __future__ import annotations

import contextlib
import copy
import gc
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import committee_uq, flash_attention, ssd, wkv6
from repro_torch.launch import platform

KERNELS = (committee_uq, flash_attention, ssd, wkv6)


def _captured():
    return [copy.copy(m.captured) for m in KERNELS]


def _launches(after, before):
    """Launches recorded between two ``_captured`` reads, per kernel (an
    int, or flash_attention's counts by counter name)."""
    return [{k: a[k] - b[k] for k in a} if isinstance(a, dict) else a - b
            for a, b in zip(after, before)]


_doomed: List[Any] = []      # what dropped owners held, to be freed


def release(held: dict) -> None:
    """Free what an owner held (its ``vars``: emptied here) under the
    capture lock: at once if this thread can take it, else when its
    holder is done.  Call it from the owner's ``__del__``."""
    _doomed.append(dict(held))
    held.clear()
    _destroy_doomed(blocking=False)


class Graph:
    """One captured CUDA graph of the port.  ``replay()`` replays it on
    the current stream.  Dropped, it leaves its CUDA graph to be destroyed
    under the capture lock (see the module docstring)."""

    def __init__(self, cuda_graph):
        self.cuda_graph = cuda_graph

    def replay(self) -> None:
        self.cuda_graph.replay()

    def __del__(self):
        release(vars(self))


def _destroy_doomed(blocking: bool = True) -> None:
    """Free what ``_doomed`` holds if this thread can take the capture
    lock (without waiting unless ``blocking``); else its holder frees
    it."""
    if not _doomed or not platform.capture_lock.acquire(blocking=blocking):
        return
    try:
        _drain()
    finally:
        platform.capture_lock.release()


def _drain() -> None:
    """Free what ``_doomed`` holds (the caller holds the capture lock and
    no window is open)."""
    while _doomed:
        _doomed.pop()


def pending() -> int:
    """The releases not freed yet."""
    return len(_doomed)


class Captured(NamedTuple):
    """What ``capture`` made: one ``Graph`` and one output per stage, and
    the kernels' launches one replay of all the graphs makes
    (``_launches``)."""
    graphs: List[Graph]
    outs: List[Any]
    launches: List[Any]


def capture(stages: Sequence[Callable[[], Any]], stream: torch.cuda.Stream,
            *, warmup: Callable[[], Any], pool=None) -> Captured:
    """Run ``warmup()`` once, then capture each of ``stages`` as a CUDA
    graph on ``stream``, in order, all under ``platform.capture_lock`` with
    ``stream`` current (see the module docstring).  ``pool``: a
    ``torch.cuda.graph_pool_handle()`` the graphs share.  What was
    released before is freed first, and what is released meanwhile after
    the last window."""
    with platform.capture_lock, torch.cuda.stream(stream):
        try:
            _drain()
            warmup()
            before = _captured()
            graphs, outs = [], []
            with _collector_paused():
                for fn in stages:
                    graph = Graph(torch.cuda.CUDAGraph())
                    graphs.append(graph)
                    with torch.cuda.graph(graph.cuda_graph, pool=pool,
                                          stream=stream,
                                          capture_error_mode="thread_local"):
                        outs.append(fn())
            return Captured(graphs, outs, _launches(_captured(), before))
        finally:
            _drain()


@contextlib.contextmanager
def _collector_paused():
    """The cyclic collector off until the block ends; its prior state back
    after, on error too."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CapturedProgram:
    """``fn`` captured as a CUDA graph (see the module docstring).
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    graphs that never run at the same time."""

    def __init__(self, fn: Callable[[], Any], stream: torch.cuda.Stream, *,
                 pool=None, warmup: Optional[Callable[[], Any]] = None):
        warm = fn if warmup is None else warmup

        def twice():
            for _ in range(2):
                warm()

        (self.graph,), (self.out,), self.launches = capture(
            [fn], stream, warmup=twice, pool=pool)
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        for kernel, n in zip(KERNELS, self.launches):
            if n:
                kernel.count_replays(n)
        return self.out


class PerShape:
    """``fn`` of one device tensor as one ``CapturedProgram`` per input
    shape, on a stream of its own: a call copies a host tensor into that
    shape's buffer, replays its graph (captured at the shape's first
    call) and returns the output on the host.  ``captures`` counts the
    graphs."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], device):
        self.fn = fn
        self.device = device
        self._stream = torch.cuda.Stream(device)
        self._graphs = {}           # shape -> (input buffer, graph)
        self.captures = 0

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        with torch.cuda.stream(self._stream):
            entry = self._graphs.get(tuple(host.shape))
            if entry is None:
                buf = host.to(self.device)
                entry = self._graphs[tuple(host.shape)] = (
                    buf, CapturedProgram(lambda: self.fn(buf), self._stream))
                self.captures += 1
            buf, graph = entry
            buf.copy_(host)
            return graph.replay().cpu()
