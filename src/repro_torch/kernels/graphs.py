"""CUDA-graph capture of a program that launches the port's kernels, with
the kernels' launch counters kept true.

``CapturedProgram(fn, stream)`` runs ``fn`` (or ``warmup``) twice on
``stream`` as the warm-up (the kernel libraries load, cuBLAS initialises
and any constant a model caches is built: none of that may happen under
capture), then captures ``fn`` as one CUDA graph on ``stream``, all under
``platform.capture_lock`` (one capture at a time in the process: the
committee engine and trainer take the same lock).  Around the capture it
reads each kernel wrapper's ``captured`` count, so it knows the launches
one replay makes; ``replay()`` replays the graph on the current stream and
adds those launches to the wrappers' counters with their
``count_replays``.  ``out`` is what ``fn`` returned under capture: tensors
the graph rewrites at every replay.  A capture that fails raises; there
is no eager fallback.

``PerShape(fn, device)`` runs ``fn`` of one device tensor as one
``CapturedProgram`` per input shape, on a stream of its own (an oracle
worker's: the legacy default stream cannot be captured).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Optional

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


class CapturedProgram:
    """``fn`` captured as a CUDA graph (see the module docstring).
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    graphs that never run at the same time."""

    def __init__(self, fn: Callable[[], Any], stream: torch.cuda.Stream, *,
                 pool=None, warmup: Optional[Callable[[], Any]] = None):
        warm = fn if warmup is None else warmup
        with platform.capture_lock, torch.cuda.stream(stream):
            for _ in range(2):
                warm()
            # the warm-ups' temporaries go back to the card before the
            # graph's pool takes its own
            torch.cuda.empty_cache()
            before = _captured()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn()
            self.launches = _launches(_captured(), before)
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
