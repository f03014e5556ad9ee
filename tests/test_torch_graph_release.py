"""When the port frees its CUDA graphs and its engines' pinned buffers, on
the CPU.  torch 2.11 keeps every CUDA graph in one set with no lock (its
CUDA generator state's ``registered_graphs_``): ``capture_begin`` inserts
into it without the GIL, and a graph's destructor erases from it in
whatever thread drops the graph.  Its pinned host allocator records an
event on each stream a freed block was copied on, also on a stream
another thread captures (torch's stream pool reuses a finished owner's
stream).  Either, beside another thread's capture, corrupts the process.
``kernels.graphs`` hands every graph it captures out as a
``graphs.Graph``; a dropped ``Graph`` or engine bucket hands what it held
to ``graphs.release``, freed under ``platform.capture_lock``, where no
capture runs.  Here stand-in graph objects record, when they are
destroyed, whether the lock was held and whether a capture window was
open, with ``torch.cuda.graph`` replaced by a recording context (the card
half is ``tests/test_torch_capture_cuda.py``)."""
import contextlib
import gc
import threading
import time

import pytest
import torch

from repro_torch.kernels import graphs
from repro_torch.launch import platform


class _World:
    """Stands in for ``torch.cuda.graph`` and ``torch.cuda.CUDAGraph``.
    ``log`` gets ("open",), ("close",) per window and ("destroyed",
    lock held, window open, thread name) per stand-in graph destroyed;
    ``begin_s`` is how long a window's opening takes with the GIL
    released (``capture_begin``'s)."""

    def __init__(self, begin_s=0.0):
        self.log = []
        self.open = 0
        self.made = 0
        world = self

        class Graph:
            def __init__(self):
                world.made += 1
                self.replays = 0

            def replay(self):
                self.replays += 1

            def __del__(self):
                world.log.append(("destroyed",
                                  platform.capture_lock.locked(),
                                  world.open > 0,
                                  threading.current_thread().name))

        class Window:
            def __init__(self, graph, pool=None, stream=None,
                         capture_error_mode="global"):
                assert isinstance(graph, Graph)

            def __enter__(self):
                world.open += 1
                world.log.append(("open",))
                if begin_s:
                    time.sleep(begin_s)

            def __exit__(self, *exc):
                world.log.append(("close",))
                world.open -= 1

        self.Graph, self.Window = Graph, Window

    def destroyed(self):
        return [e for e in self.log if e[0] == "destroyed"]


@pytest.fixture
def world(monkeypatch):
    gc.collect()                # other tests' garbage freed before
    graphs._destroy_doomed()
    w = _World()
    monkeypatch.setattr(torch.cuda, "graph", w.Window)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", w.Graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    yield w
    graphs._destroy_doomed()


def _lock_held_elsewhere():
    """Hold the capture lock in another thread until the returned
    function is called."""
    held, release = threading.Event(), threading.Event()

    def holder():
        with platform.capture_lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(10)

    def done():
        release.set()
        t.join(10)
    return done


def _one(world):
    return graphs.capture([lambda: None], "stream",
                          warmup=lambda: None).graphs[0]


def test_capture_hands_out_port_graphs_that_replay(world):
    got = graphs.capture([lambda: 1, lambda: 2], "stream",
                         warmup=lambda: None)
    assert [type(g) for g in got.graphs] == [graphs.Graph] * 2
    got.graphs[1].replay()
    got.graphs[1].replay()
    assert [g.cuda_graph.replays for g in got.graphs] == [0, 2]


def test_a_dropped_graph_is_destroyed_at_once_under_the_free_lock(world):
    g = _one(world)
    del g
    assert world.destroyed() == [("destroyed", True, False, "MainThread")]
    assert graphs.pending() == 0
    assert not platform.capture_lock.locked()


def test_a_graph_dropped_while_another_thread_holds_the_lock_waits(world):
    """Dropped while another thread captures, a graph waits; that
    thread's next capture destroys it under the lock before its
    warm-up."""
    g = _one(world)
    done = _lock_held_elsewhere()
    raw = g.cuda_graph
    del g
    assert world.destroyed() == []
    assert any(d.get("cuda_graph") is raw for d in graphs._doomed)
    del raw
    done()
    seen = []

    def warmup():
        seen.append((graphs.pending(), len(world.destroyed())))

    kept = graphs.capture([lambda: None], "stream", warmup=warmup)
    assert seen == [(0, 1)] and kept.graphs
    assert world.destroyed() == [("destroyed", True, False, "MainThread")]


def test_a_graph_dropped_inside_the_window_is_destroyed_after_it(world):
    """Dropped in the capturing thread inside its window (what a
    collection there does), a graph is destroyed after the window closes,
    still under the lock."""
    box = [_one(world)]
    world.log.clear()

    def stage():
        box.pop()

    kept = graphs.capture([stage], "stream", warmup=lambda: None)
    assert kept.graphs and world.log == [("open",), ("close",),
                         ("destroyed", True, False, "MainThread")]


def test_a_graph_freed_by_a_collection_waits_for_the_lock(world):
    """A cycle holding a graph, freed by the collector in a thread that
    runs while the lock is held: the CUDA graph is kept in the list, not
    released, until the lock is free.  (The collector runs a stand-in's
    own ``__del__`` early, since the stand-in was garbage when the
    collection began; a CUDA graph has no ``__del__`` and is destroyed
    only when its last reference goes.)"""
    g = _one(world)
    raw = [g.cuda_graph]
    cycle = [g]
    cycle.append(cycle)
    del g, cycle
    with platform.capture_lock:
        gc.collect()
        assert any(d.get("cuda_graph") is raw[0] for d in graphs._doomed)
    del raw[:]
    graphs._destroy_doomed()
    assert graphs.pending() == 0


@pytest.mark.parametrize("droppers", [1, 3])
def test_no_graph_destroyed_beside_a_capture(monkeypatch, droppers):
    """One thread captures again and again (each window's opening sleeps
    with the GIL released, as ``capture_begin`` runs), others drop what
    it made: every graph is destroyed under the lock with no window open,
    and none is left once the threads are done."""
    w = _World(begin_s=2e-4)
    monkeypatch.setattr(torch.cuda, "graph", w.Window)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", w.Graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    made, stop = [], threading.Event()

    def capturer():
        for _ in range(300):
            made.append(graphs.capture([lambda: None], "stream",
                                       warmup=lambda: None))
        stop.set()

    def dropper():
        while not (stop.is_set() and not made):
            try:
                got = made.pop(0)
            except IndexError:
                time.sleep(0)
                continue
            del got

    threads = [threading.Thread(target=capturer, name="capturer")] + [
        threading.Thread(target=dropper, name=f"dropper{i}")
        for i in range(droppers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    graphs._destroy_doomed()
    gone = w.destroyed()
    assert w.made == 300 and len(gone) == 300 and graphs.pending() == 0
    assert all(held and not window for _, held, window, _ in gone), [
        e for e in gone if not e[1] or e[2]][:5]
    assert {name for *_, name in gone} - {"capturer"}   # droppers did too


@pytest.mark.parametrize("kind", ["bucket", "step bucket", "engine"])
def test_a_dropped_engine_frees_its_buffers_under_the_lock(kind):
    """An engine's bucket (its pinned twins on the card) dropped while
    another thread holds the capture lock keeps its buffers until the lock
    is free; dropped with the lock free, it frees them at once."""
    import weakref

    from repro_torch.core import acquisition as acq
    from repro_torch.launch import train_profile as tp

    cpu = torch.device("cpu")

    def make():
        if kind == "bucket":
            b = acq._Bucket(8, 24, cpu)
            return b, b.host_in
        if kind == "step bucket":
            b = acq._StepBucket(8, cpu)
            return b, b.host_n
        eng = acq.FusedEngine(tp.member_forces, tp.committee(), 0.5,
                              device="cpu")
        eng.score(tp.geometries(8, seed=3))
        return eng, next(iter(eng._buckets.values())).host_in

    for elsewhere in (True, False):
        owner, buf = make()
        ref = weakref.ref(buf)
        del buf
        done = _lock_held_elsewhere() if elsewhere else None
        del owner
        gc.collect()
        if elsewhere:
            assert ref() is not None and graphs.pending() >= 1
            done()
            graphs._destroy_doomed()
        assert ref() is None and graphs.pending() == 0
