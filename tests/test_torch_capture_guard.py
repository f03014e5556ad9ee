"""The port's one capture helper, on the CPU.  ``kernels.graphs.capture``
is the only place the port opens a CUDA-graph capture, and the port makes
no device-wide synchronize (one from another thread invalidates an open
capture; its owners wait for their own streams instead; the card half is
``tests/test_torch_capture_cuda.py``).  Here: the package's source scanned
for the calls, each owner's wait on its own stream, and the helper's host
logic with ``torch.cuda.graph`` replaced by a recording context: the
warm-up and the capture run under ``platform.capture_lock``, the cyclic
collector is off inside the window, and the lock and the collector's prior
state come back after it, also when the captured function raises."""
import ast
import contextlib
import gc
import weakref
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import committee_uq, graphs
from repro_torch.launch import platform

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# measuring tools, each a single thread timing its own work (outside the
# loop): they capture or synchronize as they measure
TOOLS = {"launch/kernel_variants.py", "launch/lm_profile.py",
         "launch/serving_profile.py", "launch/train_profile.py"}


def _calls(tree):
    """(dotted name, enclosing function) of every attribute chain in
    ``tree`` that ends in ``graph``, ``CUDAGraph``, ``capture_begin``,
    ``capture_end`` or ``synchronize`` under ``torch.cuda`` (or, for the
    two capture methods, on anything)."""
    found = []

    def walk(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Attribute):
            parts, v = [node.attr], node.value
            while isinstance(v, ast.Attribute):
                parts.append(v.attr)
                v = v.value
            if isinstance(v, ast.Name):
                parts.append(v.id)
            name = ".".join(reversed(parts))
            if node.attr in ("capture_begin", "capture_end") or name in (
                    "torch.cuda.graph", "torch.cuda.CUDAGraph",
                    "torch.cuda.synchronize"):
                found.append((name, func))
        for child in ast.iter_child_nodes(node):
            walk(child, func)

    walk(tree, None)
    return found


def _port_calls():
    out = {}
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel in TOOLS:
            continue
        for name, func in _calls(ast.parse(path.read_text())):
            out.setdefault(name, []).append((rel, func))
    return out


@pytest.mark.parametrize("name,where", [
    ("torch.cuda.graph", [("kernels/graphs.py", "capture")]),
    ("torch.cuda.CUDAGraph", [("kernels/graphs.py", "capture")]),
    ("torch.cuda.synchronize", None)])
def test_only_the_helper_captures_and_nothing_synchronizes(name, where):
    """Outside the measuring tools, ``torch.cuda.graph`` and
    ``CUDAGraph()`` appear only in the helper in ``kernels/graphs.py``, and
    ``torch.cuda.synchronize`` nowhere."""
    assert _port_calls().get(name) == where


def test_no_capture_begin_or_end_outside_torch():
    """Nothing of the port drives ``capture_begin``/``capture_end``
    itself (``torch.cuda.graph`` does, inside the helper)."""
    calls = _port_calls()
    assert not calls.get("capture_begin") and not [
        k for k in calls if k.endswith((".capture_begin", ".capture_end"))]


def test_every_capture_site_calls_the_helper():
    """The six capture sites of the port call ``graphs.capture``."""
    sites = {"training/committee_trainer.py": ["_capture"],
             "training/train_step.py": ["_capture"],
             "core/acquisition.py": ["capture", "_capture", "_capture_step"],
             "kernels/graphs.py": ["__init__"]}
    for rel, funcs in sites.items():
        tree = ast.parse((PORT / rel).read_text())
        got = _callers(tree, "capture")
        assert sorted(got) == sorted(funcs), (rel, got)


def _callers(tree, attr):
    """The enclosing function of every call ``graphs.attr(...)`` or
    ``attr(...)``."""
    out = []

    def walk(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == attr
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "graphs") or (
                    isinstance(f, ast.Name) and f.id == attr):
                out.append(func)
        for child in ast.iter_child_nodes(node):
            walk(child, func)

    walk(tree, None)
    return out


class _Recorder:
    """Stands in for ``torch.cuda.graph`` and ``torch.cuda.CUDAGraph``:
    records each window's opening and closing with the lock's state."""

    def __init__(self):
        self.events = []
        rec = self

        class Graph:
            pass

        class Window:
            def __init__(self, graph, pool=None, stream=None,
                         capture_error_mode="global"):
                assert capture_error_mode == "thread_local"
                self.graph, self.pool, self.stream = graph, pool, stream

            def __enter__(self):
                rec.events.append(("open", platform.capture_lock.locked(),
                                   gc.isenabled()))

            def __exit__(self, *exc):
                rec.events.append(("close", platform.capture_lock.locked(),
                                   gc.isenabled(), exc[0]))

        self.Graph, self.Window = Graph, Window


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "graph", rec.Window)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", rec.Graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return rec


def test_capture_holds_the_lock_and_counts_launches(recorder, monkeypatch):
    monkeypatch.setattr(committee_uq, "captured", committee_uq.captured)
    order = []

    def warmup():
        order.append(("warmup", platform.capture_lock.locked()))

    def stage(i):
        def fn():
            order.append((f"stage {i}", platform.capture_lock.locked()))
            committee_uq.captured += i + 1   # launches under capture
            return i
        return fn

    assert not platform.capture_lock.locked()
    got = graphs.capture([stage(0), stage(1)], "stream", warmup=warmup,
                         pool="pool")
    assert order == [("warmup", True), ("stage 0", True), ("stage 1", True)]
    assert recorder.events == [("open", True, False),
                               ("close", True, False, None)] * 2
    assert gc.isenabled()
    assert got.outs == [0, 1] and len(got.graphs) == 2
    assert got.launches[graphs.KERNELS.index(committee_uq)] == 3
    assert not platform.capture_lock.locked()


def test_capture_releases_the_lock_when_the_function_raises(recorder):
    def boom():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.capture([boom], "stream", warmup=lambda: None)
    assert recorder.events == [("open", True, False),
                               ("close", True, False, RuntimeError)]
    assert not platform.capture_lock.locked() and gc.isenabled()


class _Stream:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def _owners():
    from repro_torch.core.acquisition import FusedEngine
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.committee_trainer import CommitteeTrainer

    return {"committee engine": (FusedEngine, "synchronize"),
            "committee trainer": (CommitteeTrainer, "synchronize"),
            "serving engine": (ServeEngine, "_sync")}


@pytest.mark.parametrize("owner", sorted(_owners()))
def test_an_owner_waits_for_its_own_stream(owner, monkeypatch):
    """The waits that replaced the device-wide synchronizes (``PAL``'s
    shutdown, ``ServeEngine.generate``'s timed phases) wait for the
    owner's stream and call no ``torch.cuda.synchronize``; on the CPU
    (no stream) they do nothing."""
    cls, method = _owners()[owner]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail(
        "device-wide synchronize"))
    obj = object.__new__(cls)
    obj._stream = None
    getattr(obj, method)()
    obj._stream = _Stream()
    getattr(obj, method)()
    assert obj._stream.waits == 1


class _Cycle:
    def __init__(self):
        self.me = self


def test_no_collection_inside_the_window(recorder):
    """A cycle (which may hold CUDA graphs) that becomes garbage inside the
    window survives the allocations that would trigger a collection
    there, and is freed by the first collection after the window."""
    refs = []

    def fn():
        cycle = _Cycle()
        refs.append(weakref.ref(cycle))
        del cycle
        junk = [[] for _ in range(5 * gc.get_threshold()[0])]
        del junk
        refs.append(refs[0]())

    graphs.capture([fn], "stream", warmup=lambda: None)
    assert refs[1] is not None
    del refs[1]
    gc.collect()
    assert refs[0]() is None


def test_capture_keeps_the_collector_off_when_it_was_off(recorder):
    gc.disable()
    try:
        graphs.capture([lambda: None], "stream", warmup=lambda: None)
        assert not gc.isenabled()
    finally:
        gc.enable()
    assert recorder.events == [("open", True, False),
                               ("close", True, False, None)]
