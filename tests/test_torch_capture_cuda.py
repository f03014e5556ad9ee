"""CUDA-graph capture windows on the card, held against calls made around
them.  A device-wide synchronize made by another thread while a capture is
open invalidates that capture (``thread_local`` mode does not shield it):
the port makes none, and each owner waits for its own stream instead.
Destroying a CUDA graph in the capturing thread inside its window
invalidates the capture too, and the cyclic collector does that when it
frees a cycle holding graphs there: ``graphs.capture`` keeps the collector
off in the window.  Each of those cases puts its call into the committee
trainer's own capture (``CommitteeTrainer._capture``) and holds the
captured step against the eager one bit for bit.  Destroying a CUDA graph
in one thread while another is inside ``capture_begin`` corrupts memory
(torch 2.11's generator state keeps the graphs in a set with no lock):
the port destroys its graphs only under the capture lock, held here by
``chip_smoke.graph_churn`` in a process of its own.  torch 2.11's CUDA
stream leaves its weak references pointing at the freed wrapper, so a
reference read after the memory is reused increments a word of whatever
object took it (the capture soak's recorder once did, at every trainer
capture): the recorder takes none, held by a stream churn in a process
of its own.  Every test needs a
CUDA card (capture has no CPU mode), so each is marked ``cuda`` and skips
without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_capture_cuda.py
"""
import gc
import json
import os
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture has no CPU mode")
    return torch.device("cuda")


def _trainer(capture=True):
    """The quickstart's committee trainer (K=4, batch 64) with 256
    labelled geometries in its ring; the same weights and data each call."""
    from repro_torch.launch import train_profile as tp

    tr = tp.make_trainer(tp.committee(), device="cuda", capture=capture)
    tr.add_blocks(tp.dataset(256, seed=1))
    return tr


def _inject(tr, fn):
    """Run ``fn`` at the start of ``tr``'s step program: inside the capture
    window when the trainer captures (its warm-ups run the body alone)."""
    program = tr._program

    def with_fn():
        fn()
        return program()

    tr._program = with_fn


def _check_against_eager(tr):
    """Two steps of ``tr`` (one capture, two replays) against two eager
    steps of the same trainer built anew: losses bit for bit."""
    eager = _trainer(capture=False)
    got = tr.train(steps=2)["loss"]
    want = eager.train(steps=2)["loss"]
    assert tr.captures == 1 and tr.graph_replays == 2
    np.testing.assert_array_equal(got, want)


def _generate(dev):
    """A warm ``ServeEngine.generate`` of llama3.2-1b at its smoke widths
    (its graphs captured by a first call); returns the call."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import ServeEngine

    cfg = reduced_config(get_arch("llama3.2-1b").model, "smoke").replace(
        head_dim=64, dtype="bfloat16")
    model = model_zoo.build_model(cfg, max_seq=64)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = ServeEngine(model, params, max_seq=48, batch=2, device=dev)
    batch = {"tokens": np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    eng.generate(batch, 4)
    return lambda: eng.generate(batch, 4).tokens


@pytest.mark.cuda
def test_trainer_capture_with_generate_in_another_thread(cuda_device):
    """``ServeEngine.generate`` synchronized the whole device around its
    timed phases.  Called by another thread while the committee trainer
    captures, that synchronize fell inside the window and invalidated the
    capture (and raised in that thread).  It now waits for the engine's
    own stream: the capture holds, the captured steps equal the eager
    ones, and generate returns the tokens it returns alone."""
    generate = _generate(cuda_device)
    alone = generate()
    tr = _trainer()
    got, errors, started = [], [], threading.Event()

    def other():
        started.set()
        try:
            got.append(generate())
        except Exception as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=other, daemon=True)

    def window():
        t.start()
        started.wait(60)
        time.sleep(0.2)            # the other thread reaches its waits

    _inject(tr, window)
    _check_against_eager(tr)
    t.join(120)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(got[0], alone)


class _Cycle:
    """``res`` held only by a reference cycle: freed by the collector."""

    def __init__(self, res):
        self.me = self
        self.res = res


def _held_graph(dev):
    s = torch.cuda.Stream(dev)
    y = torch.ones(64, device=dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
        y.mul_(2)
    g.replay()
    return [g, y]


def _held_pinned(dev):
    """Pinned buffers that carried copies on another stream: freeing them
    records an event on that stream (the host allocator's)."""
    s = torch.cuda.Stream(dev)
    h = torch.ones(1 << 16).pin_memory()
    out = torch.empty(1 << 16, pin_memory=True)
    with torch.cuda.stream(s):
        d = h.to(dev, non_blocking=True)
        out.copy_(d, non_blocking=True)
    return [h, out, d]


def _held_event(dev):
    s = torch.cuda.Stream(dev)
    e = torch.cuda.Event()
    with torch.cuda.stream(s):
        torch.ones(8, device=dev).add_(1)
        e.record()
    return [e]


def _held_engine(dev):
    """A committee engine that captured and replayed its bucket graph:
    graphs, pinned twins with recorded copies, events, a stream."""
    from repro_torch.core import acquisition as acq
    from repro_torch.launch import train_profile as tp

    eng = acq.FusedEngine(tp.member_forces, tp.committee(), 0.5, device=dev)
    rows = tp.geometries(64, seed=3)
    for _ in range(3):
        eng.score(rows)
    return [eng]


HELD = {"graph": _held_graph, "pinned": _held_pinned, "event": _held_event,
        "engine": _held_engine}


@pytest.mark.cuda
@pytest.mark.parametrize("held", sorted(HELD))
def test_trainer_capture_survives_the_collector_in_its_window(cuda_device,
                                                              held):
    """The cyclic collector runs in whatever thread crosses its threshold,
    the capturing one included.  Here a cycle holding the only reference
    to CUDA graphs (a lone graph; an engine's bucket graph), pinned buffers
    with recorded copies or events becomes garbage inside the trainer's
    window while the capturing thread allocates past the threshold.
    Destroying a graph there invalidated the capture.  The collector is
    now off in the window: the capture holds, the steps equal the eager
    ones, and the cycle is freed after the window."""
    holder = [HELD[held](cuda_device)]
    torch.cuda.synchronize()
    tr = _trainer()
    cycles = []

    def garbage():
        cycle = _Cycle(holder.pop())
        cycles.append(weakref.ref(cycle))
        del cycle
        junk = [[] for _ in range(5 * gc.get_threshold()[0])]
        del junk

    _inject(tr, garbage)
    _check_against_eager(tr)
    gc.collect()
    assert cycles and cycles[0]() is None


@pytest.mark.cuda
def test_graph_churn_drops_beside_captures_and_replays(cuda_device):
    """``chip_smoke.graph_churn`` in a child process for 20 s: one thread
    captures through ``graphs.capture`` again and again on a stream,
    another drops what it captured, a third builds committee engines on
    that stream between the captures and drops them, a fourth replays
    other graphs.  When a dropped graph was destroyed, or a dropped
    engine's pinned buffers freed, in the dropping thread, the process
    died within seconds (torch's check in ``unregister_graph``, a CUDA
    error or a segfault).  Now the child exits 0 with thousands of
    captures and drops, tens of engines, every replay's sum right and no
    error in any thread."""
    root = Path(__file__).resolve().parents[1]
    code = ("import json, chip_smoke as c; "
            "print('CHURN', json.dumps(c.graph_churn(20.0)))")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, "-X", "faulthandler", "-c", code],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    line = [x for x in run.stdout.splitlines() if x.startswith("CHURN ")]
    got = json.loads(line[-1][len("CHURN "):])
    assert not got["errors"], got
    assert got["captures"] > 1000 and got["drops"] > 1000, got
    assert got["engines"] > 10 and got["replays"] > 100, got


# A child process: pool streams recorded by a ``CaptureRecorder`` (its
# stream family alone), dropped, their memory taken by lists of fresh
# objects in the size classes around a stream wrapper's, then the
# recorder's trainer-capture read made again and again.  Prints what the
# recorder saw live and how many list items changed, then exits at once
# (a changed item would crash the lists' teardown).
STREAM_CHURN = """
import gc, json, os
import torch
import chip_smoke as c

rec = c.CaptureRecorder().install(skip=("calls", "del", "gc"))
made = [torch.cuda.Stream() for _ in range(96)]
recorded = len(rec._streams)
del made
gc.collect()
victims = [[object() for _ in range(n)] for n in range(4, 20)
           for _ in range(48)]
kept = [list(v) for v in victims]
for _ in range(16):
    rec._read_streams()
changed = sum(a is not b for v, k in zip(victims, kept)
              for a, b in zip(v, k))
print("STREAMS", json.dumps({"recorded": recorded,
                             "live": len(rec.live_at_capture),
                             "changed": changed}), flush=True)
os._exit(0)
"""


@pytest.mark.cuda
def test_recorder_reads_no_freed_stream(cuda_device):
    """96 pool streams made under the recorder's stream family, dropped,
    their memory reused by lists of fresh objects, then 16 of the reads
    the recorder makes at each trainer capture, in a child process: no
    stream is live, no list item changed and the child exits 0.  A
    recorder that kept a weak reference to each stream read 32 freed
    streams live and changed 84 items: torch 2.11 does not clear a CUDA
    stream's weak references when it frees it, so each read incremented
    the word where the freed wrapper's reference count was (in the soak's
    crashes, a pointer among a ``Mesh``'s attribute values)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, "-X", "faulthandler", "-c",
                          STREAM_CHURN], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    lines = [x for x in run.stdout.splitlines() if x.startswith("STREAMS ")]
    assert run.returncode == 0 and lines, (run.returncode,
                                           run.stderr[-4000:])
    got = json.loads(lines[-1][len("STREAMS "):])
    assert got["recorded"] == 96, got
    assert got["live"] == 0 and got["changed"] == 0, got
