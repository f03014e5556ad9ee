"""The capture soak's recorder (``chip_smoke.CaptureRecorder``): how it
keeps the pool streams it records, on the CPU with a stand-in for
``torch.cuda.Stream``.  torch 2.11's CUDA stream does not clear its weak
references when it frees a wrapper, so a weak reference read after the
memory is reused increments a word of whatever object took it: the
recorder takes no weak reference, and a finalizer it wraps on ``Stream``
marks a recorded stream dead.  What it reads at a trainer capture (the
live streams by handle, the live streams made since ``mark_pal`` sharing
one handle) is unchanged.  The card's own check is
``tests/test_torch_capture_cuda.py::test_recorder_reads_no_freed_stream``."""
from __future__ import annotations

import gc
import sys
import weakref
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


class FakeStream:
    """A pool stream's stand-in: ``cuda_stream`` is the handle given, or
    the next one; ``stream_id`` makes a wrapper of a stream made before."""
    handles = iter(range(0x1000, 0x100000, 0x10))

    def __new__(cls, *a, handle=None, **kw):
        s = object.__new__(cls)
        s.cuda_stream = next(cls.handles) if handle is None else handle
        return s


@pytest.fixture
def recorder(chip_smoke, monkeypatch):
    class Stream(FakeStream):
        pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    rec = chip_smoke.CaptureRecorder()
    rec._record_streams()
    yield rec, Stream
    rec.remove()


def test_a_recorded_stream_has_no_weak_reference(recorder):
    rec, Stream = recorder
    s = Stream()
    assert weakref.getweakrefcount(s) == 0
    (handle, maker, alive), = rec._streams
    assert handle == s.cuda_stream and alive
    assert maker.startswith("test_torch_capture_recorder.py:")


def test_a_freed_stream_is_not_read_live(recorder):
    rec, Stream = recorder
    kept = [Stream() for _ in range(3)]
    dropped = Stream()
    handle = dropped.cuda_stream
    del dropped
    gc.collect()
    rec._read_streams()
    assert sorted(rec.live_at_capture) == sorted(hex(s.cuda_stream)
                                                 for s in kept)
    assert hex(handle) not in rec.live_at_capture
    # an object made at the freed one's address is not taken for it
    again = [Stream() for _ in range(8)]
    rec._read_streams()
    assert len(rec.live_at_capture) == len(kept) + len(again)
    assert hex(handle) not in rec.live_at_capture


def test_shared_lists_live_streams_of_one_loop_on_one_handle(recorder):
    rec, Stream = recorder
    before = Stream(handle=0xA0)
    rec.mark_pal()
    again = Stream(handle=0xA0)         # the pool wrapped: not this loop's
    first, second = Stream(handle=0xB0), Stream(handle=0xB0)
    rec._read_streams()
    assert rec.shared == {hex(0xB0): [rec._streams[2][1],
                                      rec._streams[3][1]]}
    assert rec.live_at_capture[hex(0xA0)] == [rec._streams[0][1],
                                              rec._streams[1][1]]
    assert rec.pal_streams() == {hex(0xA0): [rec._streams[1][1]],
                                 hex(0xB0): [rec._streams[2][1],
                                             rec._streams[3][1]]}
    del second
    gc.collect()
    rec.shared.clear()
    rec._read_streams()
    assert rec.shared == {}
    del before, again, first


def test_a_wrapper_of_a_stream_made_before_is_not_recorded(recorder):
    rec, Stream = recorder
    w = Stream(stream_id=7)
    assert rec._streams == [] and rec._alive == {}
    del w
    gc.collect()
    assert rec._alive == {}


def test_remove_puts_the_stream_class_back(chip_smoke, monkeypatch):
    class Stream(FakeStream):
        pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    new = Stream.__new__
    rec = chip_smoke.CaptureRecorder()
    rec._record_streams()
    assert "__del__" in vars(Stream) and Stream.__new__ is not new
    rec.remove()
    assert "__del__" not in vars(Stream) and Stream.__new__ is new
