"""The soak's native crash trace (``chip_smoke.install_crash_trace``): a C
signal handler built with the host C compiler and loaded with ``ctypes``,
installed over ``faulthandler``.  In a child process that crashes, it must
write the signal, ``si_code``, ``si_addr``, the faulting thread's id in
faulthandler's form and its native frames with their libraries, then let
faulthandler print the Python stacks, and the process must still die by
its signal (the soak counts a crashed spawn by ``exited with code -N``).
CPU only; skipped where no C compiler exists."""
from __future__ import annotations

import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    shutil.which("cc") is None and shutil.which("gcc") is None,
    reason="no C compiler (cc, gcc) to build the crash trace")

FRAME = re.compile(r"^  #(\d+) 0x[0-9a-f]+ (/\S+)\+0x[0-9a-f]+", re.M)

CHILD = """
import ctypes, faulthandler, os, sys, threading
import chip_smoke
faults = open(sys.argv[1], "w")
faulthandler.enable(file=faults)
for _ in range(int(sys.argv[3])):
    chip_smoke.install_crash_trace(faults.fileno())
def crash():
    if sys.argv[2] == "abort":
        os.abort()
    ctypes.string_at(0)
if sys.argv[4] == "thread":
    t = threading.Thread(target=crash, name="crasher")
    t.start()
    t.join()
else:
    crash()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _crash(tmp_path, how="segv", installs=1, where="main"):
    faults = tmp_path / "child.faults"
    got = subprocess.run(
        [sys.executable, "-c", CHILD, str(faults), how, str(installs),
         where], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=120)
    return got.returncode, faults.read_text()


def _held(text, sig, name, addr=None):
    """The record's checks; returns the thread id it names."""
    head = re.search(rf"^Native crash: {name} \(signal {int(sig)}\) "
                     rf"si_code (-?\d+) si_addr (0x[0-9a-f]+) pc 0x[0-9a-f]+$",
                     text, re.M)
    assert head, text[:2000]
    if addr is not None:
        assert head.group(2) == addr
    tid = re.search(r"^Thread (0x[0-9a-f]{16}) \(native frames", text, re.M)
    assert tid, text[:2000]
    frames = FRAME.findall(text[head.start():text.index(
        "End of native frames")])
    assert len(frames) >= 3, text[:3000]
    assert all(Path(lib).name for _, lib in frames)
    # faulthandler's Python stacks come after the native record, and
    # name the same thread
    after = text[text.index("End of native frames"):]
    assert "Fatal Python error" in after
    assert f"Current thread {tid.group(1)} (most recent call first)" in after
    return tid.group(1), frames


@pytest.mark.parametrize("where", ["main", "thread"])
def test_a_segfault_writes_native_frames_then_the_python_stacks(tmp_path,
                                                                where):
    rc, text = _crash(tmp_path, where=where)
    assert rc == -signal.SIGSEGV, (rc, text[:2000])
    _, frames = _held(text, signal.SIGSEGV, "SIGSEGV", addr="0x0")
    assert any("_ctypes" in Path(lib).name for _, lib in frames)
    # the faulting thread's Python stack is the one that crashed
    current = text[text.index("Current thread"):]
    assert re.match(r"Current thread [^\n]*\n  File \"[^\"]+\", line \d+ "
                    r"in string_at\n  File \"<string>\", line \d+ in crash",
                    current), current[:600]


def test_an_abort_is_recorded_and_still_kills(tmp_path):
    rc, text = _crash(tmp_path, how="abort")
    assert rc == -signal.SIGABRT, (rc, text[:2000])
    _held(text, signal.SIGABRT, "SIGABRT")
    assert "Fatal Python error: Aborted" in text


def test_installed_twice_writes_one_record_and_dies(tmp_path):
    rc, text = _crash(tmp_path, installs=2)
    assert rc == -signal.SIGSEGV, (rc, text[:2000])
    assert text.count("Native crash: ") == 1
    _held(text, signal.SIGSEGV, "SIGSEGV", addr="0x0")


def test_native_frames_reads_the_record_from_the_pc_outward(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    _, text = _crash(tmp_path)
    got = chip_smoke.native_frames(text, top=6)
    assert got["crash"].startswith("Native crash: SIGSEGV (signal 11)")
    assert 3 <= len(got["frames"]) <= 6
    assert all(re.match(r"\S+\+0x[0-9a-f]+ \S", f) for f in got["frames"])
    # the handler's own frame is not among them
    assert not any(f.startswith("crash_trace_") for f in got["frames"])
    assert chip_smoke.native_frames("no record here") is None


def test_a_crashed_soak_rank_still_counts_as_crashed(tmp_path):
    """A gloo rank that segfaults under its ``_SoakLog`` (faulthandler,
    then the crash trace) ends by its signal, so ``launch_local`` reports
    ``exited with code -11`` and ``_crashed`` counts it; its faults file
    holds the native record, and the other rank's watchdog dumped its
    threads."""
    code = (
        "import json, sys, chip_smoke\n"
        "from repro_torch.launch import distributed\n"
        "import _torch_crash_ranks as C\n"
        "try:\n"
        "    distributed.launch_local(2, C.crash_rank, sys.argv[1],\n"
        "                             device='cpu', timeout=120)\n"
        "    err = ''\n"
        "except RuntimeError as e:\n"
        "    err = str(e)\n"
        "g = chip_smoke._soak_progress(sys.argv[1])\n"
        "print(json.dumps({'crashed': chip_smoke._crashed(err), 'err': err,\n"
        "                  'native': g['rank1']['native'],\n"
        "                  'peer': g['rank0']['faults']}))\n")
    got = subprocess.run([sys.executable, "-c", code, str(tmp_path / "log")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=240)
    assert got.returncode == 0, got.stderr[-3000:]
    import json

    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["crashed"], out["err"]
    assert f"exited with code {-int(signal.SIGSEGV)}" in out["err"]
    assert out["native"]["crash"].startswith(
        "Native crash: SIGSEGV (signal 11)")
    assert len(out["native"]["frames"]) >= 3
    assert "rank 1 ended without a result" in out["peer"]
    text = (tmp_path / "log" / "rank1.faults").read_text()
    _held(text, signal.SIGSEGV, "SIGSEGV", addr="0x0")
