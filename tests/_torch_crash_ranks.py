"""Rank functions of ``tests/test_torch_crash_trace.py``: a soak rank's
``_SoakLog`` (faulthandler, then the native crash trace) on a gloo rank of
the CPU, one rank crashing.  Imports torch and ``chip_smoke`` only."""
from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

import chip_smoke


def crash_rank(log_dir, wait_s=60.0):
    """Rank 1 reads address 0 under its ``_SoakLog``; rank 0 returns once
    its watchdog has written that its peer ended without a result."""
    rank = int(torch.distributed.get_rank())
    log = chip_smoke._SoakLog(log_dir, rank)
    if rank == 1:
        ctypes.string_at(0)
    faults = Path(log_dir) / f"rank{rank}.faults"
    t0 = time.monotonic()
    while "ended without a result" not in faults.read_text() and \
            time.monotonic() - t0 < wait_s:
        time.sleep(0.1)
    log.done()
    return faults.read_text()
