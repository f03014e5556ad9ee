"""Whole-AL-state checkpoint/restart (beyond-paper; DESIGN.md §2).

Snapshot = committee weights (packed 1-D per member, the paper's own wire
format) + oracle/training buffers + generator states + patience counters +
progress counters.  Written atomically (tmp + rename) so a crash mid-write
never corrupts the restore point; retention keeps the last K snapshots.
"""
from __future__ import annotations

import logging
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)


def save_atomic(path: str, state: Dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".alckpt_")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return pickle.load(fh)


class ALCheckpointer:
    """Periodic whole-state snapshots with retention + auto-resume."""

    def __init__(self, result_dir: str, every_seconds: float = 0.0,
                 keep: int = 3):
        self.result_dir = result_dir
        self.every = every_seconds
        self.keep = keep
        self._last = 0.0
        self.saves = 0
        self.corrupt_skipped = 0

    def _path(self, step: int) -> str:
        return os.path.join(self.result_dir, f"al_state_{step:08d}.pkl")

    def due(self) -> bool:
        return self.every > 0 and (time.time() - self._last) >= self.every

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = self._path(step)
        state = dict(state)
        state["__step__"] = step
        state["__time__"] = time.time()
        save_atomic(path, state)
        self._last = time.time()
        self.saves += 1
        self._retain()
        return path

    def _retain(self):
        snaps = self.list_snapshots()
        for p in snaps[:-self.keep]:
            os.unlink(p)

    def list_snapshots(self) -> List[str]:
        if not os.path.isdir(self.result_dir):
            return []
        return sorted(
            os.path.join(self.result_dir, f)
            for f in os.listdir(self.result_dir)
            if f.startswith("al_state_") and f.endswith(".pkl"))

    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest LOADABLE snapshot.  ``save_atomic`` makes an in-progress
        write invisible, but a kill can still leave a truncated/garbage file
        at the newest path through other channels (copied trees, disk-full
        renames) — restore must fall back to the previous intact snapshot
        instead of dying on the corrupt one."""
        for p in reversed(self.list_snapshots()):
            try:
                return load(p)
            except (OSError, EOFError, pickle.UnpicklingError,
                    AttributeError, ImportError, IndexError, ValueError) as e:
                self.corrupt_skipped += 1
                log.warning("skipping unreadable checkpoint %s: %r", p, e)
        return None
