"""Controller-side buffers (paper §2.5: oracle input buffer + training data
buffer; SI Use Case 2: rolling training set).

All buffers are thread-safe: the Exchange loop appends to the oracle buffer
while the Manager drains it and the training side consumes released batches.
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class OracleInputBuffer:
    """Samples selected for labeling, waiting for a free oracle.

    Supports the paper's ``dynamic_oracle_list``: when retraining finishes,
    the buffer is re-scored with the freshest committee and re-prioritized /
    pruned via a user function (``adjust_input_for_oracle`` in utils).
    """

    def __init__(self, max_size: int = 0):
        self._items: List[Any] = []
        self._lock = threading.Lock()
        self.max_size = max_size
        self.dropped = 0
        self.total_enqueued = 0
        # optional arrival hook (e.g. the runtime's manager-wake event):
        # called OUTSIDE the lock after every successful put
        self.on_put: Optional[Callable[[], None]] = None

    def put(self, items: Sequence[Any]):
        with self._lock:
            self._items.extend(items)
            self.total_enqueued += len(items)
            if self.max_size and len(self._items) > self.max_size:
                overflow = len(self._items) - self.max_size
                # drop the oldest (stalest uncertainty estimates)
                self._items = self._items[overflow:]
                self.dropped += overflow
        if self.on_put is not None:
            self.on_put()

    def pop(self) -> Optional[Any]:
        with self._lock:
            if not self._items:
                return None
            return self._items.pop(0)

    def pop_many(self, n: int) -> List[Any]:
        with self._lock:
            out, self._items = self._items[:n], self._items[n:]
            return out

    def remove_one(self, match: Callable[[Any], bool]) -> bool:
        """Remove the first queued item ``match`` accepts (late-straggler
        dedupe: when a timed-out task's result finally arrives and its label
        is used, the requeued twin still waiting here must be cancelled or
        the oracle recomputes a label the training buffer already has)."""
        with self._lock:
            for i, item in enumerate(self._items):
                if match(item):
                    del self._items[i]
                    return True
        return False

    def adjust(self, fn: Callable[[List[Any]], List[Any]]):
        """paper: adjust_input_for_oracle(to_orcl_buffer, pred_list)."""
        with self._lock:
            self._items = list(fn(list(self._items)))

    def __len__(self):
        with self._lock:
            return len(self._items)

    def snapshot(self) -> List[Any]:
        with self._lock:
            return list(self._items)

    def restore(self, items: Sequence[Any]):
        with self._lock:
            self._items = list(items)

    def snapshot_for_adjust(self) -> Tuple[List[Any], int]:
        """Snapshot plus the enqueue generation at snapshot time — pass the
        generation back to ``merge_adjusted`` so concurrent appends are
        identified correctly even on a bounded buffer."""
        with self._lock:
            return list(self._items), self.total_enqueued

    def merge_adjusted(self, new_items: Sequence[Any], enqueued_at: int,
                       snapshot_len: int = 0):
        """Replace the re-scored snapshot portion with ``new_items``
        (priority-sorted, most uncertain first), KEEPING anything appended
        concurrently since the snapshot was taken (dynamic_oracle_list:
        scoring runs outside the lock, and the Exchange thread keeps
        enqueueing while it does — a blind ``restore`` would silently drop
        those fresh selections).  Pops only happen on the Manager's own
        thread, so the un-scored portion is the appended suffix; it is
        counted via the enqueue generation, not list length, so a
        ``max_size`` trim during scoring cannot drop fresh selections.  On
        overflow the LOWEST-priority re-scored items are evicted first
        (``new_items`` is priority-sorted, unlike the age-sorted steady
        state where ``put`` drops the stalest), and fresh appends are only
        trimmed oldest-first if they alone exceed ``max_size``.

        ``snapshot_len`` (length of the snapshot the caller re-scored) is
        used to keep the ``dropped`` counter honest: snapshot items a
        concurrent ``put`` trim already counted as dropped may be
        re-inserted here via ``new_items``, so merge-overflow evictions are
        only counted beyond what that trim already charged (best-effort —
        identity is not tracked)."""
        with self._lock:
            n_appended = min(len(self._items),
                             self.total_enqueued - enqueued_at)
            appended = self._items[len(self._items) - n_appended:] \
                if n_appended > 0 else []
            new_items = list(new_items)
            trimmed_during = max(
                0, snapshot_len - (len(self._items) - n_appended))
            evicted = 0
            if self.max_size:
                overflow = len(new_items) + len(appended) - self.max_size
                if overflow > 0:
                    keep_new = max(0, len(new_items) - overflow)
                    evicted += len(new_items) - keep_new
                    new_items = new_items[:keep_new]
                if len(appended) > self.max_size:
                    extra = len(appended) - self.max_size
                    appended = appended[extra:]
                    evicted += extra
            self.dropped += max(0, evicted - trimmed_during)
            self._items = new_items + appended


class TrainingDataBuffer:
    """Labeled (input, target) pairs; released to trainers in blocks of
    ``retrain_size`` (paper SI S3: "batch size of increment retraining set").
    """

    def __init__(self, retrain_size: int = 20):
        self.retrain_size = retrain_size
        self._items: List[Tuple[Any, Any]] = []
        self._lock = threading.Lock()
        self.total_labeled = 0

    def add(self, inputs: Any, labels: Any):
        with self._lock:
            self._items.append((inputs, labels))
            self.total_labeled += 1

    def ready(self) -> bool:
        with self._lock:
            return len(self._items) >= self.retrain_size

    def release(self) -> List[Tuple[Any, Any]]:
        """Pop one retrain_size block (or everything if smaller on flush)."""
        with self._lock:
            n = self.retrain_size if len(self._items) >= self.retrain_size \
                else len(self._items)
            out, self._items = self._items[:n], self._items[n:]
            return out

    def __len__(self):
        with self._lock:
            return len(self._items)

    def snapshot(self):
        with self._lock:
            return list(self._items)

    def restore(self, items):
        with self._lock:
            self._items = list(items)


class RollingTrainingBuffer:
    """Fixed-capacity rolling training set (paper SI Use Case 2): newly
    labeled samples push out the oldest ones, keeping epoch time bounded and
    adapting the set to the region currently explored by the generators."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._x: List[np.ndarray] = []
        self._y: List[np.ndarray] = []
        self._lock = threading.Lock()
        self.evicted = 0

    def extend(self, xs: Sequence[np.ndarray], ys: Sequence[np.ndarray]):
        with self._lock:
            self._x.extend(xs)
            self._y.extend(ys)
            if len(self._x) > self.capacity:
                k = len(self._x) - self.capacity
                self._x, self._y = self._x[k:], self._y[k:]
                self.evicted += k

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return np.asarray(self._x), np.asarray(self._y)

    def __len__(self):
        with self._lock:
            return len(self._x)


def save_buffers(path: str, *buffers) -> None:
    """Paper SI S3: orcl_buffer_path / ml_buffer_path backups."""
    state = [b.snapshot() for b in buffers]
    with open(path, "wb") as fh:
        pickle.dump(state, fh)


def load_buffers(path: str, *buffers) -> None:
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    for b, s in zip(buffers, state):
        b.restore(s)
