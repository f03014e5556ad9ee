"""Host-side prefetch (a copy of the reference's ``repro/data/prefetch.py``):
a background thread keeps a small queue of ready
batches so input materialization overlaps the device step (double buffering
by default)."""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional


class Prefetcher:
    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(StopIteration)
        except BaseException as e:  # surfaced on next()
            self._exc = e
            self._q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
