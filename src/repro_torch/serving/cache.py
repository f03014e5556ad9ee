"""LSH near-duplicate answer cache for the serving tier (a host-side copy
of the reference's ``repro/serving/cache.py``).

Production serving traffic is heavily repetitive: the same (or a nearly
identical) input arrives again and again — the thermo-fluid surrogate in
the paper's SI serves grids of operating points, LM distillation replays
prompts.  When the committee was CONFIDENT about an input the last time
it saw it, re-dispatching the committee for a near-duplicate buys
nothing: the answer cannot change until the weights do.  This cache
short-circuits those requests before they reach the device.

Mechanics — the same locality-sensitive bucketing as
``core/budget.RollingReweightRule`` (``lsh_projection``: a fixed seeded
random projection, quantized and folded into ``n_buckets``), with two
serving-specific hardenings:

* **multiple projections** (``n_proj``, default 4) combined into one
  bucket id — single-projection buckets collide far too often for an
  answer cache (the re-weight rule WANTS coarse regions; a cache wants
  near-duplicates);
* **verification against the stored key row** — a bucket match alone is
  never trusted: the candidate must be within ``tol`` (L-inf) of the row
  that produced the cached answer.  ``tol=0`` (default) means
  bit-identical rows only, which makes a cache hit *bit-identical to a
  fresh dispatch* for deterministic committees (row-wise independent
  forward — tested).

Only LOW-UNCERTAINTY answers are cached: a row the rule pipeline
selected (``mask=True``) or whose ``scalar_std`` exceeds ``std_max``
must keep reaching the device (and, through it, the oracle-routing
path) — caching it would hide exactly the traffic active learning wants
to see.  The cache is GENERATION-TAGGED: ``ServingQueue`` stamps every
fill with the serving engine's weight generation (``version`` +
``device_refreshes``) and the whole cache invalidates the moment a
``refresh_from_device``/``refresh_from`` lands, because every cached
answer is stale under new weights.

Counters (read under the owner's lock via ``stats()``): ``hits`` /
``misses`` are per-row lookup outcomes; ``bypass`` counts rows that
were *deliberately not served from cache* — the caller opted out
(``use_cache=False``), or a row's hit could not be used because a
sibling row in the same request missed (requests are atomic: they are
served entirely from cache or entirely fresh); ``insertions`` and
``invalidations`` complete the picture.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.budget import lsh_projection


class _Entry:
    __slots__ = ("key", "mean", "scalar_std", "component_std", "finite")

    def __init__(self, key, mean, scalar_std, component_std, finite):
        self.key = key
        self.mean = mean
        self.scalar_std = scalar_std
        self.component_std = component_std
        self.finite = finite


class LSHAnswerCache:
    """Near-duplicate answer cache keyed by LSH bucket + verified row.

    ``n_buckets``     hash-space size (entries bounded by
                      ``n_buckets * depth``).
    ``std_max``       only answers with ``scalar_std <= std_max`` AND
                      ``mask=False`` are cached (confident answers only).
    ``tol``           L-inf verification radius around the stored key row;
                      0 = exact (bit-identical) match only.
    ``bucket_width``  projection quantization step (same role as in
                      ``RollingReweightRule``).
    ``depth``         entries kept per bucket (LRU within the bucket).
    ``seed``          projection seed — shared scheme with
                      ``lsh_projection``.

    Thread-safe; all methods take the internal lock.  ``lookup`` returns
    per-row entries or None; ``fill`` inserts eligible rows after a
    dispatch; ``note_generation`` drops everything when the weight
    generation moves.
    """

    def __init__(self, n_buckets: int = 4096, *, std_max: float,
                 tol: float = 0.0, bucket_width: float = 1.0,
                 depth: int = 4, n_proj: int = 4, seed: int = 0):
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        self.n_buckets = int(n_buckets)
        self.std_max = float(std_max)
        self.tol = float(tol)
        self.bucket_width = float(bucket_width)
        self.depth = max(int(depth), 1)
        self.n_proj = max(int(n_proj), 1)
        self.seed = int(seed)
        self._proj: Optional[np.ndarray] = None  # lazy (in_dim, n_proj)
        self._mix: Optional[np.ndarray] = None
        self._buckets: Dict[int, List[_Entry]] = {}
        self._generation: Optional[Tuple[int, ...]] = None
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.bypass = 0
        self.insertions = 0
        self.invalidations = 0

    # ------------------------------------------------------------- hashing
    def _bucket_id(self, row: np.ndarray) -> int:
        x = np.asarray(row, np.float32).reshape(-1)
        if self._proj is None or self._proj.shape[0] != x.shape[0]:
            self._proj = lsh_projection(x.shape[0], self.seed, self.n_proj)
            # odd mixing multipliers fold the n_proj quantized coordinates
            # into one bucket id (deterministic in the seed)
            self._mix = (2 * np.random.RandomState(self.seed + 1)
                         .randint(0, 2**15, self.n_proj) + 1).astype(np.int64)
        z = np.floor(x @ self._proj / self.bucket_width).astype(np.int64)
        return int((z @ self._mix) % self.n_buckets)

    # -------------------------------------------------------------- lookup
    def lookup(self, rows: Sequence[np.ndarray]) -> List[Optional[_Entry]]:
        """Per-row cached entries (None = miss).  Counts ONE hit/miss per
        row; the caller decides whether a partial-hit request can use its
        hits (ServingQueue cannot — it re-counts those as bypass via
        :meth:`note_bypass`)."""
        out: List[Optional[_Entry]] = []
        with self._lock:
            for row in rows:
                x = np.asarray(row, np.float32).reshape(-1)
                ent = self._find_locked(x)
                if ent is None:
                    self.misses += 1
                else:
                    self.hits += 1
                out.append(ent)
        return out

    def _find_locked(self, x: np.ndarray) -> Optional[_Entry]:
        chain = self._buckets.get(self._bucket_id(x))
        if not chain:
            return None
        for i, ent in enumerate(chain):
            key = ent.key
            if key.shape != x.shape:
                continue
            if self.tol <= 0.0:
                ok = np.array_equal(key, x)
            else:
                ok = bool(np.max(np.abs(key - x), initial=0.0) <= self.tol)
            if ok:
                if i != 0:                      # LRU within the bucket
                    chain.insert(0, chain.pop(i))
                return ent
        return None

    def note_bypass(self, n: int = 1):
        """Rows that had a usable hit (already counted) but were served
        fresh anyway — a request-mate missed, or the caller opted out."""
        with self._lock:
            self.bypass += int(n)

    # ---------------------------------------------------------------- fill
    def fill(self, rows: Sequence[np.ndarray], uq,
             generation: Tuple[int, ...]):
        """Insert the confident rows of one dispatched microbatch.

        ``uq`` is the dispatch's UQResult; rows with ``mask=True`` or
        ``scalar_std > std_max`` are skipped (they must keep reaching the
        device).  ``generation`` is the engine weight generation the
        answers were computed under — a fill from an older generation
        than the cache has seen is dropped entirely."""
        with self._lock:
            # weights may have moved between dispatch and fill: a moved
            # generation drops the old entries before inserting
            self._note_generation_locked(generation)
            fin = getattr(uq, "finite_members", None)
            for i, row in enumerate(rows):
                if bool(uq.mask[i]) or float(uq.scalar_std[i]) > self.std_max:
                    continue
                x = np.asarray(row, np.float32).reshape(-1)
                ent = _Entry(
                    x.copy(),
                    np.asarray(uq.mean[i]).copy(),
                    np.asarray(uq.scalar_std[i]).copy(),
                    np.asarray(uq.component_std[i]).copy(),
                    (np.asarray(fin[i]).copy() if fin is not None else None))
                chain = self._buckets.setdefault(self._bucket_id(x), [])
                # replace an existing entry for the same key (fresh answer)
                chain[:] = [e for e in chain
                            if not (e.key.shape == x.shape
                                    and np.array_equal(e.key, x))]
                chain.insert(0, ent)
                del chain[self.depth:]
                self.insertions += 1

    # -------------------------------------------------------- invalidation
    def note_generation(self, generation: Tuple[int, ...]):
        """Invalidate everything when the serving engine's weight
        generation moved (refresh_from_device / refresh_from landed):
        every cached answer is stale under new weights."""
        with self._lock:
            self._note_generation_locked(generation)

    def _note_generation_locked(self, generation: Tuple[int, ...]):
        if self._generation is not None and generation != self._generation:
            if self._buckets:
                self.invalidations += 1
            self._buckets.clear()
        self._generation = generation

    def invalidate(self):
        with self._lock:
            if self._buckets:
                self.invalidations += 1
            self._buckets.clear()

    # ---------------------------------------------------------------- stats
    def __len__(self) -> int:
        with self._lock:
            return sum(len(c) for c in self._buckets.values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "bypass": self.bypass,
                "insertions": self.insertions,
                "invalidations": self.invalidations,
                "entries": sum(len(c) for c in self._buckets.values()),
            }
