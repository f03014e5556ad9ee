"""Versioned weight publication: training kernel -> prediction kernel
(paper §2.1/§2.4: "trained model weights are periodically copied directly to
the prediction kernel").

The paper packs weights as 1-D arrays over MPI; here a ``WeightStore`` holds
the latest packed weights per committee member with a monotonically
increasing version, and the prediction side pulls at its own cadence — the
same *periodic, versioned, non-blocking* semantics without a rendezvous.

NOTE: on the fused-training path (``training/committee_trainer.py``) the
store is DEMOTED to the checkpoint wire format and the legacy per-member
backend: the committee trainer hands its stacked params to the acquisition
engine device-to-device (``FusedEngine.refresh_from_device`` — a
copy into the engine's own buffers, zero packed host bytes), so the
steady-state trainer->prediction hop never packs at all.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import committee as cmte


class WeightStore:
    """Thread-safe latest-wins store of packed member weights.

    Publishes write into a pair of preallocated ping-pong buffers per member
    (allocated once at first publish), so the steady-state publish path does
    zero heap allocation — no per-round ``np.concatenate`` (paper's
    ``get_weight``) and no retention of caller arrays.  The packer always
    writes the buffer that is NOT currently stored, and readers only touch
    stored buffers under the lock (``pull_packed``/``pull_all`` hand out
    copies), so no reader can observe a torn write.  One publisher per
    member (the paper's structure: trainer i owns member i) — concurrent
    publishes to the *same* member would race the buffer flip.
    """

    def __init__(self, n_members: int):
        self.n_members = n_members
        self._weights: Dict[int, np.ndarray] = {}
        self._versions: Dict[int, int] = {i: 0 for i in range(n_members)}
        self._lock = threading.Lock()
        self._global_version = 0
        self.publishes = 0
        self.last_publish_time: Optional[float] = None
        self._pack_bufs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._pack_flip: Dict[int, int] = {}

    def _acquire_pack_buffer(self, member: int, size: int) -> np.ndarray:
        """Next ping-pong buffer for ``member`` — by construction never the
        currently-stored one, so packing outside the lock is safe."""
        pair = self._pack_bufs.get(member)
        if pair is None or pair[0].size != size:
            pair = (np.empty(size, np.float32), np.empty(size, np.float32))
            self._pack_bufs[member] = pair
            self._pack_flip[member] = 0
        i = self._pack_flip[member]
        self._pack_flip[member] = 1 - i
        return pair[i]

    # -- training side ------------------------------------------------------
    def publish(self, member: int, params: Any) -> int:
        """Pack and store member weights; returns the new global version."""
        size = cmte.get_weight_size(params)
        buf = self._acquire_pack_buffer(member, size)
        packed = cmte.get_weight(params, out=buf)
        with self._lock:
            self._weights[member] = packed
            self._global_version += 1
            self._versions[member] = self._global_version
            self.publishes += 1
            self.last_publish_time = time.time()
            return self._global_version

    def publish_packed(self, member: int, packed: np.ndarray) -> int:
        """Store already-packed 1-D weights (paper's get_weight output).
        Copied into the store's own buffer so callers may reuse theirs."""
        packed = np.asarray(packed)
        buf = self._acquire_pack_buffer(member, packed.size)
        np.copyto(buf, packed.astype(np.float32, copy=False))
        with self._lock:
            self._weights[member] = buf
            self._global_version += 1
            self._versions[member] = self._global_version
            self.publishes += 1
            self.last_publish_time = time.time()
            return self._global_version

    # -- prediction side ----------------------------------------------------
    def pull_packed(self, member: int, newer_than: int = -1
                    ) -> Optional[Tuple[np.ndarray, int]]:
        """Packed weights (a copy, safe to hold) if a newer version exists,
        else None.  The copy is made under the lock; version gating keeps
        this off the steady-state exchange path."""
        with self._lock:
            v = self._versions[member]
            if v <= newer_than or member not in self._weights:
                return None
            return self._weights[member].copy(), v

    def version(self, member: Optional[int] = None) -> int:
        with self._lock:
            if member is None:
                return self._global_version
            return self._versions[member]

    def pull(self, member: int, params_like: Any,
             newer_than: int = -1) -> Optional[Tuple[Any, int]]:
        """Unpack the stored weights into ``params_like`` structure if a
        version newer than ``newer_than`` exists; else None."""
        with self._lock:
            v = self._versions[member]
            if v <= newer_than or member not in self._weights:
                return None
            packed = self._weights[member].copy()
        return cmte.update(params_like, packed), v

    def pull_all(self, cparams_like: Any, newer_than: int = -1):
        """Refresh every member of a stacked committee tree.  Returns
        (new_cparams or None, version)."""
        with self._lock:
            v = self._global_version
            if v <= newer_than or len(self._weights) < self.n_members:
                return None, v
            packed = {i: w.copy() for i, w in self._weights.items()}
        members = [
            cmte.update(cmte.member(cparams_like, i), packed[i])
            for i in range(self.n_members)
        ]
        return cmte.stack_members(members), v


class WeightSyncPolicy:
    """When should training publish? (paper: every N epochs / retrains)."""

    def __init__(self, every_n_rounds: int = 1):
        self.every = max(1, every_n_rounds)
        self._rounds = 0

    def should_publish(self) -> bool:
        self._rounds += 1
        return self._rounds % self.every == 0
