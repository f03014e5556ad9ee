"""AL replay buffers.

``ReplayTrainingBuffer`` — the committee trainer's data plane
(``training/committee_trainer.py``): labeled rows live in one
fixed-capacity ring on the device whose buffer never moves.  The PAL
Manager releases ``retrain_size`` blocks; a block append is ONE
host->device copy into the ring in place (two where it wraps), the
counterpart of the reference's donated ``dynamic_update_slice``, and every
train step gathers its per-member minibatches on the device — no
per-step host->device traffic.

``ALReplayBuffer`` — the LM path's host-side sequence buffer (a copy of
the reference's): oracle-labeled sequences accumulate and are sampled into
fixed-shape training batches (pads/crops to seq_len), uniform or
recency-weighted.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.pytree_ckpt import (
    BF16Bits, leaf_from_host, leaf_to_host,
)
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models.common import torch_dtype


class ReplayTrainingBuffer:
    """Fixed-capacity device-resident (x, y) training store.

    Rows are flattened 1-D per sample, stored side by side (x then y) in
    ONE ``(capacity, dx + dy)`` buffer of the storage ``dtype`` (``float32``
    default; ``bfloat16`` halves the ring).  Rows are cast to the storage
    dtype on the host before the copy, so a bf16 ring also halves the bytes
    of every append (``bytes_to_device`` counts what crosses); the train
    step gathers minibatches back to fp32 on the device.  Feature widths
    are fixed by the first appended block, which allocates the buffer; it
    is never reallocated unless a snapshot of another shape or dtype is
    restored.

    The valid-row count is kept twice: a host int (``len``, ``arrays()``)
    and ``size_dev``, a 0-d int32 on the device that the trainer's
    captured step reads.  ``stream`` (set by the trainer) is the CUDA
    stream appends and restores are ordered on; ``generation`` grows when
    the buffer is reallocated, so a captured program knows to recapture.
    """

    def __init__(self, capacity: int, dtype: str = "float32",
                 device: DeviceLike = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.dtype = str(dtype)         # storage dtype (gathers are fp32)
        self.device = resolve_device(device)
        self.stream = None
        self._buf: Optional[torch.Tensor] = None
        self._dx = 0
        self.size_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self._cursor = 0
        self._size = 0
        self._lock = threading.Lock()
        self.total_added = 0
        self.append_blocks = 0
        self.bytes_to_device = 0
        self.generation = 0

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _allocate(self, width: int, dx: int):
        # on the ring's stream, as every write into it: a zero fill left on
        # the caller's stream could land after the first block's copy
        with self._on_stream():
            self._buf = torch.zeros((self.capacity, width),
                                    dtype=torch_dtype(self.dtype),
                                    device=self.device)
        self._dx = dx
        self.generation += 1

    def append(self, xs, ys) -> int:
        """Append matching (n, dx)/(n, dy) host blocks; returns n kept."""
        xs = np.asarray(xs, np.float32).reshape(len(xs), -1)
        ys = np.asarray(ys, np.float32).reshape(len(ys), -1)
        if len(xs) != len(ys):
            raise ValueError(f"x/y row mismatch: {len(xs)} vs {len(ys)}")
        if len(xs) == 0:
            return 0
        if len(xs) > self.capacity:     # only the newest rows can survive
            xs, ys = xs[-self.capacity:], ys[-self.capacity:]
        # cast on the host: a bf16 ring moves half the bytes
        block = torch.from_numpy(np.concatenate([xs, ys], axis=1)).to(
            torch_dtype(self.dtype))
        with self._lock:
            if self._buf is None:
                self._allocate(block.shape[1], xs.shape[1])
            if (xs.shape[1] != self._dx
                    or block.shape[1] != self._buf.shape[1]):
                raise ValueError(
                    f"row width changed: got ({xs.shape[1]}, {ys.shape[1]}),"
                    f" buffer holds ({self._dx}, "
                    f"{self._buf.shape[1] - self._dx})")
            n = len(block)
            head = min(n, self.capacity - self._cursor)
            size = min(self.capacity, self._size + n)
            with self._on_stream():
                self._buf[self._cursor:self._cursor + head].copy_(block[:head])
                if head < n:            # ring wraparound: rest lands at 0
                    self._buf[:n - head].copy_(block[head:])
                self.size_dev.fill_(size)
            self._cursor = (self._cursor + n) % self.capacity
            self._size = size
            self.total_added += n
            self.append_blocks += 1
            self.bytes_to_device += block.numel() * block.element_size()
            return n

    @property
    def x(self) -> Optional[torch.Tensor]:
        return None if self._buf is None else self._buf[:, :self._dx]

    @property
    def y(self) -> Optional[torch.Tensor]:
        return None if self._buf is None else self._buf[:, self._dx:]

    def arrays(self):
        """(x, y, valid_rows): views of the device ring for the fused
        train step; rows past ``valid_rows`` are zero padding the sampler
        never indexes."""
        with self._lock:
            return self.x, self.y, self._size

    def __len__(self):
        with self._lock:
            return self._size

    def state_dict(self) -> Dict[str, np.ndarray]:
        with self._lock:
            if self._buf is None:
                return {"size": 0, "dtype": self.dtype}
            with self._on_stream():
                # rows snapshot in the STORAGE dtype (no widen-on-save)
                x, y = leaf_to_host(self.x), leaf_to_host(self.y)
            return {"x": x, "y": y, "cursor": self._cursor,
                    "size": self._size, "total_added": self.total_added,
                    "dtype": self.dtype}

    def load_state_dict(self, state):
        """Restore a snapshot: its capacity and storage dtype win.  Rows
        are copied into the existing buffer when its shape and dtype
        match; otherwise the buffer is reallocated (``generation`` grows)."""
        if not state or int(state.get("size", 0)) == 0:
            return
        x, y = state["x"], state["y"]
        dtype = str(state.get("dtype", "bfloat16" if isinstance(x, BF16Bits)
                              else np.asarray(x).dtype))
        with self._lock:
            self.dtype = dtype
            xt = leaf_from_host(x, "cpu").to(torch_dtype(dtype))
            yt = leaf_from_host(y, "cpu").to(torch_dtype(dtype))
            xt, yt = xt.reshape(len(xt), -1), yt.reshape(len(yt), -1)
            block = torch.cat([xt, yt], dim=1)
            self.capacity = int(block.shape[0])
            if (self._buf is None
                    or tuple(self._buf.shape) != tuple(block.shape)
                    or self._buf.dtype != block.dtype
                    or self._dx != xt.shape[1]):
                self._allocate(block.shape[1], xt.shape[1])
            self._cursor = int(state["cursor"])
            self._size = int(state["size"])
            self.total_added = int(state.get("total_added", self._size))
            with self._on_stream():
                self._buf.copy_(block)
                self.size_dev.fill_(self._size)


class ALReplayBuffer:
    def __init__(self, capacity: int, seq_len: int, recency_bias: float = 0.0):
        self.capacity = capacity
        self.seq_len = seq_len
        self.recency_bias = recency_bias
        self._tokens: List[np.ndarray] = []
        self._lock = threading.Lock()
        self.total_added = 0
        self.evicted = 0

    def add(self, sequences: List[np.ndarray]):
        with self._lock:
            self._tokens.extend(np.asarray(s, np.int32) for s in sequences)
            self.total_added += len(sequences)
            if len(self._tokens) > self.capacity:
                k = len(self._tokens) - self.capacity
                self._tokens = self._tokens[k:]
                self.evicted += k

    def __len__(self):
        with self._lock:
            return len(self._tokens)

    def sample(self, batch: int, rng: np.random.RandomState
               ) -> Optional[Dict[str, np.ndarray]]:
        with self._lock:
            n = len(self._tokens)
            if n == 0:
                return None
            if self.recency_bias > 0:
                w = np.exp(self.recency_bias
                           * (np.arange(n) - n + 1) / max(n, 1))
                p = w / w.sum()
            else:
                p = None
            idx = rng.choice(n, size=batch, replace=n < batch, p=p)
            seqs = [self._tokens[i] for i in idx]
        out = np.zeros((batch, self.seq_len + 1), np.int32)
        for i, s in enumerate(seqs):
            L = min(len(s), self.seq_len + 1)
            out[i, :L] = s[:L]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}
