"""Atomic, async pytree checkpoints for training state.

A copy of the reference's ``repro/checkpoint/pytree_ckpt.py``; the only
device-specific step is ``_to_host``, a tree map of ``.cpu().numpy()`` over
tensors.  numpy has no bfloat16 without ml_dtypes (absent on the card's
machine), so a bf16 tensor goes to the host as ``BF16Bits``: its uint16 bit
pattern with the dtype tag, restored bit for bit by ``leaf_from_host``.

* ``save_checkpoint``: device->host transfer, pickle to tmp, atomic rename.
* ``AsyncCheckpointer``: runs the host transfer synchronously and the
  serialization/fsync on a background thread; ``wait()`` joins before the
  next save or at exit.
* retention: keep the newest K checkpoints; ``latest_step``/auto-resume.
"""
from __future__ import annotations

import os
import pickle
import re
import tempfile
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

_STEP_RE = re.compile(r"ckpt_(\d+)\.pkl$")


class BF16Bits:
    """A bfloat16 array on the host, kept as its uint16 bit pattern.
    ``np.asarray`` of it gives the float32 values (exact: every bf16 value
    is a float32)."""

    dtype = "bfloat16"

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint16)

    @property
    def shape(self):
        return self.bits.shape

    def __array__(self, dtype=None, copy=None):
        f = (self.bits.astype(np.uint32) << np.uint32(16)).view(np.float32)
        return f if dtype is None else f.astype(dtype)

    def __repr__(self):
        return f"BF16Bits(shape={self.bits.shape})"


def leaf_to_host(x: Any) -> Any:
    """A tensor -> a numpy copy (``BF16Bits`` for bfloat16); anything else
    through ``np.asarray``."""
    if isinstance(x, BF16Bits):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return BF16Bits(t.view(torch.int16).cpu().numpy()
                            .view(np.uint16).copy())
        return t.cpu().numpy().copy()
    return np.asarray(x)


def leaf_from_host(a: Any, device) -> torch.Tensor:
    """A host leaf (numpy, ``BF16Bits``, an ml_dtypes bfloat16 array, a
    tensor) -> a tensor on ``device``, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    if isinstance(a, BF16Bits):
        bits = a.bits
    else:
        arr = np.asarray(a)
        if arr.dtype.name != "bfloat16":
            return torch.from_numpy(np.array(arr, copy=True)).to(device)
        bits = arr.view(np.uint16)
    t = torch.from_numpy(np.array(bits, copy=True).view(np.int16))
    return t.view(torch.bfloat16).to(device)


def _to_host(tree: Any) -> Any:
    return pytree.tree_map(leaf_to_host, tree)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"step": step, "tree": _to_host(tree), "extra": extra or {}}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.pkl")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = _STEP_RE.search(f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.pkl")
    with open(path, "rb") as fh:
        return pickle.load(fh)


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves = 0

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None):
        self.wait()
        host_tree = _to_host(tree)   # synchronous D2H; serialization is async

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._retain()
            except BaseException as e:  # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saves += 1

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self):
        steps = list_steps(self.ckpt_dir)
        for s in steps[:-self.keep]:
            p = os.path.join(self.ckpt_dir, f"ckpt_{s:08d}.pkl")
            if os.path.exists(p):
                os.unlink(p)

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        self.wait()
        return load_checkpoint(self.ckpt_dir)
