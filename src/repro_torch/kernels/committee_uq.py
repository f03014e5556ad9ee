"""Wrapper of the Hopper ``committee_uq`` kernel (``csrc/committee_uq.cu``).

Checks its inputs, allocates the five outputs with ``torch.empty``, launches
the kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch in ``launches``.  It never falls back to the plain
version: ``ops.committee_uq`` sends CPU tensors to ``ref.committee_uq_ref``
and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.launch.platform import DeviceLike, resolve_device

MAX_D = 256             # 8 components per lane, one warp per row
# the input types the kernel loads (each element converted to fp32 as it is
# read, as the reference's `preds.astype(jnp.float32)`)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("committee_uq")
    if not _bound:
        ptr = ctypes.c_void_p
        lib.committee_uq_launch.argtypes = [
            ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
        lib.committee_uq_launch.restype = ctypes.c_int
        _bound = True
    return lib


def committee_uq(preds: torch.Tensor, threshold: float, *,
                 block_n: int = 128, device: DeviceLike = None):
    """Fused committee mean / ddof=1 std statistics / threshold mask.

    ``preds``: (K, n, d) fp32, bf16 or fp16, contiguous, on ``device``
    (default: the CUDA device); the kernel converts each element to fp32
    as it loads it (no cast in the wrapper).  Returns ``(mean (n, d) fp32, scalar_std (n,) fp32,
    component_std (n,) fp32, mask (n,) bool, finite (n,) int32)`` with the
    semantics of ``ref.committee_uq_ref``.  ``block_n`` is accepted for
    parity with the reference's signature; the kernel masks the ragged tail
    of rows itself and needs no row blocking."""
    global launches
    dev = resolve_device(device)
    if preds.device != dev or dev.type != "cuda":
        raise ValueError(f"committee_uq kernel: preds on {preds.device}, "
                         f"expected the CUDA device {dev}")
    if preds.dtype not in _DTYPE_CODE:
        raise TypeError(f"committee_uq kernel takes float32, bfloat16 or "
                        f"float16, got {preds.dtype}")
    if preds.dim() != 3 or not preds.is_contiguous():
        raise ValueError("committee_uq kernel takes a contiguous (K, n, d) "
                         f"tensor, got shape {tuple(preds.shape)}")
    K, n, d = preds.shape
    if K < 1 or d < 1 or d > MAX_D:
        raise ValueError(f"committee_uq kernel takes K >= 1 and "
                         f"1 <= d <= {MAX_D}, got K={K}, d={d}")
    mean = torch.empty((n, d), dtype=torch.float32, device=dev)
    sstd = torch.empty((n,), dtype=torch.float32, device=dev)
    cstd = torch.empty((n,), dtype=torch.float32, device=dev)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    finite = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return mean, sstd, cstd, mask, finite
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.committee_uq_launch(
            preds.data_ptr(), K, n, d, float(threshold), mean.data_ptr(),
            sstd.data_ptr(), cstd.data_ptr(), mask.data_ptr(),
            finite.data_ptr(), _DTYPE_CODE[preds.dtype], stream)
    if err != 0:
        raise RuntimeError(f"committee_uq kernel launch failed: CUDA error "
                           f"{err} (K={K}, n={n}, d={d})")
    with _count_lock:
        launches += 1
    return mean, sstd, cstd, mask, finite
