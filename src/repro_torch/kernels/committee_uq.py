"""Wrapper of the Hopper ``committee_uq`` kernel (``csrc/committee_uq.cu``).

Two entries, one kernel.  ``committee_uq`` allocates the five outputs with
``torch.empty``; ``committee_uq_packed`` writes them into one byte buffer
(``out`` when given: then it allocates nothing) and masks rows at or past a
device-resident ``n_valid``.  Each checks its inputs, launches on the
current CUDA stream, raises if the launch was refused, and never falls back
to the plain version: ``ops`` sends CPU tensors to ``ref`` and CUDA tensors
here.

Counting: a launch made eagerly adds one to ``launches``; a launch recorded
into a CUDA graph under capture adds one to ``captured`` instead (it runs
only when the graph is replayed, and whoever replays the graph adds its
launches with ``count_replays``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._guard import refuse_grad
from repro_torch.kernels.ref import packed_uq_nbytes
from repro_torch.launch.platform import DeviceLike, resolve_device

MAX_D = 256             # 8 components per lane, one warp per row
# the input types the kernel loads (each element converted to fp32 as it is
# read, as the reference's `preds.astype(jnp.float32)`)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
launches = 0            # kernel launches since the last reset
captured = 0            # launches recorded into CUDA graphs under capture
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
        lib.committee_uq_packed_launch.argtypes = [
            ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ptr, ptr, ctypes.c_int, ptr]
        lib.committee_uq_packed_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _count() -> None:
    global launches, captured
    capturing = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if capturing:
            captured += 1
        else:
            launches += 1


def count_replays(n: int) -> None:
    """Add the ``n`` launches a replayed CUDA graph made to ``launches``."""
    global launches
    with _count_lock:
        launches += n


def _check_preds(preds: torch.Tensor, dev: torch.device):
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
    return K, n, d


def _raise_on(err: int, K: int, n: int, d: int) -> None:
    if err != 0:
        raise RuntimeError(f"committee_uq kernel launch failed: CUDA error "
                           f"{err} (K={K}, n={n}, d={d})")


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
    refuse_grad("committee_uq", preds)
    dev = resolve_device(device)
    K, n, d = _check_preds(preds, dev)
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
    _raise_on(err, K, n, d)
    _count()
    return mean, sstd, cstd, mask, finite


def committee_uq_packed(preds: torch.Tensor, threshold: float,
                        n_valid: torch.Tensor, *,
                        out: torch.Tensor = None,
                        device: DeviceLike = None) -> torch.Tensor:
    """The acquisition engine's entry: the statistics of ``committee_uq``
    and mask = row < n_valid & finite > 0 & scalar_std > fp32(threshold),
    written into one uint8 buffer of ``ref.packed_uq_nbytes(n, d)`` bytes
    (``ref.packed_uq_views`` gives the layout).

    ``n_valid``: one int32 on the device, read by the kernel (so a CUDA
    graph may replay the launch with a new count).  ``out``: the buffer to
    write, 1-D uint8 contiguous on the device, of exactly that size; the
    call then allocates nothing.  Raises on anything else."""
    refuse_grad("committee_uq_packed", preds)
    dev = resolve_device(device)
    K, n, d = _check_preds(preds, dev)
    if (n_valid.device != dev or n_valid.dtype != torch.int32
            or n_valid.numel() != 1):
        raise ValueError(f"committee_uq_packed: n_valid must be one int32 "
                         f"on {dev}, got {n_valid.dtype} of "
                         f"{n_valid.numel()} elements on {n_valid.device}")
    nbytes = packed_uq_nbytes(n, d)
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    elif (out.device != dev or out.dtype != torch.uint8 or out.dim() != 1
          or out.numel() != nbytes or not out.is_contiguous()):
        raise ValueError(f"committee_uq_packed: out must be a contiguous "
                         f"1-D uint8 buffer of {nbytes} bytes on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.committee_uq_packed_launch(
            preds.data_ptr(), K, n, d, float(threshold), n_valid.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[preds.dtype], stream)
    _raise_on(err, K, n, d)
    _count()
    return out
