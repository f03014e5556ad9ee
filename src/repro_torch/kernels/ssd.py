"""Wrapper of the Hopper ``ssd`` kernel (``csrc/ssd.cu``).

Checks its inputs, allocates the outputs with ``torch.empty``, launches the
kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch in ``launches``.  It never falls back to the plain
version: ``ops.ssd`` sends CPU tensors to ``ref.ssd_chunked_ref`` and CUDA
tensors here.

``Bm`` and ``Cm`` are read through their strides, so a projection broadcast
across the heads with ``expand`` (stride 0 on h, as Jamba's mixer makes
them) reaches the kernel as it is, never materialized per head.
``state_out`` may be the incoming ``state`` itself (a layer's slice of the
serving cache): the kernel reads each (b, h) slice before it writes it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch.platform import DeviceLike, resolve_device

HEAD_DIMS = (16, 32, 128)               # P: the kernel's template instances
STATE_DIMS = (8, 16)                    # N
MAX_CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("ssd")
    if not _bound:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_launch.argtypes = ([ptr] * 4 + [i64] * 6 + [ptr] * 3
                                   + [i32] * 7 + [ptr])
        lib.ssd_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _state_arg(s: torch.Tensor, name: str, shape, dev) -> torch.Tensor:
    if s.device != dev or s.dtype != torch.float32 or \
            tuple(s.shape) != shape or not s.is_contiguous():
        raise ValueError(f"ssd kernel: {name} must be a contiguous float32 "
                         f"{shape} tensor on {dev}, got {tuple(s.shape)} "
                         f"{s.dtype} on {s.device}")
    return s


def ssd(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        state: Optional[torch.Tensor] = None, *, chunk: int = 64,
        state_out: Optional[torch.Tensor] = None, device: DeviceLike = None):
    """The SSD scan with the semantics of ``ref.ssd_chunked_ref``.  x:
    (B, T, H, P) and a: (B, T, H), contiguous; Bm, Cm: (B, T, H, N) with N
    contiguous (any strides on b, t, h, 0 included); all of one dtype (fp32
    or bf16) on ``device`` (default: the CUDA device); P in ``HEAD_DIMS``,
    N in ``STATE_DIMS``; state: (B, H, N, P) fp32 or None (zeros);
    ``chunk`` in [1, ``MAX_CHUNK``] dividing T.  Returns (y (B, T, H, P) in
    x's dtype, the new state (B, H, N, P) fp32, written into ``state_out``
    when given)."""
    global launches
    dev = resolve_device(device)
    for name, t in (("x", x), ("a", a), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"ssd kernel: {name} on {t.device}, expected "
                             f"the CUDA device {dev}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (a, Bm, Cm)):
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x, a, Bm, Cm "
                        f"of one dtype, got {x.dtype}, {a.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd kernel takes x (B,T,H,P) and Bm, Cm "
                         f"(B,T,H,N), got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(a.shape) != (B, T, H) or tuple(Bm.shape) != (B, T, H, N) or \
            tuple(Cm.shape) != (B, T, H, N):
        raise ValueError(f"ssd kernel: a must be ({B},{T},{H}) and Bm, Cm "
                         f"({B},{T},{H},N), got {tuple(a.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes head dims P in {HEAD_DIMS} and "
                         f"state dims N in {STATE_DIMS}, got P={P}, N={N}")
    if not 1 <= chunk <= MAX_CHUNK or T < 1 or T % chunk:
        raise ValueError(f"ssd kernel: chunk={chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide T={T}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd kernel takes contiguous x and a")
    if Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd kernel takes Bm and Cm with a contiguous last "
                         "(N) dimension")
    shape = (B, H, N, P)
    if state is not None:
        _state_arg(state, "state", shape, dev)
    if state_out is None:
        state_out = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        _state_arg(state_out, "state_out", shape, dev)
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_launch(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            *Bm.stride()[:3], *Cm.stride()[:3],
            state.data_ptr() if state is not None else None,
            state_out.data_ptr(), y.data_ptr(), B, T, H, P, N, chunk,
            _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, {x.dtype}, N {N}, chunk "
                           f"{chunk})")
    with _count_lock:
        launches += 1
    return y, state_out
