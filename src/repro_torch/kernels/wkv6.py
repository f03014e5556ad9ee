"""Wrapper of the Hopper ``wkv6`` kernel (``csrc/wkv6.cu``).

Checks its inputs, allocates the outputs with ``torch.empty``, launches the
kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch in ``launches``.  It never falls back to the plain
version: ``ops.wkv6`` sends CPU tensors to ``ref.wkv6_chunked_ref`` and
CUDA tensors here.

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

HEAD_DIMS = (16, 32, 64)                # the kernel's template instances
MAX_CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("wkv6")
    if not _bound:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        lib.wkv6_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _state_arg(s: torch.Tensor, name: str, shape, dev) -> torch.Tensor:
    if s.device != dev or s.dtype != torch.float32 or \
            tuple(s.shape) != shape or not s.is_contiguous():
        raise ValueError(f"wkv6 kernel: {name} must be a contiguous float32 "
                         f"{shape} tensor on {dev}, got {tuple(s.shape)} "
                         f"{s.dtype} on {s.device}")
    return s


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         chunk: int = 64, state_out: Optional[torch.Tensor] = None,
         device: DeviceLike = None):
    """The WKV6 recurrence with the semantics of ``ref.wkv6_chunked_ref``.
    r, k, v, w: (B, T, H, N) of one dtype (fp32 or bf16), contiguous, on
    ``device`` (default: the CUDA device), N in ``HEAD_DIMS``; u: (H, N)
    fp32; state: (B, H, N, N) fp32 or None (zeros); ``chunk`` in
    [1, ``MAX_CHUNK``] dividing T.  Returns (y (B, T, H, N) in the inputs'
    dtype, the new state (B, H, N, N) fp32, written into ``state_out`` when
    given)."""
    global launches
    dev = resolve_device(device)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"wkv6 kernel: {name} on {t.device}, expected "
                             f"the CUDA device {dev}")
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype
                                         for t in (k, v, w)):
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r, k, v, w "
                        f"of one dtype, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"wkv6 kernel takes a float32 u, got {u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 kernel takes r, k, v, w of one (B,T,H,N) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, T, H, N = r.shape
    if N not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims {HEAD_DIMS}, got N={N}")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6 kernel: u must be ({H}, {N}), got "
                         f"{tuple(u.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or T < 1 or T % chunk:
        raise ValueError(f"wkv6 kernel: chunk={chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide T={T}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("wkv6 kernel takes contiguous r, k, v, w, u")
    shape = (B, H, N, N)
    if state is not None:
        _state_arg(state, "state", shape, dev)
    if state_out is None:
        state_out = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        _state_arg(state_out, "state_out", shape, dev)
    y = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr() if state is not None else None,
            state_out.data_ptr(), y.data_ptr(), B, T, H, N, chunk,
            _DTYPE_CODE[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err} "
                           f"(r {tuple(r.shape)}, {r.dtype}, chunk {chunk})")
    with _count_lock:
        launches += 1
    return y, state_out
