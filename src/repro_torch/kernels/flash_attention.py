"""Wrapper of the Hopper ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

Checks its inputs, allocates the output with ``torch.empty``, launches the
kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch in ``launches``.  It never falls back to the plain
version: ``ops.attention`` sends CPU tensors to ``ref.attention_ref`` /
``ref.attention_chunked_ref`` and CUDA tensors here.

Unlike the Pallas kernel, which raises unless T and S tile by its blocks,
the CUDA kernel masks ragged tails itself and takes any T and S.
"""
from __future__ import annotations

import ctypes
import math
import operator
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch.platform import DeviceLike, resolve_device

HEAD_DIMS = (16, 64, 120, 128)          # the kernel's template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("flash_attention")
    if not _bound:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, ctypes.c_float, ptr]
        lib.flash_attention_launch.restype = ctypes.c_int
        _bound = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Attention of q (B, T, H, D) against k, v (B, S, KV, D) with the
    semantics of ``ref.attention_ref``: fp32 scores and softmax, GQA
    (``H % KV == 0``), causal and sliding-window masks, query positions
    offset by ``q_offset`` (a host int), a per-batch ``kv_len`` (B,)
    device tensor, and 0 for fully masked rows.  q, k, v: one dtype (fp32
    or bf16), contiguous, on ``device`` (default: the CUDA device);
    D in ``HEAD_DIMS``.  Returns (B, T, H, D) in that dtype."""
    global launches
    dev = resolve_device(device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} on {t.device}, "
                             f"expected the CUDA device {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel takes q (B,T,H,D) and k, v "
                         f"(B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got D={D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention kernel: window must be positive, "
                         f"got {window}")
    q_offset = operator.index(q_offset)
    if kv_len is not None:
        if not isinstance(kv_len, torch.Tensor) or kv_len.device != dev \
                or tuple(kv_len.shape) != (B,):
            raise ValueError(f"flash_attention kernel: kv_len must be a "
                             f"({B},) tensor on {dev}")
        kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    scale = 1.0 / math.sqrt(D)        # as the TPU kernel's, rounded to fp32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None,
            B, T, S, H, KV, D, _DTYPE_CODE[q.dtype], q_offset, int(causal),
            0 if window is None else int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    with _count_lock:
        launches += 1
    return out
