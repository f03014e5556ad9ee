"""Wrapper of the Hopper ``wkv6`` kernel (``csrc/wkv6.cu``).

Checks its inputs, allocates the outputs with ``torch.empty``, launches the
kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch (see Counting).  It never falls back to the plain
version: ``ops.wkv6`` sends CPU tensors to ``ref.wkv6_chunked_ref`` and
CUDA tensors here.

``state_out`` may be the incoming ``state`` itself (a layer's slice of the
serving cache): the kernel reads each (b, h) slice before it writes it.

bf16 inputs run on the tensor cores (8-row sub-chunks carried through the
state, decays as running products of w, three bf16 terms per fp32
operand); ``subchunk_model`` is that arithmetic in plain PyTorch, held
against the reference on the CPU.  fp32 inputs run on the CUDA cores.

Counting: a launch made eagerly adds one to ``launches``; a launch recorded
into a CUDA graph under capture adds one to ``captured`` instead (it runs
only when the graph is replayed, and whoever replays the graph adds its
launches with ``count_replays``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._guard import refuse_grad
from repro_torch.kernels.bf16_terms import mm_terms
from repro_torch.launch.platform import DeviceLike, resolve_device

HEAD_DIMS = (16, 32, 64)                # the kernel's template instances
MAX_CHUNK = 64
SUB = 8             # rows per sub-chunk of the bf16 kernel's recurrence
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
launches = 0            # kernel launches since the last reset
captured = 0            # launches recorded into CUDA graphs under capture
_count_lock = threading.Lock()
_bound = False


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


def subchunk_model(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None, *, sub: int = SUB,
                   split: int = 0):
    """The bf16 kernel's arithmetic in plain PyTorch: the recurrence over
    sub-chunks of ``sub`` rows (the last one ragged), whatever the chunk.
    Per sub-chunk, with wc = max(w, 1e-12), pre[t] the product of wc over
    the sub-chunk's rows before t, suf[j] the product over its rows after j,
    dec the product over all of them, and P[t, j] the product over the rows
    strictly between j and t, all formed as running products in row order:

      y = (r * pre) @ S + A @ v,
      A[t, j] = sum_n r[t,n] (k[j,n] P[t,j,n]), j < t,
      A[t, t] = sum_n r[t,n] u[n] k[t,n]  (the bonus),
      S' = dec * S + (k * suf)^T @ v.

    This is the sub-chunk factorisation of the chunk's decay: the weight of
    key j on row t of a later sub-chunk, prod_{j<s<t} wc[s], is pre[t]
    times the decays of the whole sub-chunks between them (carried by S)
    times suf[j], each a product of factors in (0, 1], so none overflows,
    where the chunk-wide exp(excl) * exp(-incl) does.  No exp or log is
    left: the (sub x sub) diagonal blocks are running products too.  The
    reference floors a decay between two rows of a chunk at e^-60 (its
    clip at -60); these products fall below it only where that changes
    the result by less than e^-60 |r| |k| |v| per term, so the floor is
    not kept.  ``split``: 0 for fp32 products, else the number of bf16
    terms of each operand of each product, as the kernel's ``mma.sync``
    forms it with 3 (``bf16_terms.mm_terms``).  Returns (y in ``v.dtype``,
    the state (B, H, N, N) fp32); equal to ``ref.wkv6_ref`` up to
    rounding."""
    B, T, H, N = r.shape
    rf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v))
    wc = w.float().clamp_min(1e-12).permute(0, 2, 1, 3)
    uf = u.float()[None]
    S = (torch.zeros((B, H, N, N), device=r.device) if state is None
         else state.float().clone())
    ys = []
    for t0 in range(0, T, sub):
        rs, ks, vs, ws = (x[:, :, t0:t0 + sub] for x in (rf, kf, vf, wc))
        L = rs.shape[2]
        pre = [torch.ones_like(ws[:, :, 0])]
        for t in range(L):
            pre.append(pre[-1] * ws[:, :, t])
        A = torch.zeros((B, H, L, L), device=r.device)
        kd = torch.empty_like(ks)
        for j in range(L):
            A[:, :, j, j] = (rs[:, :, j] * uf * ks[:, :, j]).sum(-1)
            kq = ks[:, :, j]
            for t in range(j + 1, L):
                A[:, :, t, j] = (rs[:, :, t] * kq).sum(-1)
                kq = kq * ws[:, :, t]
            kd[:, :, j] = kq
        qd = rs * torch.stack(pre[:L], dim=2)
        y = mm_terms(qd, S, split) + mm_terms(A, vs, split)
        S = pre[L][..., None] * S + mm_terms(kd.transpose(2, 3), vs, split)
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(v.dtype), S


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
    refuse_grad("wkv6", r, k, v, w, u, state)
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
    if r.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (r, k, v, w)):
        raise ValueError("wkv6 kernel takes 16-byte aligned bf16 r, k, v, "
                         "w (it copies them in 16-byte pieces)")
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
    _count()
    return y, state_out
