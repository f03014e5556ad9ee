"""Wrapper of the Hopper ``ssd`` kernel (``csrc/ssd.cu``).

Checks its inputs, allocates the outputs with ``torch.empty``, launches the
kernel on the current CUDA stream, raises if the launch was refused, and
counts the launch (see Counting).  It never falls back to the plain
version: ``ops.ssd`` sends CPU tensors to ``ref.ssd_chunked_ref`` and CUDA
tensors here.

``Bm`` and ``Cm`` are read through their strides, so a projection broadcast
across the heads with ``expand`` (stride 0 on h, as Jamba's mixer makes
them) reaches the kernel as it is, never materialized per head.
``state_out`` may be the incoming ``state`` itself (a layer's slice of the
serving cache): the kernel reads each (b, h) slice before it writes it.

bf16 inputs run on the tensor cores (each chunk staged as a 64-row tile,
the products C B^T, A x, S^T C^T and x^T (B * dec) by ``mma.sync``, three
bf16 terms per fp32 operand); ``mma_model`` is that arithmetic in plain
PyTorch, held against the reference on the CPU.  fp32 inputs run on the
CUDA cores.

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

HEAD_DIMS = (16, 32, 128)               # P: the kernel's template instances
STATE_DIMS = (8, 16)                    # N
MAX_CHUNK = 64
TILE = 64           # rows the bf16 kernel stages a chunk in (zero-padded)
PARTS = 3           # bf16 terms of each fp32 operand in the bf16 kernel
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


def _copyable(t: torch.Tensor, strides: bool) -> torch.Tensor:
    """``t`` as the bf16 kernel copies it, in 16-byte pieces: its pointer
    16-byte aligned and (``strides``) its b, t, h strides multiples of 8
    elements.  Otherwise a contiguous copy, the same values: an odd view
    costs a copy, never another result."""
    if t.data_ptr() % 16 == 0 and not (strides and any(
            st % 8 for st in t.stride()[:3])):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def mma_model(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, state: Optional[torch.Tensor] = None, *,
              chunk: int = 64, split: int = PARTS):
    """The bf16 kernel's arithmetic in plain PyTorch.  Each chunk of
    ``chunk`` rows is staged as a tile of ``TILE`` rows, the rows past the
    chunk as x = B = C = 0 and a = 1 (log a = 0), so they add nothing to y
    or the state.  Per tile, with incl the cumsum of la = log(max(a,
    1e-12)) over the tile and total = incl[chunk - 1] (= incl[TILE - 1]):

      G = C @ B^T                                  (bf16 operands, exact),
      A[t, j] = G[t, j] exp(clip(incl_t - incl_j, -60, 0)) for j <= t, else 0,
      y = exp(incl) * (C @ S) + A @ x,
      S' = exp(total) S + (B * exp(clip(total - incl, -60, 0)))^T @ x,

    which is ``ref.ssd_chunked_ref`` on the padded tile, but for the
    cumsum: the fp32 logs are summed in float64, so incl and each decay
    formed from it are rounded once, where the plain version's fp32 cumsum
    rounds at every row.  ``split``: 0 for
    fp32 products, else the number of bf16 terms of each fp32 operand (S,
    A, B * dec) as the kernel's ``mma.sync`` takes them
    (``bf16_terms.mm_terms``; x and C are exact in bf16, so one term each).
    Returns (y in ``x.dtype``, the state (B, H, N, P) fp32)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if not 1 <= chunk <= TILE or T % chunk:
        raise ValueError(f"chunk={chunk} must lie in [1, {TILE}] and "
                         f"divide T={T}")
    xf, bf, cf = (z.float().permute(0, 2, 1, 3) for z in (x, Bm, Cm))
    la = torch.log(a.float().clamp_min(1e-12)).permute(0, 2, 1)
    S = (torch.zeros((B, H, N, P), device=x.device) if state is None
         else state.float().clone())
    mask = torch.tril(torch.ones((TILE, TILE), dtype=torch.bool,
                                 device=x.device))
    pad = (0, 0, 0, TILE - chunk)
    ys = []
    for c0 in range(0, T, chunk):
        xs, bs, cs = (torch.nn.functional.pad(z[:, :, c0:c0 + chunk], pad)
                      for z in (xf, bf, cf))
        incl = torch.cumsum(torch.nn.functional.pad(
            la[:, :, c0:c0 + chunk], (0, TILE - chunk)).double(), dim=-1)
        total = incl[..., -1:]
        ratio = torch.exp(torch.clamp(
            (incl[..., :, None] - incl[..., None, :]).float(), -60.0, 0.0))
        A = torch.where(mask, (cs @ bs.transpose(2, 3)) * ratio, 0.0)
        y = torch.exp(incl).float()[..., None] * mm_terms(cs, S, split) + \
            mm_terms(A, xs, split)
        bd = bs * torch.exp(torch.clamp((total - incl).float(), -60.0,
                                        0.0))[..., None]
        S = torch.exp(total).float()[..., None] * S + mm_terms(
            bd.transpose(2, 3), xs, split)
        ys.append(y[:, :, :chunk])
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(x.dtype), S


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
    refuse_grad("ssd", x, a, Bm, Cm, state)
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
    if x.dtype == torch.bfloat16:
        x, Bm, Cm = (_copyable(t, strides=i > 0) for i, t in
                     enumerate((x, Bm, Cm)))
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
    _count()
    return y, state_out
