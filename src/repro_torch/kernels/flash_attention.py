"""Wrapper of the Hopper ``flash_attention`` kernels
(``csrc/flash_attention.cu``).

Checks its inputs, picks a path by shape (``plan``), allocates the output
and the split-KV scratch with ``torch.empty``, launches on the current CUDA
stream, raises if a launch was refused, and counts the call in
``launches`` and in the count of its path.  It never falls back to the
plain version: ``ops.attention`` sends CPU tensors to ``ref.attention_ref``
/ ``ref.attention_chunked_ref`` and CUDA tensors here.

Two paths, both with every option of ``ref.attention_ref`` (GQA, causal,
window, ``q_offset``, ``kv_len``, ragged T and S, 0 for fully masked
rows), so the choice affects speed only:

* ``tiled`` (more than ``SPLIT_MAX_ROWS`` (t, g) rows per kv head, every
  prefill): bf16 on the tensor cores (``mma.sync`` with a ``cp.async``
  K/V ring), fp32 on the CUDA cores;
* ``split`` (at most ``SPLIT_MAX_ROWS`` rows, every decode step): the key
  axis cut into ``splits`` ranges, one block per range and kv head reading
  K/V with 16-byte loads straight into registers (bf16 on the tensor
  cores, fp32 on the CUDA cores), fp32 partials merged in split order by a
  second kernel (the same bits on every run).

On both bf16 paths P enters the P·V product as two bf16 parts (hi + lo),
so the result holds the reference's bf16 tolerance where one bf16 P would
not (sharp attention over large values that cancel).

Unlike the Pallas kernel, which raises unless T and S tile by its blocks,
the CUDA kernels mask ragged tails themselves and take any T and S.

A decode step whose position lives on the device (a captured decode
graph replays one program at every position) passes ``q_offset`` as a
tensor: the kernels then take batch row b's offset on the device as
``kv_len[b] - T`` (the cache filled to ``kv_len[b]`` after this step's T
tokens), so nothing of the position is baked into the launch.

A sequence-sharded cache (``ops.attention(kv_seq_shard=True)`` on a mesh)
uses the split path's two kernels apart: ``flash_partials`` writes a
rank's fp32 partials for its key range, and ``flash_combine`` merges the
partials of every rank, gathered in rank order (``launches_partials``,
``launches_combine``).  Their plain versions are ``split_kv_partials``
(in the kernel's layout, ``pack_partials``) and ``combine_partials``,
whose composition is ``split_kv_model``.

Counting: a call made eagerly adds one to ``launches`` and to its path's
counter (``launches_tiled`` / ``launches_split``; ``launches_partials``,
``launches_combine``); a call recorded into a CUDA graph under capture adds
to the same keys of ``captured`` instead (it runs only when the graph is
replayed, and whoever replays the graph adds its launches with
``count_replays``).
"""
from __future__ import annotations

import ctypes
import math
import operator
import threading
from typing import Dict, NamedTuple, Optional, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._guard import refuse_grad
from repro_torch.launch.platform import DeviceLike, resolve_device

HEAD_DIMS = (16, 64, 120, 128)          # the kernels' template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"tiled": 0, "split": 1}
SPLIT_MAX_ROWS = 8          # T*G rows a split-KV block holds in registers
SPLIT_MIN_KEYS = 64         # keys a split takes at least (when S has them)
SPLIT_BLOCKS_PER_SM = 2     # blocks per SM the rule aims at (measured best
H100_SMS = 132              # at both serving decode shapes, PERF.md)
SPLIT_MAX_SPLITS = 128      # bounds the scratch and the merge's loop
launches = 0                # wrapper calls since the last reset
launches_tiled = 0          # ... of them on the tiled path
launches_split = 0          # ... of them on the split-KV path
launches_partials = 0       # flash_partials calls (a rank's key range)
launches_combine = 0        # flash_combine calls (the ranks' merge)
COUNTERS = ("launches", "launches_tiled", "launches_split",
            "launches_partials", "launches_combine")
# calls recorded into CUDA graphs under capture, by counter
captured = dict.fromkeys(COUNTERS, 0)
_count_lock = threading.Lock()
_bound = False


class Plan(NamedTuple):
    path: str               # "tiled" or "split"
    splits: int             # key ranges (1 on the tiled path)
    keys_per_split: int     # keys in each range but the last (S if tiled)


def plan(B: int, T: int, S: int, H: int, KV: int) -> Plan:
    """The path and split count for q (B, T, H, D) against a cache of S
    keys over KV kv heads.  More than ``SPLIT_MAX_ROWS`` (t, g) rows per kv
    head take the tiled path.  Otherwise the key axis is cut into the
    fewest splits that put ``SPLIT_BLOCKS_PER_SM`` blocks on each of the
    H100's SMs, but never into ranges of fewer than ``SPLIT_MIN_KEYS``
    keys (one range when S has fewer) nor more than ``SPLIT_MAX_SPLITS``;
    the ranges are equal but for the last."""
    if T * (H // KV) > SPLIT_MAX_ROWS:
        return Plan("tiled", 1, S)
    want = -(-(SPLIT_BLOCKS_PER_SM * H100_SMS) // (B * KV))
    splits = max(1, min(want, S // SPLIT_MIN_KEYS, SPLIT_MAX_SPLITS))
    keys = max(1, -(-S // splits))
    return Plan("split", max(1, -(-S // keys)), keys)


def split_kv_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      splits: int, keys_per_split: int, causal: bool = True,
                      window: Optional[int] = None,
                      q_offset: Union[int, torch.Tensor] = 0,
                      kv_len: Optional[torch.Tensor] = None):
    """The split kernels' partials in plain PyTorch: for each key range of
    ``keys_per_split`` keys, fp32 (m in log2 units, l, acc) over its visible
    keys -- (-inf, 0, 0) for a range with none.  ``q_offset`` as
    ``ref.attention_ref``'s (a host int, or a 0-dim or (B,) tensor).
    Returns (m, l, acc) of shapes (splits, B, KV, G, T) and (splits, B, KV,
    G, T, D)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qf = q.float().reshape(B, T, KV, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale_log2
    kpos = torch.arange(S, device=dev)[None, :]
    vis = ref._mask(T, S, q_offset, causal, window, dev).expand(B, T, S)
    if kv_len is not None:
        vis = vis & (kpos < kv_len.to(dev)[:, None, None])
    vis = vis[:, None, None]                           # (B, 1, 1, T, S)
    s = s.masked_fill(~vis, float("-inf"))
    vf = v.float()
    m_all, l_all, acc_all = [], [], []
    for i in range(splits):
        lo, hi = i * keys_per_split, min(S, (i + 1) * keys_per_split)
        si = s[..., lo:hi]
        m = si.amax(dim=-1) if hi > lo else torch.full(
            s.shape[:-1], float("-inf"), device=dev)
        base = torch.where(m == float("-inf"), 0.0, m)
        p = torch.exp2(si - base[..., None])
        m_all.append(m)
        l_all.append(p.sum(dim=-1))
        acc_all.append(torch.einsum("bkgts,bskd->bkgtd", p, vf[:, lo:hi]))
    return torch.stack(m_all), torch.stack(l_all), torch.stack(acc_all)


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Merge ``split_kv_partials``' partials (splits first, merged in split
    order): o = acc / l over the common maximum, 0 where l == 0; (B, T, H,
    D) in ``dtype``."""
    S_, B, KV, G, T, D = acc.shape
    m_max = m.amax(dim=0)
    base = torch.where(m_max == float("-inf"), 0.0, m_max)
    L = torch.zeros_like(base)
    out = torch.zeros(B, KV, G, T, D, device=acc.device)
    for i in range(S_):                          # fixed split order
        w = torch.exp2(m[i] - base)
        L = L + l[i] * w
        out = out + acc[i] * w[..., None]
    out = torch.where(L[..., None] == 0, 0.0,
                      out / torch.where(L == 0, 1.0, L)[..., None])
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, KV * G, D).to(dtype)


def split_kv_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   splits: int, keys_per_split: int, causal: bool = True,
                   window: Optional[int] = None,
                   q_offset: Union[int, torch.Tensor] = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The split-KV path's arithmetic in plain PyTorch: for each key range
    of ``keys_per_split`` keys, fp32 partials (m in log2 units, l, acc)
    over its visible keys -- (-inf, 0, 0) for a range with none -- then
    the partials merged in split order, o = acc / l (0 where l == 0).
    Holds the design against ``ref.attention_ref`` on the CPU; the kernel
    runs the same steps on the card."""
    m, l, acc = split_kv_partials(q, k, v, splits=splits,
                                  keys_per_split=keys_per_split,
                                  causal=causal, window=window,
                                  q_offset=q_offset, kv_len=kv_len)
    return combine_partials(m, l, acc, v.dtype)


def pack_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                  ) -> torch.Tensor:
    """``split_kv_partials``' partials in the kernel's flat fp32 layout:
    acc rows ((b*KV + kvh)*splits + split)*R + r (r = t*G + g) of D
    floats, then one (m, l) pair per row."""
    S_, B, KV, G, T, D = acc.shape
    rows_acc = acc.permute(1, 2, 0, 4, 3, 5).reshape(-1, D)
    ml = torch.stack([m, l], dim=-1).permute(1, 2, 0, 4, 3, 5)
    return torch.cat([rows_acc.reshape(-1), ml.reshape(-1)])


def unpack_partials(part: torch.Tensor, B: int, T: int, H: int, KV: int,
                    D: int, splits: int):
    """``pack_partials`` inverted: (m, l, acc) as ``split_kv_partials``
    returns them."""
    G = H // KV
    rows = B * KV * splits * T * G
    acc = part[:rows * D].reshape(B, KV, splits, T, G, D)
    ml = part[rows * D:rows * (D + 2)].reshape(B, KV, splits, T, G, 2)
    return (ml[..., 0].permute(2, 0, 1, 4, 3),
            ml[..., 1].permute(2, 0, 1, 4, 3),
            acc.permute(2, 0, 1, 4, 3, 5))


def _count(*names: str) -> None:
    capturing = torch.cuda.is_current_stream_capturing()
    counters = globals()
    with _count_lock:
        for name in names:
            if capturing:
                captured[name] += 1
            else:
                counters[name] += 1


def count_replays(n: Dict[str, int]) -> None:
    """Add the launches a replayed CUDA graph made (``n``: counts by
    counter name, as ``captured`` holds them) to the counters."""
    counters = globals()
    with _count_lock:
        for name, k in n.items():
            counters[name] += k


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("flash_attention")
    if not _bound:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, ctypes.c_float, i32, i32, i32, ptr, ptr]
        lib.flash_attention_decode.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, ctypes.c_float, i32, i32, i32, ptr, ptr]
        lib.flash_attention_partials.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, ctypes.c_float, i32, i32, ptr, ptr]
        lib.flash_attention_combine.argtypes = [
            ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        for fn in (lib.flash_attention_launch, lib.flash_attention_decode,
                   lib.flash_attention_partials,
                   lib.flash_attention_combine):
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def _check(q, k, v, window, kv_len, dev):
    """The checks of every entry on q, k, v: device, dtype, shapes, head
    dim, contiguity and alignment; returns ``kv_len`` as contiguous int32
    (or None)."""
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
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got D={D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes 16-byte aligned q, "
                         "k, v (it reads them with 16-byte loads)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention kernel: window must be positive, "
                         f"got {window}")
    if kv_len is not None:
        if not isinstance(kv_len, torch.Tensor) or kv_len.device != dev \
                or tuple(kv_len.shape) != (B,):
            raise ValueError(f"flash_attention kernel: kv_len must be a "
                             f"({B},) tensor on {dev}")
        kv_len = kv_len.to(torch.int32).contiguous()
    return kv_len


def _raise_on(err: int, what: str, q, k, detail) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} (q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}, {detail})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Union[int, torch.Tensor] = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Attention of q (B, T, H, D) against k, v (B, S, KV, D) with the
    semantics of ``ref.attention_ref``: fp32 scores and softmax, GQA
    (``H % KV == 0``), causal and sliding-window masks, query positions
    offset by ``q_offset``, a per-batch ``kv_len`` (B,) device tensor, and
    0 for fully masked rows.  q, k, v: one dtype (fp32 or bf16),
    contiguous and 16-byte aligned, on ``device`` (default: the CUDA
    device); D in ``HEAD_DIMS``.  Returns (B, T, H, D) in that dtype.

    ``q_offset`` is a host int, or a decode step's position as an integer
    tensor (0-dim or (B,)) on the device; the tensor must hold
    ``kv_len - T``, and needs ``kv_len``: the kernel takes batch row b's
    offset as ``kv_len[b] - T`` on the device and never reads the tensor
    on the host, so a captured graph replays at any position."""
    refuse_grad("flash_attention", q, k, v)
    dev = resolve_device(device)
    kv_len = _check(q, k, v, window, kv_len, dev)
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    on_device = isinstance(q_offset, torch.Tensor)
    if on_device:
        if kv_len is None:
            raise ValueError("flash_attention kernel: a tensor q_offset (a "
                             "decode position on the device) needs kv_len")
        if q_offset.device != dev or q_offset.dtype.is_floating_point or \
                q_offset.dim() > 1:
            raise ValueError(f"flash_attention kernel: a tensor q_offset "
                             f"must be an integer 0-dim or ({B},) tensor on "
                             f"{dev}")
    else:
        q_offset = operator.index(q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    p = plan(B, T, S, H, KV)
    scratch = None
    if p.splits > 1:            # fp32 partials: acc (.., D), then (m, l)
        scratch = torch.empty(B * T * H * p.splits * (D + 2),
                              dtype=torch.float32, device=dev)
    lib = _lib()
    scale = 1.0 / math.sqrt(D)        # as the TPU kernel's, rounded to fp32
    win = 0 if window is None else int(window)
    part = scratch.data_ptr() if scratch is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if on_device:
            err = lib.flash_attention_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kv_len.data_ptr(), B, T, S, H, KV, D, _DTYPE_CODE[q.dtype],
                int(causal), win, scale, _PATH_CODE[p.path], p.splits,
                p.keys_per_split, part, stream)
        else:
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kv_len.data_ptr() if kv_len is not None else None,
                B, T, S, H, KV, D, _DTYPE_CODE[q.dtype], q_offset,
                int(causal), win, scale, _PATH_CODE[p.path], p.splits,
                p.keys_per_split, part, stream)
    _raise_on(err, "flash_attention kernel", q, k, p)
    _count("launches", f"launches_{p.path}")
    return out


def flash_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                   device: DeviceLike = None):
    """The split kernel's fp32 partials of q (B, T, H, D) against this
    rank's key range k, v (B, S, KV, D), in ``pack_partials``' layout, for
    the split plan ``plan(B, T, S, H, KV)`` (key ranges of the rank's S
    keys; ``q_offset`` and ``kv_len`` already shifted by the range's start,
    so ``q_offset`` may be negative).  Returns ``(part, splits)``.
    T * (H // KV) must be at most ``SPLIT_MAX_ROWS`` (decode)."""
    refuse_grad("flash_partials", q, k, v)
    dev = resolve_device(device)
    kv_len = _check(q, k, v, window, kv_len, dev)
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    if T * (H // KV) > SPLIT_MAX_ROWS:
        raise ValueError(f"flash_partials: {T * (H // KV)} (t, g) rows per "
                         f"kv head, the split kernel holds at most "
                         f"{SPLIT_MAX_ROWS}")
    p = plan(B, T, max(S, 1), H, KV)
    part = torch.empty(B * T * H * p.splits * (D + 2), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None,
            B, T, S, H, KV, D, _DTYPE_CODE[q.dtype],
            operator.index(q_offset), int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(D),
            p.splits, p.keys_per_split, part.data_ptr(), stream)
    _raise_on(err, "flash_partials", q, k, p)
    _count("launches_partials")
    return part, p.splits


def flash_combine(parts: torch.Tensor, *, ranks: int, splits: int, B: int,
                  T: int, H: int, KV: int, D: int, dtype: torch.dtype,
                  device: DeviceLike = None) -> torch.Tensor:
    """Merge ``ranks`` ranks' ``flash_partials`` buffers (one after another
    in rank order, ``splits`` splits each) in (rank, split) order: the
    attention output (B, T, H, D) in ``dtype``."""
    dev = resolve_device(device)
    want = ranks * B * T * H * splits * (D + 2)
    if parts.device != dev or dev.type != "cuda" or \
            parts.dtype != torch.float32 or parts.numel() != want or \
            not parts.is_contiguous():
        raise ValueError(f"flash_combine takes {want} contiguous float32 "
                         f"partials on {dev}, got {parts.numel()} "
                         f"{parts.dtype} on {parts.device}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_combine writes float32 or bfloat16, not "
                        f"{dtype}")
    out = torch.empty((B, T, H, D), dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_combine(
            parts.data_ptr(), out.data_ptr(), B, T, H, KV, D,
            _DTYPE_CODE[dtype], splits, ranks, stream)
    if err != 0:
        raise RuntimeError(f"flash_combine launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, H={H}, KV={KV}, D={D}, "
                           f"{ranks} ranks x {splits} splits)")
    _count("launches_combine")
    return out
