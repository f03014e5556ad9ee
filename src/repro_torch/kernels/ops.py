"""Public kernel entry points.  The implementation follows the input's
device: a CPU tensor runs the plain PyTorch version (``ref``), a CUDA tensor
runs the hand-written kernel — or the call raises.  There is no fallback
from the kernel to the plain version."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import committee_uq as _cuq
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv6


def committee_uq(preds: torch.Tensor, threshold: float, *,
                 block_n: int = 128):
    """Fused committee UQ for the acquisition engine.

    preds: (K, n, d) stacked committee predictions.  Returns (mean (n, d)
    fp32, scalar_std (n,) fp32, component_std (n,) fp32, mask (n,) bool,
    finite (n,) int32) — the only tensors the engine ships back to the
    host.  Non-finite members are quarantined per row (degraded-K mean and
    std), exactly as ``ref.committee_uq_ref`` states."""
    if preds.device.type == "cpu":
        return ref.committee_uq_ref(preds, threshold)
    if preds.device.type == "cuda":
        return _cuq.committee_uq(preds, threshold, block_n=block_n,
                                 device=preds.device)
    raise ValueError(f"committee_uq: no implementation for device "
                     f"{preds.device}")


def committee_uq_packed(preds: torch.Tensor, threshold: float,
                        n_valid: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The acquisition engine's fused entry: ``committee_uq``'s statistics
    and mask = row < n_valid & finite > 0 & scalar_std > fp32(threshold),
    packed into one uint8 buffer (``ref.packed_uq_views`` reads it).
    ``n_valid`` is a one-element int32 tensor on the device of ``preds``;
    ``out`` is written when given."""
    if preds.device.type == "cpu":
        return ref.committee_uq_packed_ref(preds, threshold, n_valid,
                                           out=out)
    if preds.device.type == "cuda":
        return _cuq.committee_uq_packed(preds, threshold, n_valid, out=out,
                                        device=preds.device)
    raise ValueError(f"committee_uq_packed: no implementation for device "
                     f"{preds.device}")


def plain_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: Union[int, torch.Tensor] = 0,
                    kv_len=None, q_chunk: int = 1024) -> torch.Tensor:
    """The plain version on any device, by the reference's rule (its xla
    path): direct for short queries or decode (a ``q_offset`` tensor is a
    decode position), chunked over queries otherwise."""
    if q.shape[1] <= q_chunk or kv_len is not None or \
            isinstance(q_offset, torch.Tensor):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    return ref.attention_chunked_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, chunk=q_chunk)


def kv_seq_axes(rules, batch: int) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) a KV cache's sequence axis is split over
    under ``rules`` (a ``sharding.rules.MeshRules``): the ``CACHE_SEQ``
    rule's axes in the cache (BATCH, CACHE_SEQ, KV_HEADS, HEAD_DIM) once
    BATCH took its own (the batch's divisibility fallback applies).  ()
    when the cache is not split."""
    from repro_torch.configs import base as ax
    from repro_torch.sharding.rules import MeshRules, spec_axes

    mesh = rules.mesh
    probe = MeshRules(mesh, rules.rules)      # records nothing on ``rules``
    spec = probe.pspec((ax.BATCH, ax.CACHE_SEQ),
                       (batch, mesh.axes_size(mesh.axis_names)))
    return tuple(a for a in spec_axes(spec[1]) if mesh.shape[a] > 1)


def kv_seq_range(rules, batch: int, seq: int) -> Tuple[int, int]:
    """This rank's contiguous key range ``[start, stop)`` of a cache of
    ``seq`` keys under ``rules`` (``(0, seq)`` when it is not split)."""
    axes = kv_seq_axes(rules, batch)
    if not axes:
        return 0, seq
    n = rules.mesh.axes_size(axes)
    if seq % n:
        raise ValueError(f"a cache of {seq} keys does not split over "
                         f"{axes} ({n} ranks)")
    i = rules.mesh.axes_index(axes)
    return i * (seq // n), (i + 1) * (seq // n)


def _seq_sharded_attention(q, k, v, rules, axes, *, causal, window,
                           q_offset, kv_len) -> torch.Tensor:
    """Decode attention against a cache split over ``axes``: ``k`` and
    ``v`` are this rank's key range (``kv_seq_range``).  The rank computes
    the split path's fp32 partials over its range with the masks shifted
    to its start (the hand-written split kernel on the card,
    ``split_kv_partials`` on the CPU), the partials of every rank are
    all-gathered in rank order, and merged (``flash_combine`` /
    ``combine_partials``) — a distributed softmax, no gather of the cache.
    Every rank returns the whole output.  It runs eagerly and takes the
    decode position as a host int (the rank's shift of the masks is
    computed on the host), never as a device tensor."""
    if isinstance(q_offset, torch.Tensor):
        raise TypeError("the sequence-sharded decode takes q_offset as a "
                        "host int (it runs eagerly, not in a captured "
                        "graph)")
    mesh = rules.mesh
    B, T, H, D = q.shape
    S_loc, KV = k.shape[1], k.shape[2]
    start = mesh.axes_index(axes) * S_loc
    n = mesh.axes_size(axes)
    kvl = None if kv_len is None else \
        (kv_len.to(torch.int32) - start).clamp(min=0)
    qo = int(q_offset) - start
    if q.device.type == "cuda":
        part, splits = _fa.flash_partials(q, k, v, causal=causal,
                                          window=window, q_offset=qo,
                                          kv_len=kvl, device=q.device)
        parts, _ = mesh.all_gather(part, axes)
        return _fa.flash_combine(parts, ranks=n, splits=splits, B=B, T=T,
                                 H=H, KV=KV, D=D, dtype=q.dtype,
                                 device=q.device)
    if q.device.type != "cpu":
        raise ValueError(f"attention: no implementation for device "
                         f"{q.device}")
    part = _fa.pack_partials(*_fa.split_kv_partials(
        q, k, v, splits=1, keys_per_split=max(S_loc, 1), causal=causal,
        window=window, q_offset=qo, kv_len=kvl))
    parts, _ = mesh.all_gather(part, axes)
    m, l, acc = (torch.cat(x) for x in zip(*(
        _fa.unpack_partials(p, B, T, H, KV, D, 1)
        for p in parts.reshape(n, -1))))
    return _fa.combine_partials(m, l, acc, q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: Union[int, torch.Tensor] = 0,
              kv_len: Optional[torch.Tensor] = None,
              q_chunk: int = 1024, kv_seq_shard: bool = False,
              rules=None) -> torch.Tensor:
    """Multi-head attention, GQA-aware. q: (B,T,H,D); k,v: (B,S,KV,D);
    ``kv_len``: optional (B,) valid cache lengths (decode); ``q_offset``: a
    host int, or a decode position as an integer tensor on q's device that
    holds ``kv_len - T`` (see ``flash_attention.flash_attention``).

    ``kv_seq_shard`` with ``rules`` (a ``sharding.rules.MeshRules`` whose
    ``CACHE_SEQ`` maps to mesh axes of size > 1, ``kv_seq_axes``): the
    cache is split on its sequence axis over those axes and ``k``, ``v``
    are this rank's contiguous key range (``kv_seq_range``); ``q``,
    ``q_offset`` and ``kv_len`` are global.  The ranks merge their partial
    softmaxes (flash-decode style) instead of gathering the cache, and
    every rank returns the whole output; T * (H // KV) must fit the split
    kernel (decode).  Without ``rules``, or with a cache that the rules do
    not split, the flag changes nothing, as in the reference."""
    if kv_seq_shard and rules is not None:
        axes = kv_seq_axes(rules, q.shape[0])
        if axes:
            return _seq_sharded_attention(q, k, v, rules, axes,
                                          causal=causal, window=window,
                                          q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               q_chunk=q_chunk)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   device=q.device)
    raise ValueError(f"attention: no implementation for device {q.device}")


def _chunk(T: int, chunk: int) -> int:
    """The reference's rule for the chunked scans (wkv6, ssd): the chunk is
    cut to T, and must divide it."""
    chunk = min(chunk, T)
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    return chunk


def plain_wkv6(r, k, v, w, u, state=None, *, chunk: int = 64,
               state_out: Optional[torch.Tensor] = None):
    """The plain version on any device: ``ref.wkv6_chunked_ref``, its
    state copied into ``state_out`` when given."""
    y, s = ref.wkv6_chunked_ref(r, k, v, w, u, state,
                                chunk=_chunk(r.shape[1], chunk))
    if state_out is not None:
        state_out.copy_(s)
        s = state_out
    return y, s


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         chunk: int = 64, state_out: Optional[torch.Tensor] = None):
    """RWKV6 WKV.  r, k, v, w: (B, T, H, N); u: (H, N); state:
    (B, H, N, N) fp32 or None.  Returns (y, state); the state is written
    into ``state_out`` when given (which may be ``state`` itself).  Raises
    ``ValueError`` unless ``min(chunk, T)`` divides T."""
    if r.device.type == "cpu":
        return plain_wkv6(r, k, v, w, u, state, chunk=chunk,
                          state_out=state_out)
    if r.device.type == "cuda":
        return _wkv6.wkv6(r, k, v, w, u, state,
                          chunk=_chunk(r.shape[1], chunk),
                          state_out=state_out, device=r.device)
    raise ValueError(f"wkv6: no implementation for device {r.device}")


def wkv6_decode(r, k, v, w, u, state):
    """One recurrent step (r, k, v, w: (B, H, N)): plain PyTorch on every
    device, as the reference's is plain jnp."""
    return ref.wkv6_decode_ref(r, k, v, w, u, state)


def plain_ssd(x, a, Bm, Cm, state=None, *, chunk: int = 64,
              state_out: Optional[torch.Tensor] = None):
    """The plain version on any device: ``ref.ssd_chunked_ref``, its state
    copied into ``state_out`` when given."""
    y, s = ref.ssd_chunked_ref(x, a, Bm, Cm, state,
                               chunk=_chunk(x.shape[1], chunk))
    if state_out is not None:
        state_out.copy_(s)
        s = state_out
    return y, s


def ssd(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        state: Optional[torch.Tensor] = None, *, chunk: int = 64,
        state_out: Optional[torch.Tensor] = None):
    """Mamba-2/SSD chunked scan.  x: (B, T, H, P); a: (B, T, H); Bm, Cm:
    (B, T, H, N) (the kernel reads them through their strides, so a
    broadcast ``expand`` costs nothing); state: (B, H, N, P) fp32 or None.
    Returns (y, state); the state is written into ``state_out`` when given
    (which may be ``state`` itself).  Raises ``ValueError`` unless
    ``min(chunk, T)`` divides T."""
    if x.device.type == "cpu":
        return plain_ssd(x, a, Bm, Cm, state, chunk=chunk,
                         state_out=state_out)
    if x.device.type == "cuda":
        return _ssd.ssd(x, a, Bm, Cm, state,
                        chunk=_chunk(x.shape[1], chunk),
                        state_out=state_out, device=x.device)
    raise ValueError(f"ssd: no implementation for device {x.device}")


def ssd_decode(x, a, Bm, Cm, state):
    """One recurrent step (x: (B, H, P), a: (B, H), Bm, Cm: (B, H, N)):
    plain PyTorch on every device, as the reference's is plain jnp."""
    return ref.ssd_decode_ref(x, a, Bm, Cm, state)
