"""Public kernel entry points.  The implementation follows the input's
device: a CPU tensor runs the plain PyTorch version (``ref``), a CUDA tensor
runs the hand-written kernel — or the call raises.  There is no fallback
from the kernel to the plain version."""
from __future__ import annotations

from typing import Optional

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
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len=None, q_chunk: int = 1024) -> torch.Tensor:
    """The plain version on any device, by the reference's rule (its xla
    path): direct for short queries or decode, chunked over queries
    otherwise."""
    if q.shape[1] <= q_chunk or kv_len is not None:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    return ref.attention_chunked_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, chunk=q_chunk)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
              q_chunk: int = 1024, kv_seq_shard: bool = False
              ) -> torch.Tensor:
    """Multi-head attention, GQA-aware. q: (B,T,H,D); k,v: (B,S,KV,D);
    ``kv_len``: optional (B,) valid cache lengths (decode).

    ``kv_seq_shard`` (a cache sharded on its sequence axis, the reference's
    long-context decode hint) needs the multi-device slice and raises."""
    if kv_seq_shard:
        raise NotImplementedError(
            "attention(kv_seq_shard=True): a sequence-sharded KV cache comes "
            "with the multi-device slice (ROADMAP §A: multi-device)")
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
