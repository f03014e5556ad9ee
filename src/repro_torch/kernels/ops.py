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
            "with the multi-device slice (ROADMAP §A item 8)")
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               q_chunk=q_chunk)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   device=q.device)
    raise ValueError(f"attention: no implementation for device {q.device}")
