"""Plain PyTorch versions of the port's kernels.

Each function states the semantics its CUDA kernel must reproduce; the CPU
path of ``ops`` runs them, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def committee_uq_ref(preds: torch.Tensor, threshold: float):
    """Committee mean / ddof=1 std statistics / threshold mask.

    preds: (K, n, d).  Returns (mean (n, d) fp32, scalar_std (n,) fp32,
    component_std (n,) fp32, mask (n,) bool, finite (n,) int32).
    scalar_std is the max over output components of the per-component
    ddof=1 std — the quantity the paper's prediction_check thresholds;
    component_std is the mean over components of the same std.

    Member quarantine (degraded-K statistics): a member's row is excluded
    from the statistics when ANY of its d output components is non-finite.
    ``finite`` reports the per-row count of members that participated; with
    fewer than 2 finite members the std is 0 and with 0 finite members the
    mask is forced off.  Two-pass masked mean and variance, line for line
    the reference's ``repro/kernels/ref.committee_uq_ref``.
    """
    p = preds.to(torch.float32)
    fin = torch.isfinite(p).all(dim=-1)                    # (K, n)
    cnt = fin.sum(dim=0, dtype=torch.int32)                # (n,)
    finw = fin[..., None]                                  # (K, n, 1)
    safe_cnt = cnt.clamp_min(1).to(torch.float32)[:, None]
    mean = torch.where(finw, p, 0.0).sum(dim=0) / safe_cnt
    dev = torch.where(finw, p - mean, 0.0)
    var = (dev * dev).sum(dim=0) / (cnt - 1).clamp_min(1).to(
        torch.float32)[:, None]
    std = torch.sqrt(torch.where((cnt >= 2)[:, None], var, 0.0))
    scalar_std = std.amax(dim=-1)
    component_std = std.mean(dim=-1)
    # compare against the fp32-rounded threshold, as the reference does
    mask = (scalar_std > float(np.float32(threshold))) & (cnt > 0)
    return mean, scalar_std, component_std, mask, cnt


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _f32_sqrt(d: int) -> float:
    """sqrt(d) rounded to fp32, as ``jnp.sqrt(D)`` gives it."""
    return float(np.sqrt(np.float32(d)))


def _mask(q_len: int, kv_len: int, q_offset, causal: bool,
          window: Optional[int], device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask. q position i sits at q_offset + i."""
    qpos = q_offset + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset=0, kv_len=None) -> torch.Tensor:
    """Naive full-materialization attention; fp32 softmax; GQA-aware.

    q: (B, T, H, D); k, v: (B, S, KV, D); ``kv_len``: optional (B,) valid
    cache lengths (decode).  Fully masked rows give 0.  Output in
    ``v.dtype``, as the reference's ``attention_ref``."""
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    qf = q.reshape(B, T, KV, G, D).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, kf) / _f32_sqrt(D)
    m = _mask(T, S, q_offset, causal, window, q.device)[None, None, None]
    if kv_len is not None:
        valid = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
        m = m & valid[:, None, None, None, :]
    scores = torch.where(m, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)   # fully-masked rows
    out = torch.einsum("bkgts,bskd->btkgd", p, vf)
    return out.reshape(B, T, H, D).to(v.dtype)


def attention_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset=0,
                          chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over q chunks; the same math as
    ``attention_ref`` with bounded memory.  As in the reference, the
    probabilities are cast to ``v.dtype`` before the AV product."""
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    outs = []
    for start in range(0, T, chunk):
        qc = q[:, start:start + chunk].to(torch.float32)
        L = qc.shape[1]
        qc = qc.reshape(B, L, KV, G, D)
        # bound the kv range this q chunk touches (causal: no future keys)
        kv_hi = min(S, q_offset + start + L) if causal else S
        kv_lo = 0
        if window is not None:
            kv_lo = max(0, q_offset + start - window + 1)
        kc = kf[:, kv_lo:kv_hi]
        vc = vf[:, kv_lo:kv_hi]
        scores = torch.einsum("blkgd,bskd->bkgls", qc, kc) * scale
        qpos = q_offset + start + torch.arange(L, device=q.device)[:, None]
        kpos = kv_lo + torch.arange(kv_hi - kv_lo, device=q.device)[None, :]
        m = torch.ones((L, kv_hi - kv_lo), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        scores = torch.where(m[None, None, None], scores, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)
        # the reference reads the probabilities in v.dtype for the AV product
        oc = torch.einsum("bkgls,bskd->blkgd",
                          p.to(v.dtype).to(torch.float32), vc)
        outs.append(oc.reshape(B, L, H, D))
    return torch.cat(outs, dim=1).to(v.dtype)
