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


def packed_uq_nbytes(n: int, d: int) -> int:
    """Bytes of the packed statistics of ``n`` rows of width ``d``."""
    return n * (d + 3) * 4 + n


def packed_uq_views(buf, n: int, d: int):
    """``(mean (n, d), scalar_std (n,), component_std (n,), finite (n,),
    mask (n,))``: views into a packed buffer, a 1-D uint8 tensor or numpy
    array of ``packed_uq_nbytes(n, d)`` bytes.  The layout is mean (f32),
    scalar std (f32), component std (f32), finite (i32), mask (bool)."""
    if isinstance(buf, torch.Tensor):
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
    else:
        f32, i32, b8 = np.float32, np.int32, np.bool_
    nd = n * d
    f = buf[:(nd + 2 * n) * 4].view(f32)
    return (f[:nd].reshape(n, d), f[nd:nd + n], f[nd + n:],
            buf[(nd + 2 * n) * 4:(nd + 3 * n) * 4].view(i32),
            buf[(nd + 3 * n) * 4:].view(b8))


def committee_uq_packed_ref(preds: torch.Tensor, threshold: float,
                            n_valid: torch.Tensor,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The acquisition engine's packed statistics: ``committee_uq_ref``
    and mask = row < n_valid & finite > 0 & scalar_std > fp32(threshold),
    in one uint8 buffer laid out as ``packed_uq_views`` reads it.
    ``n_valid`` is a 0-d (or one-element) integer tensor, never read on the
    host; ``out``, when given, is written and returned (1-D uint8 of
    ``packed_uq_nbytes(n, d)`` bytes on the device of ``preds``)."""
    mean, sstd, cstd, mask, cnt = committee_uq_ref(preds, threshold)
    n, d = mean.shape
    rows = torch.arange(n, device=preds.device)
    mask = mask & (rows < n_valid.reshape(()))
    nbytes = packed_uq_nbytes(n, d)
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=preds.device)
    elif (out.device != preds.device or out.dtype != torch.uint8
          or out.dim() != 1 or out.numel() != nbytes):
        raise ValueError(f"committee_uq_packed: out must be a 1-D uint8 "
                         f"buffer of {nbytes} bytes on {preds.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    for dst, src in zip(packed_uq_views(out, n, d),
                        (mean, sstd, cstd, cnt, mask)):
        dst.copy_(src)
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _f32_sqrt(d: int) -> float:
    """sqrt(d) rounded to fp32, as ``jnp.sqrt(D)`` gives it."""
    return float(np.sqrt(np.float32(d)))


def _mask(q_len: int, kv_len: int, q_offset, causal: bool,
          window: Optional[int], device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask. q position i sits at q_offset + i.
    ``q_offset``: a host int, a 0-dim tensor, or a (B,) tensor of per-batch
    offsets, which gives a (B, q_len, kv_len) mask."""
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        q_offset = q_offset.to(device)[:, None, None]
    qpos = q_offset + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)
    m = torch.ones(qpos.shape[:-1] + (kv_len,), dtype=torch.bool,
                   device=device)
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
    cache lengths (decode); ``q_offset``: a host int, or an integer tensor
    on q's device, 0-dim or (B,) per batch row (a decode position kept on
    the device).  Fully masked rows give 0.  Output in ``v.dtype``, as the
    reference's ``attention_ref``."""
    B, T, H, D = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    qf = q.reshape(B, T, KV, G, D).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, kf) / _f32_sqrt(D)
    m = _mask(T, S, q_offset, causal, window, q.device)
    m = m[:, None, None] if m.dim() == 3 else m[None, None, None]
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


# ---------------------------------------------------------------------------
# RWKV6 (Finch) WKV — vector decay per key channel
# ---------------------------------------------------------------------------


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None):
    """Sequential-scan oracle.  r, k, v, w: (B, T, H, N), w the decay in
    (0, 1) per key channel; u: (H, N) bonus; state: (B, H, N, N) fp32.

    y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y (B, T, H, N) in ``v.dtype``, state_out (B, H, N, N) fp32)."""
    B, T, H, N = r.shape
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    uf = u.to(torch.float32)
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = kt[..., :, None] * vt[..., None, :]            # (B, H, N, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt,
                               S + uf[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=1).to(v.dtype), S


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None, chunk: int = 64):
    """Chunked (linear-attention) form of ``wkv6_ref``: the plain version
    of the ``wkv6`` kernel, line for line the reference's.  Intra-chunk
    decay ratios are exp of log-space differences clipped to [-60, 0]
    (the factorized exp(excl) * exp(-incl) form overflows under strong
    decay); inter-chunk terms and the state update are matmuls."""
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    C = chunk
    rf, kf, vf = (x.to(torch.float32) for x in (r, k, v))
    lw = torch.log(w.to(torch.float32).clamp_min(1e-12))   # (B,T,H,N) <= 0
    uf = u.to(torch.float32)
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    nC = T // C

    def resh(x):                                         # (nC, B, H, C, N)
        return x.reshape(B, nC, C, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = resh(rf), resh(kf), resh(vf), resh(lw)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    ys = []
    for i in range(nC):
        rt, kt, vt, lwt = rc[i], kc[i], vc[i], lwc[i]     # (B, H, C, N)
        incl = torch.cumsum(lwt, dim=2)                   # log prod_{1..t}
        excl = incl - lwt                                 # log prod_{1..t-1}
        total = incl[:, :, -1:, :]                        # log prod over chunk
        # inter-chunk: y_t += (r_t * exp(excl_t)) @ S
        y = torch.einsum("bhcn,bhnm->bhcm", rt * torch.exp(excl), S)
        # intra-chunk: A[t,j] = sum_n r[t]k[j] exp(excl_t - incl_j), j < t
        dec = torch.exp(torch.clamp(
            excl[:, :, :, None, :] - incl[:, :, None, :, :], -60.0, 0.0))
        A = torch.einsum("bhtn,bhjn,bhtjn->bhtj", rt, kt, dec)
        A = torch.where(mask[None, None], A, 0.0)
        # diagonal bonus u
        diag = torch.einsum("bhtn,bhtn->bht", rt * uf[None, :, None, :], kt)
        y = y + torch.einsum("bhtj,bhjm->bhtm", A, vt) + diag[..., None] * vt
        # S' = diag(prod w) S + sum_j (prod_{j+1..C} w * k_j) v_j^T
        k_dec = kt * torch.exp(torch.clamp(total - incl, -60.0, 0.0))
        S = torch.exp(total[:, :, 0, :])[..., None] * S + torch.einsum(
            "bhjn,bhjm->bhnm", k_dec, vt)
        ys.append(y)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(B, T, H, N)
    return y.to(v.dtype), S


def wkv6_decode_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Single-token recurrent step.  r, k, v, w: (B, H, N); state
    (B, H, N, N) fp32.  Returns (y (B, H, N) in ``v.dtype``, new state)."""
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    uf = u.to(torch.float32)
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rf, state + uf[None, :, :, None] * kv)
    state = wf[..., :, None] * state + kv
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# SSD scan (Mamba-2 form) — scalar decay per head
# ---------------------------------------------------------------------------


def ssd_ref(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Sequential-scan oracle.  x: (B, T, H, P) dt-scaled values; a:
    (B, T, H) decay in (0, 1]; Bm, Cm: (B, T, H, N); state: (B, H, N, P)
    fp32.

    S_t = a_t S_{t-1} + B_t^T x_t;  y_t = C_t S_t
    Returns (y (B, T, H, P) in ``x.dtype``, state_out (B, H, N, P) fp32)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    xf, af, bf, cf = (z.to(torch.float32) for z in (x, a, Bm, Cm))
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if state is None else state.to(torch.float32))
    ys = []
    for t in range(T):
        S = af[:, t, :, None, None] * S + \
            bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], S))
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_chunked_ref(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, state: Optional[torch.Tensor] = None,
                    chunk: int = 64):
    """Chunked SSD (Mamba-2): the plain version of the ``ssd`` kernel, line
    for line the reference's.  Per chunk of C rows, with la = log(max(a,
    1e-12)), incl = cumsum(la) and total = incl[C-1]:
      y = exp(incl) * (C @ S) + (mask(C B^T) * exp(clip(incl_t - incl_j,
          -60, 0))) @ x,
      S' = exp(total) * S + (B * exp(clip(total - incl, -60, 0)))^T @ x.
    Decay ratios are bounded by 1, so the form is numerically benign.
    Raises ``ValueError`` unless ``chunk`` divides T."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    C = chunk
    xf, bf, cf = (z.to(torch.float32) for z in (x, Bm, Cm))
    la = torch.log(a.to(torch.float32).clamp_min(1e-12))    # (B, T, H)
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if state is None else state.to(torch.float32))
    nC = T // C

    def resh(z):                                       # (nC, B, H, C, *)
        return z.reshape(B, nC, C, H, -1).permute(1, 0, 3, 2, 4)

    xc, bc, cc = resh(xf), resh(bf), resh(cf)
    lac = la.reshape(B, nC, C, H).permute(1, 0, 3, 2)  # (nC, B, H, C)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(nC):
        xt, bt, ct = xc[i], bc[i], cc[i]
        incl = torch.cumsum(lac[i], dim=-1)            # log prod_{1..t}
        total = incl[..., -1:]
        # inter-chunk: y_t = exp(incl_t) * C_t @ S  (S from before the chunk)
        y = torch.exp(incl)[..., None] * torch.einsum("bhcn,bhnp->bhcp",
                                                      ct, S)
        # intra-chunk: A[t, j] = (C_t . B_j) exp(incl_t - incl_j), j <= t
        ratio = torch.exp(torch.clamp(incl[..., :, None] - incl[..., None, :],
                                      -60.0, 0.0))
        A = torch.einsum("bhtn,bhjn->bhtj", ct, bt) * ratio
        A = torch.where(mask[None, None], A, 0.0)
        y = y + torch.einsum("bhtj,bhjp->bhtp", A, xt)
        # state update
        b_dec = bt * torch.exp(torch.clamp(total - incl, -60.0, 0.0))[..., None]
        S = torch.exp(total[..., 0])[..., None, None] * S + torch.einsum(
            "bhjn,bhjp->bhnp", b_dec, xt)
        ys.append(y)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(B, T, H, P)
    return y.to(x.dtype), S


def ssd_decode_ref(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, state: torch.Tensor):
    """Single-token step.  x: (B, H, P); a: (B, H); Bm, Cm: (B, H, N);
    state (B, H, N, P) fp32.  Returns (y (B, H, P) in ``x.dtype``, new
    state)."""
    xf, af, bf, cf = (z.to(torch.float32) for z in (x, a, Bm, Cm))
    state = af[..., None, None] * state + bf[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", cf, state)
    return y.to(x.dtype), state
