"""Plain PyTorch versions of the port's kernels.

Each function states the semantics its CUDA kernel must reproduce; the CPU
path of ``ops`` runs them, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.
"""
from __future__ import annotations

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
