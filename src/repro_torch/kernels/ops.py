"""Public kernel entry points.  The implementation follows the input's
device: a CPU tensor runs the plain PyTorch version (``ref``), a CUDA tensor
runs the hand-written kernel — or the call raises.  There is no fallback
from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import committee_uq as _cuq
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
