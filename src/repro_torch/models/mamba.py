"""Mamba mixer in the SSD-chunked form, ported from ``repro/models/mamba.py``.

The reference's structure: in_proj -> (x, z), a causal depthwise conv,
silu, data-dependent (dt, B, C), the SSD scan (``ops.ssd``: the
hand-written CUDA kernel on the card, its plain version on the CPU; a
decode step runs the plain ``ops.ssd_decode`` on both), the D skip, silu(z)
gating, an rms norm and out_proj.  Parameters keep the reference's keys and
``(in, out)`` layout.

Dtypes follow the reference: ``A_log``, ``dt_bias``, ``ln`` and ``norm_w``
are read in fp32, and dt and the decay a = exp(dt * -exp(A_log)) are fp32;
every other weight is cast to the activation dtype at its product.  The
prefill hands the scan a rounded to the activation dtype (as the reference
does), the decode step hands it a in fp32; the scan's input is the
product xh * dt in the activation dtype.  The conv is the reference's K
shifted adds accumulated in the activation dtype (a grouped convolution
would accumulate in fp32 and round differently).

B and C are one (B, T, N) projection each, broadcast across the H heads by
``expand`` (stride 0), which the kernel reads as it is.

Decode state, updated IN PLACE in the caller's cache views: the conv tail
(B, d_conv - 1, d_inner) in the activation dtype and the SSD state
(B, H, N, P) fp32.  A prefill's scan writes its new state straight into
the state view it reads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import base as ax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec

Params = Dict[str, Any]
_proj = tfm._proj


def mamba_specs(cfg: ModelConfig) -> Params:
    D = cfg.d_model
    Di = cfg.mamba_d_inner
    N = cfg.mamba_d_state
    Kc = cfg.mamba_d_conv
    H = cfg.mamba_num_heads
    return {
        "ln": ParamSpec((D,), (ax.EMBED,), init="ones"),
        "in_proj": ParamSpec((D, 2 * Di), (ax.EMBED, ax.MLP)),
        "conv_w": ParamSpec((Kc, Di), (ax.CONV, ax.MLP), scale=0.5),
        "conv_b": ParamSpec((Di,), (ax.MLP,), init="zeros"),
        "w_dt": ParamSpec((Di, H), (ax.MLP, ax.HEADS), scale=0.1),
        "dt_bias": ParamSpec((H,), (ax.HEADS,), init="uniform", scale=1.0),
        "A_log": ParamSpec((H,), (ax.HEADS,), init="uniform", scale=1.0),
        "w_B": ParamSpec((Di, N), (ax.MLP, ax.STATE), scale=0.5),
        "w_C": ParamSpec((Di, N), (ax.MLP, ax.STATE), scale=0.5),
        "D_skip": ParamSpec((H,), (ax.HEADS,), init="ones"),
        "norm_w": ParamSpec((Di,), (ax.MLP,), init="ones"),
        "out_proj": ParamSpec((Di, D), (ax.MLP, ax.EMBED)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, T, Di); w: (K, Di).  Returns (y,
    new_tail); ``tail`` is the last K-1 inputs of the previous segment.
    K shifted adds accumulated in x's dtype, as the reference's."""
    B, T, Di = x.shape
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, Di), dtype=x.dtype, device=x.device)
    ext = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, T+K-1, Di)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + ext[:, i:i + T, :] * w[i].to(x.dtype)
    return y + b.to(x.dtype), ext[:, -(K - 1):, :]


def _scan(impl: str, *args, **kw):
    if impl == "plain":
        return ops.plain_ssd(*args, **kw)
    return ops.ssd(*args, **kw)


def mamba_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                states: Optional[Dict[str, torch.Tensor]] = None,
                impl: str = "auto", chunk: int = 64) -> torch.Tensor:
    """x: (B, T, D) -> out (B, T, D).  ``states``: None (no cache) or one
    layer's cache views {"conv": (B, K-1, Di), "ssd": (B, H, N, P) fp32},
    updated in place."""
    B, T, D = x.shape
    Di, N = cfg.mamba_d_inner, cfg.mamba_d_state
    H, P = cfg.mamba_num_heads, cfg.mamba_head_dim

    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = _proj(h, p["in_proj"])
    xin, z = xz[..., :Di], xz[..., Di:]

    conv_tail = states["conv"] if states else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_tail)
    xc = F.silu(xc)

    dtp = _proj(xc, p["w_dt"]).to(torch.float32) + \
        p["dt_bias"].to(torch.float32)
    dt = torch.logaddexp(dtp, torch.zeros((), device=dtp.device))  # softplus
    A = -torch.exp(p["A_log"].to(torch.float32))           # (H,) negative
    a = torch.exp(dt * A[None, None, :])                   # (B, T, H) in (0, 1)

    Bm4 = _proj(xc, p["w_B"])[:, :, None, :].expand(B, T, H, N)
    Cm4 = _proj(xc, p["w_C"])[:, :, None, :].expand(B, T, H, N)

    xh = xc.reshape(B, T, H, P)
    vals = xh * dt.to(xh.dtype)[..., None]                # dt-discretized input

    ssd_state = states["ssd"] if states else None
    if T == 1 and ssd_state is not None:
        y4, new_ssd = ops.ssd_decode(vals[:, 0], a[:, 0], Bm4[:, 0],
                                     Cm4[:, 0], ssd_state)
        y4 = y4[:, None]
    else:
        y4, new_ssd = _scan(impl, vals, a.to(vals.dtype), Bm4, Cm4,
                            ssd_state, chunk=min(chunk, T),
                            state_out=ssd_state)
    y4 = y4 + p["D_skip"].to(y4.dtype)[None, None, :, None] * xh
    y = y4.reshape(B, T, Di)
    y = y * F.silu(z)
    y = cm.rms_norm(y, p["norm_w"], cfg.norm_eps)
    out = _proj(y, p["out_proj"])

    if states:
        if new_ssd is not ssd_state:
            ssd_state.copy_(new_ssd)
        states["conv"].copy_(new_conv)
    return out


def mamba_state_specs(cfg: ModelConfig, batch: int) -> Params:
    Di, N = cfg.mamba_d_inner, cfg.mamba_d_state
    H, P = cfg.mamba_num_heads, cfg.mamba_head_dim
    Kc = cfg.mamba_d_conv
    return {
        "conv": ParamSpec((batch, Kc - 1, Di), (ax.BATCH, None, ax.MLP),
                          init="zeros", dtype=cm.torch_dtype(cfg.dtype)),
        "ssd": ParamSpec((batch, H, N, P),
                         (ax.BATCH, ax.HEADS, ax.STATE, None),
                         init="zeros", dtype=torch.float32),
    }
