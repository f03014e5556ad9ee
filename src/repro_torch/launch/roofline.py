"""Roofline analysis: the analytic half of the reference's
``repro/launch/roofline.py``, for one NVIDIA H100.

``analytic_model_flops(cfg, shape)`` is the useful work of one step (6 x
active params x tokens for training plus the attention's score and value
products, 2 x for a prefill, one token against the cache for decode); a
training run's MFU is that over (step seconds x ``PEAK_FLOPS``).  The
counts walk the port's ``param_specs`` (shapes only, nothing allocated).

The other half, the probe-corrected compiled totals of every (arch x shape
x mesh) cell, lowers under the production mesh: ``roofline_cell`` and
``main`` wait for the planners (ROADMAP §A: planners).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import common as cm

# NVIDIA H100 80GB HBM3 (SXM, 700 W), published dense peaks
PEAK_FLOPS = 989e12            # bf16 tensor cores, FLOP/s
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12               # HBM3, B/s
HBM_BYTES = 80 * 10**9         # NVIDIA H100 80GB HBM3, as sold


def hbm_bytes() -> int:
    """The card's memory: ``torch.cuda.get_device_properties`` when a card
    is present, else ``HBM_BYTES``."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def _active_params(cfg: ModelConfig) -> float:
    """Non-embedding params active per token (MoE: top_k of routed)."""
    from repro_torch.models import model_zoo

    specs = model_zoo.build_model(cfg, max_seq=128).param_specs()
    total_active = 0.0

    def walk(tree, path):
        nonlocal total_active
        if cm.is_spec(tree):
            n = float(np.prod(tree.shape))
            p = "/".join(path)
            if "embedding" in p or "dec_pos" in p:
                return                      # embedding gather ~ free
            if ("/moe/" in p or p.startswith("moe/")) and (
                    "/wi" in p or "/wg" in p or "/wo" in p) and \
                    "shared" not in p:
                n *= cfg.moe_top_k / max(cfg.moe_num_experts, 1)
            total_active += n
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + [k])

    walk(specs, [])
    if cfg.tie_embeddings:
        total_active += cfg.padded_vocab * cfg.d_model  # logits matmul
    return total_active


def _attn_flops_fwd(cfg: ModelConfig, B: int, S: int, decode: bool) -> float:
    """Score+value matmul flops (fwd), summed over attention layers.

    decode=True means ONE new token against an S-token cache/state: token
    count is 1, not S (state-recurrence archs advance the state once).
    """
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    n_tok = 1 if decode else S
    if cfg.family == "rwkv6":
        # chunked linear attention: ~4*H*N^2 per token
        N = cfg.rwkv_head_dim
        return 4.0 * B * n_tok * cfg.rwkv_num_heads * N * N * cfg.num_layers
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.is_attention_layer(i))
    ssd_fl = 0.0
    if cfg.family == "hybrid":
        n_mamba = cfg.num_layers - n_attn
        N, P = cfg.mamba_d_state, cfg.mamba_head_dim
        Hm = cfg.mamba_num_heads
        ssd_fl = 4.0 * B * n_tok * Hm * N * P * n_mamba
    if decode:
        per = 4.0 * B * S * H * hd                  # 1 token reads S cache
    else:
        kv_span = min(cfg.sliding_window or S, S)
        per = 4.0 * B * S * kv_span * H * hd * (0.5 if kv_span == S else 1.0)
    fl = per * n_attn + ssd_fl
    if cfg.family == "encdec":
        cross = 4.0 * B * n_tok * cfg.encoder_seq * H * hd * cfg.num_layers
        fl += cross
        if not decode:  # the encoder runs once per train/prefill step only
            fl += 4.0 * B * cfg.encoder_seq ** 2 * H * hd * cfg.encoder_layers
    return fl


def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful flops for one step of this cell."""
    B = shape.global_batch
    if shape.kind == "train":
        tokens = B * shape.seq_len
        return (6.0 * _active_params(cfg) * tokens
                + 3.0 * _attn_flops_fwd(cfg, B, shape.seq_len, False))
    if shape.kind == "prefill":
        tokens = B * shape.seq_len
        return (2.0 * _active_params(cfg) * tokens
                + _attn_flops_fwd(cfg, B, shape.seq_len, False))
    # decode: one token against a seq_len cache
    return (2.0 * _active_params(cfg) * B
            + _attn_flops_fwd(cfg, B, shape.seq_len, True))


# ---------------------------------------------------------------------------
# Probe-corrected compiled totals: the planners
# ---------------------------------------------------------------------------


def roofline_cell(arch: str, shape_name: str, **kw):
    raise NotImplementedError(
        "roofline_cell lowers every cell under the production mesh and "
        "comes with the planners (ROADMAP §A: planners)")


def main(argv=None):
    raise NotImplementedError(
        "the roofline sweep comes with the planners (ROADMAP §A: planners); "
        "analytic_model_flops is ported")


if __name__ == "__main__":
    main()
