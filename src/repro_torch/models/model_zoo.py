"""Model zoo: the uniform build / loss / serve API of
``repro/models/model_zoo.py``.

``build_model(cfg)`` dispatches on ``cfg.family`` over all six families
(dense, moe, rwkv6, hybrid, encdec, vlm); ``make_loss_fn`` builds the
training loss with the MoE load-balance term; ``make_prefill_fn`` passes
the encoder-decoder's frame embeddings and the vision LM's patch
embeddings through to the prefill.  ``input_specs`` and
``decode_input_specs`` are the planners' stand-ins (``launch/dryrun.py``):
``meta`` tensors of the reference's keys, shapes and dtypes, nothing
allocated.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import common as cm
from repro_torch.models import internvl
from repro_torch.models import jamba
from repro_torch.models import moe
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper


def build_model(cfg: ModelConfig, *, impl: str = "auto",
                max_seq: int = 4096):
    """The LM object of ``cfg.family``; ``impl`` as ``DenseLM.impl``.
    ``max_seq`` sizes the encoder-decoder's learned decoder positions (the
    other families ignore it, as in the reference)."""
    if cfg.family == "dense":
        return tfm.DenseLM(cfg, impl=impl)
    if cfg.family == "moe":
        return moe.MoELM(cfg, impl=impl)
    if cfg.family == "rwkv6":
        return rwkv6.RWKV6LM(cfg, impl=impl)
    if cfg.family == "hybrid":
        return jamba.JambaLM(cfg, impl=impl)
    if cfg.family == "encdec":
        return whisper.WhisperLM(cfg, impl=impl, max_seq=max_seq)
    if cfg.family == "vlm":
        return internvl.InternVLM(cfg, impl=impl)
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training / prefill batch stand-ins for one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if cfg.family == "encdec":
        return {
            "tokens": _sds((B, S), tok),
            "labels": _sds((B, S), tok),
            "enc_embeds": _sds((B, cfg.encoder_seq, cfg.d_model),
                               torch.bfloat16),
        }
    if cfg.family == "vlm":
        t_text = S - cfg.vision_tokens
        return {
            "tokens": _sds((B, t_text), tok),
            "labels": _sds((B, t_text), tok),
            "patch_embeds": _sds((B, cfg.vision_tokens, cfg.d_model),
                                 torch.bfloat16),
        }
    return {"tokens": _sds((B, S), tok), "labels": _sds((B, S), tok)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       model) -> Dict[str, Any]:
    """serve_step stand-ins: one new token against a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _sds((B, 1), torch.int32),
        "cache": cm.abstract_params(model.cache_specs(B, S)),
        "index": _sds((), torch.int32),
    }


# ---------------------------------------------------------------------------
# Loss builders
# ---------------------------------------------------------------------------


def make_loss_fn(model, z_loss_coef: float = 0.0):
    """``loss_fn(params, batch) -> (loss, metrics)``: ``tfm.lm_loss`` on
    ``batch["labels"]``, plus the MoE load-balance term for the moe family
    and the hybrid family with experts (``metrics["moe_aux"]``)."""
    cfg = model.cfg
    has_aux = cfg.family in ("moe", "hybrid") and cfg.moe_num_experts > 0

    def loss_fn(params, batch):
        if has_aux:
            logits, aux = model.forward(params, batch, return_aux=True)
        else:
            logits, aux = model.forward(params, batch), 0.0
        loss, metrics = tfm.lm_loss(logits, batch["labels"],
                                    z_loss_coef=z_loss_coef)
        loss = loss + aux
        if has_aux:
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Serve-step builders
# ---------------------------------------------------------------------------


def make_prefill_fn(model):
    cfg = model.cfg

    def prefill_fn(params, batch, cache):
        if cfg.family == "encdec":
            return model.prefill(params, batch["tokens"], cache,
                                 enc_embeds=batch["enc_embeds"])
        if cfg.family == "vlm":
            return model.prefill(params, batch["tokens"], cache,
                                 patch_embeds=batch["patch_embeds"])
        return model.prefill(params, batch["tokens"], cache)

    return prefill_fn


def make_decode_fn(model, kv_seq_shard: bool = False):
    def decode_fn(params, tokens, cache, index):
        return model.decode_step(params, tokens, cache, index,
                                 kv_seq_shard=kv_seq_shard)

    return decode_fn


def count_params(cfg: ModelConfig, max_seq: int = 4096) -> int:
    """Parameters of ``cfg`` from its specs (no allocation); the
    encoder-decoder's ``dec_pos`` counted at ``max_seq`` rows."""
    model = build_model(cfg, max_seq=max_seq)
    return cm.count_params(model.param_specs())


def active_param_ratio(cfg: ModelConfig) -> float:
    """Fraction of MoE expert params active per token (for MODEL_FLOPS)."""
    if not cfg.moe_num_experts:
        return 1.0
    return cfg.moe_top_k / cfg.moe_num_experts
