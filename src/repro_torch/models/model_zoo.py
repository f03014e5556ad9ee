"""Model zoo: the uniform build / serve API of ``repro/models/model_zoo.py``.

``build_model(cfg)`` dispatches on ``cfg.family``.  The port builds the
dense, rwkv6 and hybrid (Jamba) families so far; every other family raises
``NotImplementedError`` naming the ROADMAP item (§A) it waits for.  The
reference's dry-run stand-ins (``input_specs`` / ``decode_input_specs``)
wait for the planners item, and its ``make_loss_fn`` for the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import jamba
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm

_WAITING = {
    "moe": "the rest of the LM zoo (ROADMAP §A item 9: MoELM of "
           "models/moe.py, whose moe_ffn is ported; its attention runs the "
           "ported flash_attention kernel)",
    "encdec": "the rest of the LM zoo (ROADMAP §A item 9: "
              "models/whisper.py; its attention runs the ported "
              "flash_attention kernel)",
    "vlm": "the rest of the LM zoo (ROADMAP §A item 9: models/internvl.py; "
           "its attention runs the ported flash_attention kernel)",
}


def build_model(cfg: ModelConfig, *, impl: str = "auto",
                max_seq: int = 4096):
    """The LM object of ``cfg.family``; ``impl`` as ``DenseLM.impl``.
    ``max_seq`` is accepted for the reference's signature (only the
    encoder-decoder family uses it there)."""
    if cfg.family == "dense":
        return tfm.DenseLM(cfg, impl=impl)
    if cfg.family == "rwkv6":
        return rwkv6.RWKV6LM(cfg, impl=impl)
    if cfg.family == "hybrid":
        return jamba.JambaLM(cfg, impl=impl)
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; it waits "
            f"for {_WAITING[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Serve-step builders
# ---------------------------------------------------------------------------


def make_prefill_fn(model):
    def prefill_fn(params, batch, cache):
        return model.prefill(params, batch["tokens"], cache)

    return prefill_fn


def make_decode_fn(model, kv_seq_shard: bool = False):
    def decode_fn(params, tokens, cache, index):
        return model.decode_step(params, tokens, cache, index,
                                 kv_seq_shard=kv_seq_shard)

    return decode_fn


def count_params(cfg: ModelConfig, max_seq: int = 4096) -> int:
    model = build_model(cfg, max_seq=max_seq)
    return cm.count_params(model.param_specs())


def active_param_ratio(cfg: ModelConfig) -> float:
    """Fraction of MoE expert params active per token (for MODEL_FLOPS)."""
    if not cfg.moe_num_experts:
        return 1.0
    return cfg.moe_top_k / cfg.moe_num_experts
