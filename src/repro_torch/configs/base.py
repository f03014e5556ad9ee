"""Configuration dataclasses for the repro framework.

A copy of the reference's pure dataclasses (``repro/configs/base.py``), so
one config drives both packages; the logical axis names are kept for the
same ``ParamSpec`` call sites, though the port does not shard by them.

Every assigned architecture is expressed as a :class:`ModelConfig`; input
shapes as :class:`ShapeConfig`; distribution as :class:`MeshRules` (logical
axis -> mesh axes).  Configs are plain frozen dataclasses so they hash, print,
and diff cleanly, and `replace()` covers reduced smoke variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Logical axis names used to annotate every parameter / activation dimension.
# sharding/rules.py maps these onto physical mesh axes.
# ---------------------------------------------------------------------------
BATCH = "batch"
SEQ = "seq"
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
VOCAB = "vocab"
EXPERTS = "experts"
EXPERT_MLP = "expert_mlp"
LAYERS = "layers"
STATE = "state"          # SSM state dim
CONV = "conv"            # conv kernel dim
COMMITTEE = "committee"
CACHE_SEQ = "cache_seq"  # KV-cache sequence axis (decode)
ENC_SEQ = "enc_seq"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (full, literature-exact configs)."""

    name: str
    family: str  # dense | moe | rwkv6 | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared_experts: int = 0
    moe_shared_d_ff: int = 0          # d_ff of the shared-expert block (qwen2-moe)
    moe_layer_period: int = 1         # MoE on layers where i % period == offset
    moe_layer_offset: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024        # dispatch group size (bounds dispatch FLOPs)
    moe_router_aux_coef: float = 0.01

    # --- attention ---
    sliding_window: Optional[int] = None
    rope_theta: float = 1_000_000.0
    qk_norm: bool = False

    # --- hybrid (jamba) ---
    attn_layer_period: int = 0        # 1 attention layer per `period` layers (jamba: 8)
    attn_layer_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_head_dim: int = 64          # SSD head dim (TPU adaptation, DESIGN.md §6)

    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64          # rank of the data-dependence LoRAs
    rwkv_decay_lora_rank: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper frame positions (post conv stub)

    # --- vlm (internvl) ---
    vision_tokens: int = 0            # stub patch-embedding prefix length

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                 # mlp activation
    dtype: str = "bfloat16"           # activation / compute dtype
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 128
    scan_layers: bool = True
    remat: str = "dots"               # none | dots | full
    logit_softcap: float = 0.0

    # ----------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_num_heads(self) -> int:
        return self.mamba_d_inner // self.mamba_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Layer-type helpers (hybrid / moe interleave) --------------------------
    def is_attention_layer(self, i: int) -> bool:
        if self.family == "rwkv6":
            return False
        if self.attn_layer_period:
            return i % self.attn_layer_period == self.attn_layer_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_num_experts:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    # rule overrides applied on top of the arch rules for this shape
    rule_overrides: Mapping[str, Tuple[str, ...]] = field(default_factory=dict)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig(
    "long_500k", 524288, 1, "decode",
    rule_overrides={CACHE_SEQ: ("data",)},
)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / step configuration."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    decay_steps: int = 10_000
    stable_steps: int = 0             # WSD plateau
    min_lr_ratio: float = 0.1
    accum_steps: int = 1
    zero1: bool = True                # shard opt state over `data` where divisible
    quantized_opt_state: bool = False # legacy alias for opt_moments="int8"
    opt_moments: str = ""             # "" | fp32 | bf16 | int8 — AdamW
                                      # moment storage (optim/adamw.py
                                      # resolve_moments; "" defers to
                                      # quantized_opt_state)
    grad_compression: str = "none"    # none | bf16 (cast at DP-reduce point)
    z_loss_coef: float = 0.0


@dataclass(frozen=True)
class ArchSpec:
    """Everything the launcher needs for one assigned architecture."""

    model: ModelConfig
    shapes: Tuple[ShapeConfig, ...] = ALL_SHAPES
    # shapes skipped with a reason (e.g. long_500k on pure full attention)
    skip_shapes: Mapping[str, str] = field(default_factory=dict)
    # logical axis -> mesh axes; merged over sharding.rules.DEFAULT_RULES
    rules: Mapping[str, Tuple[str, ...]] = field(default_factory=dict)
    # extra overrides applied ONLY for serving kinds (prefill/decode) —
    # e.g. jamba wants 256-way FFN sharding for optimizer state in training
    # but plain 16-way TP when serving bf16 weights (less gather traffic)
    serve_rules: Mapping[str, Tuple[str, ...]] = field(default_factory=dict)
    train: TrainConfig = TrainConfig()

    def runnable_shapes(self) -> Sequence[ShapeConfig]:
        return [s for s in self.shapes if s.name not in self.skip_shapes]


FULL_ATTN_LONG_SKIP = (
    "long_500k skipped: pure full-attention architecture (O(S) KV cache and "
    "O(S^2) prefill at 524288 would not be served this way); see DESIGN.md §5"
)
