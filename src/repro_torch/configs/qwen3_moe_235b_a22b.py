"""qwen3-moe-235b-a22b — Qwen3 MoE family [hf:Qwen/Qwen3-30B-A3B scaled config].

94L, d_model=4096, 64H (GQA kv=4), per-expert d_ff=1536, vocab=151936,
128 routed experts top-8, qk-norm (qwen3).
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                   # per-expert
    vocab_size=151936,
    moe_num_experts=128,
    moe_top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

from repro_torch.configs.base import TrainConfig

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    # EP: 128 experts / 16 = 8 per device; expert F FSDP-sharded over `data`
    # (§Perf iter 2: 168 -> 19.6 GiB/dev); int8 Adam moments (iter 3:
    # -> 9.9 GiB/dev, fits v5e HBM).
    rules={"experts": ("model",), "expert_mlp": ("data",),
           "cache_seq": ("model",)},   # kv=4 < 16
    train=TrainConfig(quantized_opt_state=True),
)
