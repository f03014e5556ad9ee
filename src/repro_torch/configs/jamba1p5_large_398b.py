"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887 / Jamba-1.5].

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536, 16 experts top-2
on every other layer; 1 attention layer per 8 (offset 4).
Hybrid family: `long_500k` RUNS (mamba state O(1), 9 attention layers' KV
sharded over `data` on the cache-sequence axis).

Mamba mixer realized in the SSD-chunked TPU form (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mamba_head_dim=128,
    rope_theta=10_000.0,     # jamba attention layers use no rope in v1; 1.5 uses it
)

SPEC = ArchSpec(
    model=MODEL,
    # EP 16/16 over `model`; expert F FSDP over `data` (§Perf: serving
    # residency 47 -> 8.7 GiB/dev, training master/moments sharded 256-way)
    # dense-FFN / mamba inner dim F=24576 shards over BOTH axes (256-way,
    # §Perf: non-expert master+moments 18 -> 1.1 GiB/dev)
    rules={"experts": ("model",), "expert_mlp": ("data",),
           "mlp": ("model", "data"),
           "cache_seq": ("model",)},                   # kv=8 < 16 (decode_32k)
    serve_rules={"mlp": ("model",)},   # serving: bf16 weights fit at 16-way
                                       # TP; 256-way costs gather collectives
    train=TrainConfig(quantized_opt_state=True),
)
