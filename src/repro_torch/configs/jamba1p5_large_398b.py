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

ONE_CARD_CUT = {"num_layers": 8, "moe_num_experts": 2}
"""The one-card cut of this model (``MODEL.replace(**ONE_CARD_CUT)``), for
one H100 80GB.  Counted with ``model_zoo.count_params``: 397.6 B
parameters whole; at 8 layers (one period-8 group, the least depth
``jamba.param_specs`` takes) 45.13 B with 16 experts, 16.14 B with 4,
13.73 B with 3 and 11.31 B with 2.  ``ServeEngine`` keeps the fp32
parameters and their bf16 compute copy, 6 bytes per parameter: 270.8,
96.9, 82.4 and 67.9 GB (63.2 GiB), so only 2 experts leave room for
activations on an 80 GB card.  Every width stays published (d_model 8192,
d_ff 24576, vocab 65536, 64 heads over 8 kv heads of 128, Mamba d_inner
16384 as 128 SSD heads of P = 128 with d_state 16 and d_conv 4, top-2
routing at capacity factor 1.25 in groups of 1024, attention at offset 4
of 8, MoE on odd offsets).  Top-2 of 2 experts sends every token to both,
and the capacity min(1280, 1024) drops nothing: the cut runs the router,
dispatch and combine but never a drop."""
