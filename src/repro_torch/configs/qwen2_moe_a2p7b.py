"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16H (kv=16), per-expert d_ff=1408, vocab=151936,
60 routed experts top-4 + 4 shared experts (shared d_ff = 4*1408 = 5632).
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                   # per-expert
    vocab_size=151936,
    moe_num_experts=60,
    moe_top_k=4,
    moe_num_shared_experts=4,
    moe_shared_d_ff=5632,
    moe_group_size=256,          # §Perf iter 2/4: dispatch cost ~ E*C*D, C ~ S

    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    # 60 experts don't divide 16 -> per-expert TP on d_ff (1408/16=88);
    # rules resolver falls back automatically, pinned here for clarity.
    rules={"experts": (), "expert_mlp": ("model",)},
)

ONE_CARD_CUT = {"num_layers": 16}
"""The one-card cut of this model (``MODEL.replace(**ONE_CARD_CUT)``), for
one H100 80GB.  Counted with ``model_zoo.count_params``: 14,315,636,736
parameters whole (24 layers), 9,751,201,792 at 16 layers.
``ServeEngine`` keeps the fp32 parameters and their bf16 compute copy, 6
bytes per parameter: 85.9 GB whole, which does not fit the card, and
58.5 GB (54.5 GiB) at 16 layers, which leaves about 20 GB for the bf16
activations, the MoE dispatch tensors and the KV cache.  Only the depth is
cut; every width stays published (d_model 2048, 16 heads of 128, 60
routed experts top-4 at d_ff 1408, 4 shared experts at d_ff 5632, vocab
151936, groups of 256 tokens, capacity factor 1.25)."""
