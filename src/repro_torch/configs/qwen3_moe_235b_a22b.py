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

ONE_CARD_CUT = {"num_layers": 4}
"""The one-card cut of this model (``MODEL.replace(**ONE_CARD_CUT)``), for
one H100 80GB.  Counted with ``model_zoo.count_params``: 235,093,634,560
parameters whole (94 layers), 11,195,683,840 at 4 layers (8,707,928,832
at 3, 13,683,438,848 at 5).  ``ServeEngine`` keeps the fp32 parameters and
their bf16 compute copy, 6 bytes per parameter: 67.2 GB (62.56 GiB) at 4
layers; 5 layers (82.1 GB) do not fit the card.  Measured by
``chip_smoke.phase_qwen3_moe`` (B = 8, prompt 512, 64 new tokens) on an
NVIDIA H100 80GB HBM3 at 700.00 W: the captured ``generate`` peaks at
63.005 GiB allocated when the phase runs alone (65.670 GiB held once its
graphs are captured; the eager loop 64.705 GiB) and at 64.505 GiB after
the earlier phases of ``chip_smoke.py``, of 79.18 GiB.  Only the depth
is cut; every width stays published (d_model 4096, 64 query heads over 4
kv heads of 128 with qk-norm, 128 routed experts top-8 at d_ff 1536, vocab
151936, groups of 1024 tokens, capacity factor 1.25)."""
