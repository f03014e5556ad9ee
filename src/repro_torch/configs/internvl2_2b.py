"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821].

Backbone only (assignment): 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92553 (padded 92672).  The InternViT frontend is a STUB —
`input_specs()` provides (B, 256, 2048) precomputed patch embeddings used as
a sequence prefix; text tokens fill the remaining positions.
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    vision_tokens=256,
    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    rules={"cache_seq": ("model",)},   # kv=8 < 16
)
