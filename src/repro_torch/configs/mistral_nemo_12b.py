"""mistral-nemo-12b — 128k context [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model=5120, 32H (GQA kv=8) with explicit head_dim=128 (32*128=4096
!= d_model — true Nemo config), d_ff=14336, vocab=131072.
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    rules={"cache_seq": ("model",)},   # kv=8 < 16
)
