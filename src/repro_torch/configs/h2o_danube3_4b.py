"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L, d_model=3840, 32H (GQA kv=8), d_ff=10240, vocab=32000, SWA window 4096.
Baseline long_500k is skipped with the full-attention archs; the SWA-bounded
decode cache variant is exercised in §Perf (DESIGN.md §5).
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    rules={"cache_seq": ("model",)},   # kv=8 < 16
)
