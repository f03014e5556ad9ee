"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L, d_model=2048, 32H (GQA kv=8), d_ff=8192, vocab=128256.
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    # kv=8 cannot shard 16-way -> decode cache shards its sequence axis
    rules={"cache_seq": ("model",)},
)
