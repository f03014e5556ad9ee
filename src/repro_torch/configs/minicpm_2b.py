"""minicpm-2b — WSD schedule, llama-like [arXiv:2404.06395].

40L, d_model=2304, 36H MHA, d_ff=5760, vocab=122753 (padded to 122880).
36 heads don't divide 16 -> heads unsharded, TP via d_ff + vocab.
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    # 36 MHA heads don't divide 16 -> heads unshardable; Ulysses-style
    # sequence sharding instead (§Perf: useful flops 0.13 -> 0.91, the
    # dominant memory term 45.4s -> 5.7s)
    rules={"cache_seq": ("model",), "seq": ("model",)},
    train=TrainConfig(schedule="wsd", warmup_steps=100, stable_steps=8000,
                      decay_steps=10_000),
)
