"""whisper-small — encoder-decoder with conv frontend STUB [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768, 12H MHA, d_ff=3072, vocab=51865
(padded 51968).  `input_specs()` provides precomputed frame embeddings
(B, 1500, 768) — the mel+conv frontend is a stub per the assignment.
seq_len applies to the decoder token stream.
"""
from repro_torch.configs.base import FULL_ATTN_LONG_SKIP, ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    rope_theta=0.0,            # whisper uses learned positions, not rope
)

SPEC = ArchSpec(
    model=MODEL,
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
    # 12 heads < 16 -> unshardable; sequence sharding as for minicpm
    rules={"cache_seq": ("model",), "seq": ("model",)},
)
