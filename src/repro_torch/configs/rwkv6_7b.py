"""rwkv6-7b — Finch, data-dependent decay [arXiv:2404.05892].

32L, d_model=4096, attention-free, d_ff=14336, vocab=65536.
Linear-attention family: `long_500k` RUNS (O(1) decode state).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

MODEL = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
    rwkv_decay_lora_rank=128,
    tie_embeddings=False,
    act="relu_sq",           # rwkv channel-mix uses squared ReLU
)

SPEC = ArchSpec(model=MODEL)
