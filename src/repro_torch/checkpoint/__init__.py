"""Atomic, async pytree checkpoints (bf16 leaves kept bit for bit)."""
from repro_torch.checkpoint.pytree_ckpt import (  # noqa: F401
    AsyncCheckpointer, BF16Bits, load_checkpoint, save_checkpoint,
)
