"""Optimizers: AdamW with fp32, bf16 or int8 moments, LR schedules, and the
committee trainer's storage policy (torch ops; nothing read on the host)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, QTensor, adamw_init, adamw_update, clip_by_global_norm,
    dequantize, global_norm, quantize, resolve_moments,
)
from repro_torch.optim.memory_policy import (  # noqa: F401
    MemoryPolicy, member_state_nbytes, resolve_policy, stacked_state_nbytes,
)
from repro_torch.optim.schedule import make_schedule  # noqa: F401
