"""Data: the committee trainer's device replay ring, the LM path's host
replay buffer, deterministic synthetic token streams and a prefetcher."""
from repro_torch.data.prefetch import Prefetcher  # noqa: F401
from repro_torch.data.replay import (  # noqa: F401
    ALReplayBuffer, ReplayTrainingBuffer,
)
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticTokenStream, synthetic_batch,
)
