"""Serving: the LM ``ServeEngine`` (prefill + decode), ``CommitteeServer``
on the fused acquisition engine, and the multi-tenant microbatching
``ServingQueue`` (with its optional LSH answer cache) in front of it."""
from repro_torch.serving.cache import LSHAnswerCache  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    CommitteeServer, GenerationResult, ServeEngine,
)
from repro_torch.serving.queue import (  # noqa: F401
    CircuitOpen, QueueConfig, QueueOverloaded, RateLimited, ServingQueue,
    ServingRejected,
)
