"""Models: the committee MLP potential, the LM zoo's six families (dense,
MoE, RWKV6, the Jamba hybrid, the Whisper encoder-decoder and the InternVL
vision LM) with their remat policy, and their parameter machinery."""
from repro_torch.models.model_zoo import build_model  # noqa: F401
