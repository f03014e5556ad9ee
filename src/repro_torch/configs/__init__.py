"""Configurations (copies of the reference's jax-free dataclasses) and the
arch registry: ``get_arch(name)`` / ``list_archs()`` / ``get_shape``.

The ten assigned architectures; arch ids match the reference's registry
(``repro/configs/__init__.py``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchSpec,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
)

from repro_torch.configs import (  # noqa: E402
    h2o_danube3_4b,
    internvl2_2b,
    jamba1p5_large_398b,
    llama3p2_1b,
    minicpm_2b,
    mistral_nemo_12b,
    qwen2_moe_a2p7b,
    qwen3_moe_235b_a22b,
    rwkv6_7b,
    whisper_small,
)

_REGISTRY: Dict[str, ArchSpec] = {
    "rwkv6-7b": rwkv6_7b.SPEC,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b.SPEC,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.SPEC,
    "minicpm-2b": minicpm_2b.SPEC,
    "llama3.2-1b": llama3p2_1b.SPEC,
    "h2o-danube-3-4b": h2o_danube3_4b.SPEC,
    "mistral-nemo-12b": mistral_nemo_12b.SPEC,
    "jamba-1.5-large-398b": jamba1p5_large_398b.SPEC,
    "whisper-small": whisper_small.SPEC,
    "internvl2-2b": internvl2_2b.SPEC,
}


def list_archs():
    return sorted(_REGISTRY)


def get_arch(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _REGISTRY[name]


def get_shape(spec: ArchSpec, shape_name: str) -> ShapeConfig:
    for s in spec.shapes:
        if s.name == shape_name:
            return s
    raise KeyError(f"unknown shape {shape_name!r}")
