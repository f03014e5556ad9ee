"""Parameter specs and init.

Models are functional: parameters are plain dicts of tensors in the
reference's layout and keys (weights ``(in, out)``, applied as ``x @ w``),
so the reference's parameters carry across through numpy with no
transposes.  ``ParamSpec`` keeps the reference's ``axes`` field for the
same call sites; the port has no logical-axis sharding and ignores it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch.platform import DeviceLike


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...] = ()   # logical axes (unused here)
    init: str = "normal"                   # normal | zeros

    def materialize(self, generator: torch.Generator) -> torch.Tensor:
        """Draw the fp32 leaf on the generator's device: zeros, or a
        normal with std 1/sqrt(fan_in)."""
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=torch.float32, device=dev)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x / math.sqrt(max(fan_in, 1))


def init_params(specs: Dict[str, ParamSpec], generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Materialize a flat dict of specs, drawing leaves in sorted key order
    (deterministic for a given generator state), then place them on
    ``device`` (default: the generator's device)."""
    out = {k: specs[k].materialize(generator) for k in sorted(specs)}
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out
