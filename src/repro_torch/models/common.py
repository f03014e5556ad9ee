"""Shared model machinery: ParamSpec trees, init, norms, RoPE, embeddings.

Models are functional: parameters are plain (nested) dicts of tensors in
the reference's layout and keys (weights ``(in, out)``, applied as
``x @ w``), so the reference's parameters carry across through numpy with
no transposes.  ``ParamSpec`` carries the reference's logical ``axes``:
``sharding/rules.py`` resolves them to layouts, and the planners
(``launch/dryrun.py``) lay abstract trees out with them.
The numerics follow ``repro/models/common.py`` line by line: norms and
RoPE in fp32, cast back to the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import base as ax
from repro_torch.launch.platform import DeviceLike

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``cfg.dtype``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...] = ()   # logical axis per dim
    init: str = "normal"                   # normal | zeros | ones | uniform
    scale: float = 1.0                     # std multiplier (normal) / bound
    dtype: torch.dtype = torch.float32

    def abstract(self) -> torch.Tensor:
        """The leaf's shape and dtype with no storage: a ``meta`` tensor
        (the reference's ``ShapeDtypeStruct``)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def materialize(self, generator: torch.Generator) -> torch.Tensor:
        """Draw the leaf on the generator's device: zeros, ones, a uniform
        in [-scale, scale], or a normal with std scale/sqrt(fan_in)."""
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        if self.init == "uniform":
            u = torch.rand(self.shape, generator=generator,
                           dtype=torch.float32, device=dev)
            return (u * (2 * self.scale) - self.scale).to(self.dtype)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(self.dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[ParamSpec], Any], specs):
    """Apply ``fn`` to every ParamSpec of a nested dict, keys in sorted
    order (the order the reference's pytrees use)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k]) for k in sorted(specs)}
    return fn(specs)


def init_params(specs, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Materialize a (nested) dict of specs, drawing leaves in sorted key
    order (deterministic for a given generator state), then place them on
    ``device`` (default: the generator's device)."""
    out = map_specs(lambda s: s.materialize(generator), specs)
    if device is not None:
        out = map_specs(lambda t: t.to(device), out)
    return out


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def abstract_params(specs):
    """The spec tree as ``meta`` tensors (shapes and dtypes, nothing
    allocated)."""
    return map_specs(lambda s: s.abstract(), specs)


def param_axes(specs):
    """The spec tree's logical axes, one tuple per leaf."""
    return map_specs(lambda s: s.axes, specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in _spec_leaves(specs))


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a ('layers') axis."""
    return dataclasses.replace(
        spec, shape=(n,) + spec.shape, axes=(ax.LAYERS,) + spec.axes)


def stack_tree(specs, n: int):
    return map_specs(lambda s: stacked(s, n), specs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps))
            * weight.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the last dim (the rwkv6 output norm), in
    fp32; cast back to x's dtype."""
    dt = x.dtype
    *lead, D = x.shape
    xf = x.to(torch.float32).reshape(*lead, groups, D // groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, D)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles for positions (..., T) or (T,), in
    fp32, shaped (..., T, 1, head_dim // 2) to broadcast over heads.  A
    model computes them once per step and shares them across layers."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., T, H, D) by ``rope_tables``' (cos, sin), split-halves
    convention, in fp32; cast back to x's dtype."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-halves convention. x: (..., T, H, D) with
    positions (..., T) or (T,).  Frequencies and angles in fp32."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal table (n, d) on the CPU: built in float64
    numpy and cast to fp32, as the reference builds it (the caller moves it
    to its device)."""
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = np.exp(-log_timescale * np.arange(half))
    pos = np.arange(n)[:, None] * inv[None, :]
    return torch.from_numpy(
        np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32))


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def take_embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Gather rows; fp32 table -> activation dtype downstream."""
    return table[tokens]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)
