"""MemoryPolicy: per-member dtype/layout of the stacked committee TrainState.

A copy of the reference's ``repro/optim/memory_policy.py``.  The storage
format of the committee trainer's stacked state is a POLICY:

  * ``moments``  — AdamW moment storage: ``fp32``, ``bf16`` (mu/nu cast to
    bfloat16 between steps, math still fp32) or ``int8`` (per-block absmax
    ``QTensor`` mu + sqrt(nu) from ``optim/adamw.py``);
  * ``params_dtype`` — stacked parameter storage (``float32`` default;
    ``bfloat16`` halves the K x params term; the update math stays fp32);
  * ``replay_dtype`` — ``data/replay.ReplayTrainingBuffer`` row storage
    (``bfloat16`` halves the ring; minibatches are gathered back to fp32
    on the device before the loss sees them).

Quantize/dequantize run inside the trainer's one step program (one
captured CUDA graph on the card) under every policy.  Snapshots carry the
quantized leaves natively, and restoring a snapshot whose storage format
differs from the configured policy raises.

The footprint is counted from shapes and dtypes alone (the reference asks
``jax.eval_shape``): params in ``params_dtype``, the two moments in their
format (int8 ``q`` plus the fp32 per-block scales), and the two int32 step
counters — exactly the bytes of the buffers the trainer allocates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.optim.adamw import _block_for, _pick_axis

MOMENT_FORMATS = ("fp32", "bf16", "int8")
_STORAGE_DTYPES = ("float32", "bfloat16")
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class MemoryPolicy:
    """Storage policy for one committee member (applied uniformly to the
    stack).  ``named()`` gives the presets the ``PALRunConfig.
    train_memory_policy`` knob selects; fields compose freely via
    ``dataclasses.replace``."""

    name: str = "fp32"
    moments: str = "fp32"            # fp32 | bf16 | int8 (QTensor sqrt-nu)
    params_dtype: str = "float32"    # float32 | bfloat16
    replay_dtype: str = "float32"    # float32 | bfloat16

    def __post_init__(self):
        if self.moments not in MOMENT_FORMATS:
            raise ValueError(
                f"unknown moment format {self.moments!r}; expected one of "
                f"{MOMENT_FORMATS}")
        for field in ("params_dtype", "replay_dtype"):
            v = getattr(self, field)
            if v not in _STORAGE_DTYPES:
                raise ValueError(
                    f"unknown {field} {v!r}; expected one of "
                    f"{_STORAGE_DTYPES}")

    @staticmethod
    def named(name: str) -> "MemoryPolicy":
        if name not in MOMENT_FORMATS:
            raise ValueError(
                f"unknown memory policy {name!r}; expected one of "
                f"{MOMENT_FORMATS}")
        return MemoryPolicy(name=name, moments=name)

    def describe(self) -> str:
        return (f"{self.name}(moments={self.moments}, "
                f"params={self.params_dtype}, replay={self.replay_dtype})")


def resolve_policy(policy: Union[str, MemoryPolicy, None]
                   ) -> Optional[MemoryPolicy]:
    """None passes through (caller keeps legacy TrainConfig semantics);
    a string selects a named preset; a MemoryPolicy is validated as-is."""
    if policy is None:
        return None
    if isinstance(policy, str):
        return MemoryPolicy.named(policy)
    if isinstance(policy, MemoryPolicy):
        return policy
    raise TypeError(f"memory_policy must be str | MemoryPolicy | None, "
                    f"got {type(policy).__name__}")


# ---------------------------------------------------------------------------
# Footprint accounting (exact, allocation-free)
# ---------------------------------------------------------------------------


def _shape_dtype(leaf):
    shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
    dt = getattr(leaf, "dtype", np.float32)
    if isinstance(dt, torch.dtype):
        return shape, dt.is_floating_point, dt.itemsize
    dt = np.dtype(dt)
    floating = np.issubdtype(dt, np.floating) or dt.name == "bfloat16"
    return shape, floating, dt.itemsize


def _moment_nbytes(shape, fmt: str) -> int:
    n = int(np.prod(shape))
    if fmt == "fp32":
        return 4 * n
    if fmt == "bf16":
        return 2 * n
    if not shape:                       # 0-d: one q byte, one fp32 scale
        return 1 + 4
    b = _block_for(shape[_pick_axis(shape)])
    return n + 4 * (n // b)


def member_state_nbytes(member_params: Any, policy: MemoryPolicy) -> int:
    """Exact per-member ``TrainState`` bytes under ``policy``: params (in
    ``params_dtype``), AdamW mu/nu in the ``moments`` format (including the
    per-block fp32 scale arrays of int8 ``QTensor`` moments), and the two
    int32 step counters.  No buffers allocated."""
    total = 2 * 4                       # TrainState.step + AdamWState.step
    for leaf in pytree.tree_leaves(member_params):
        shape, floating, itemsize = _shape_dtype(leaf)
        n = int(np.prod(shape))
        total += n * (_ITEMSIZE[policy.params_dtype] if floating
                      else itemsize)
        total += 2 * _moment_nbytes(shape, policy.moments)
    return total


def stacked_state_nbytes(member_params: Any, k: int,
                         policy: MemoryPolicy) -> int:
    """Exact stacked K-member committee ``TrainState`` bytes: stacking
    gives every leaf (params, moments, scales, steps) a leading K axis,
    so the footprint is exactly K x the per-member state."""
    return int(k) * member_state_nbytes(member_params, policy)
