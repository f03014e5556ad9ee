"""LR schedules: cosine, constant, and WSD (warmup-stable-decay — the
minicpm-2b paper's schedule, wired to that arch's TrainConfig).

A copy of the reference's ``repro/optim/schedule.py`` in torch ops: the
step is a tensor (a device tensor inside the committee trainer's captured
step), every branch is a tensor expression, and the result is a float32
tensor on the step's device — nothing is read on the host, so the schedule
captures into a CUDA graph as it stands.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def make_schedule(
    kind: str,
    base_lr: float,
    warmup_steps: int = 0,
    decay_steps: int = 10_000,
    stable_steps: int = 0,
    min_lr_ratio: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    min_lr = base_lr * min_lr_ratio

    def warmup(step):
        if warmup_steps <= 0:
            return torch.ones_like(step, dtype=torch.float32)
        return torch.clamp(step.to(torch.float32) / float(warmup_steps),
                           max=1.0)

    if kind == "constant":
        def fn(step):
            return base_lr * warmup(step)
    elif kind == "cosine":
        def fn(step):
            s = step.to(torch.float32)
            t = torch.clamp((s - warmup_steps)
                            / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
            cos = 0.5 * (1.0 + torch.cos(math.pi * t))
            return warmup(step) * (min_lr + (base_lr - min_lr) * cos)
    elif kind == "wsd":
        # warmup -> stable plateau at base_lr -> linear decay to min_lr
        def fn(step):
            s = step.to(torch.float32)
            decay_start = warmup_steps + stable_steps
            t = torch.clamp((s - decay_start)
                            / max(decay_steps - decay_start, 1), 0.0, 1.0)
            return warmup(step) * (base_lr - (base_lr - min_lr) * t)
    else:
        raise ValueError(f"unknown schedule {kind!r}")

    return fn
