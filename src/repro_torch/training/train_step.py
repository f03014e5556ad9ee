"""Train/eval step builders: loss -> grads -> clip -> schedule -> AdamW, with
gradient accumulation and an optional bf16 gradient-compression cast.

The reference's ``repro/training/train_step.py`` in torch: gradients come
from ``torch.func.grad_and_value(loss_fn, has_aux=True)``, so the step
composes with ``torch.func.vmap`` (the committee trainer maps it over the
stacked K axis).  The returned step is a pure function (state, batch) ->
(new_state, metrics) of tensor ops that reads nothing on the host, so the
committee trainer captures it into one CUDA graph.

The loss is differentiated at fp32 copies of the floating params (a no-op
for fp32 storage): torch's matmul does not promote a bf16 weight against
fp32 inputs as jnp does, and the update math is fp32 either way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import grad_and_value

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.adamw import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, clip_by_global_norm,
)
from repro_torch.optim.schedule import make_schedule


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt: AdamWState


def make_train_state(params: Any, train_cfg: TrainConfig) -> TrainState:
    first = pytree.tree_leaves(params)[0]
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        params=params,
        opt=adamw_init(params, quantized=train_cfg.quantized_opt_state,
                       moments=getattr(train_cfg, "opt_moments", "")),
    )


def _as_fp32(params):
    return pytree.tree_map(
        lambda p: p.to(torch.float32) if p.is_floating_point() else p,
        params)


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict]],
    train_cfg: TrainConfig,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict]]:
    schedule = make_schedule(
        train_cfg.schedule, train_cfg.learning_rate,
        warmup_steps=train_cfg.warmup_steps,
        decay_steps=train_cfg.decay_steps,
        stable_steps=train_cfg.stable_steps,
        min_lr_ratio=train_cfg.min_lr_ratio,
    )
    adam_cfg = AdamWConfig(
        beta1=train_cfg.beta1, beta2=train_cfg.beta2, eps=train_cfg.eps,
        weight_decay=train_cfg.weight_decay,
        quantized=train_cfg.quantized_opt_state,
        moments=getattr(train_cfg, "opt_moments", ""),
    )
    grad_fn = grad_and_value(loss_fn, has_aux=True)
    accum = max(1, train_cfg.accum_steps)

    def compute_grads(params, batch):
        params = _as_fp32(params)
        if accum == 1:
            grads, (loss, metrics) = grad_fn(params, batch)
        else:
            # microbatches over the leading batch dim, summed in order
            grads, loss = None, None
            for i in range(accum):
                mb = pytree.tree_map(
                    lambda x: x[i * (x.shape[0] // accum):
                                (i + 1) * (x.shape[0] // accum)], batch)
                g, (l, _) = grad_fn(params, mb)
                grads = g if grads is None else pytree.tree_map(
                    torch.add, grads, g)
                loss = l if loss is None else loss + l
            grads = pytree.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {}
        if train_cfg.grad_compression == "bf16":
            # the cast at the cross-replica reduction point (half the
            # all-reduce bytes under data parallelism)
            grads = pytree.tree_map(lambda g: g.to(torch.bfloat16), grads)
        return loss, metrics, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = compute_grads(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip_norm)
        lr = schedule(state.step)
        new_params, new_opt = adamw_update(grads, state.opt, state.params,
                                           lr, adam_cfg)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def make_eval_step(loss_fn):
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
