"""Cross-round budgeted acquisition: the global oracle-rate controller and
the rolling-buffer (SI Use Case 2) re-weighting, on the engine's device.

  * ``OracleBudgetController`` — the proportional/integral update that
    steers an effective threshold toward a target oracle-queries-per-round
    rate, in fp32 tensor ops.
  * ``BudgetRule``             — the controller as a ``SelectionRule``; its
    state (effective threshold, leaky integral, EMA rate, round count)
    stays on the device between rounds.
  * ``RollingReweightRule``    — input space hashed into buckets (fixed
    seeded projection); each bucket carries an exponentially-decayed score
    of the highest committee std recently seen there, and samples from
    recently-uncertain regions get their acquisition score boosted for
    downstream rules.
  * ``LatencyController``      — the same control law on host floats,
    steering the serving queue's deadline toward a p99 target.
  * ``rules_from_config``      — the pipeline from ``PALRunConfig`` knobs.

``lsh_projection`` is numpy-seeded, so bucket assignment is bit-identical to
the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.acquisition import (
    STREAM_SERVE, SelectionRule, ThresholdRule, UQStats, _f32,
)


# ---------------------------------------------------------------------------
# Locality-sensitive bucketing (shared by RollingReweightRule and the
# serving tier's LSH answer cache)
# ---------------------------------------------------------------------------


def lsh_projection(in_dim: int, seed: int, n_proj: int = 1) -> np.ndarray:
    """The fixed random projection both LSH consumers hash with: a seeded
    ``(in_dim, n_proj)`` float32 Gaussian matrix, deterministic in
    ``(in_dim, seed, n_proj)`` so bucket assignment is stable across
    processes, restarts and the two packages."""
    return np.random.RandomState(seed).randn(in_dim, n_proj) \
        .astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_projection(in_dim: int, seed: int,
                       device: torch.device) -> torch.Tensor:
    """First projection column on ``device``, uploaded once per
    (in_dim, seed, device) rather than every round."""
    return torch.from_numpy(lsh_projection(in_dim, seed)[:, 0].copy()).to(
        device)


# ---------------------------------------------------------------------------
# Oracle-rate controller (fp32 tensor ops on the engine's device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OracleBudgetController:
    """Proportional/integral control of a selection threshold toward a
    target per-round oracle rate.

    The realized rate of round t is ``r_t = selected / n_valid``; the
    controller moves the effective threshold *multiplicatively*::

        err_t      = r_t - target
        integral_t = integral_{t-1} * (1 - 1/horizon) + err_t      (leaky)
        thr_{t+1}  = clip(thr_t * exp(kp*err_t + ki*integral_t),
                          thr_min, thr_max)

    Multiplicative-exponential updates make the gains scale-free.
    ``horizon`` (rounds) sets both the integral leak and the EMA window of
    the reported ``ema_rate``.  State is a flat dict of 0-d fp32 tensors
    plus an int32 ``rounds``; every scalar op stays fp32 (Python constants
    are rounded to fp32 by the tensor ops, as the reference's casts do).
    """

    target: float                 # oracle-selected fraction per round
    kp: float = 0.8               # proportional gain (per unit rate error)
    ki: float = 0.15              # integral gain
    horizon: int = 16             # rounds: integral leak + EMA window

    def init_state(self, thr_init: float) -> Dict[str, Any]:
        f32 = torch.float32
        return {
            "threshold": torch.tensor(max(float(thr_init), 1e-6), dtype=f32),
            "integral": torch.tensor(0.0, dtype=f32),
            "ema_rate": torch.tensor(self.target, dtype=f32),
            "rounds": torch.tensor(0, dtype=torch.int32),
        }

    def update(self, state: Dict[str, Any], rate,
               thr_min: float, thr_max: float,
               target: Optional[float] = None) -> Dict[str, Any]:
        """One control step.  ``rate`` is the realized selected fraction of
        this round (0-d fp32 tensor); ``target`` overrides the configured
        target for this round (the stream's own target: a 0-d fp32 tensor
        on the device, or a float)."""
        rate = rate.to(torch.float32)
        tgt = self.target if target is None else target
        err = rate - tgt
        leak = 1.0 - 1.0 / max(self.horizon, 1)
        integral = state["integral"] * leak + err
        thr = torch.clamp(
            state["threshold"] * torch.exp(err * self.kp
                                           + integral * self.ki),
            float(np.float32(thr_min)), float(np.float32(thr_max)))
        alpha = 1.0 / max(self.horizon, 1)
        ema = state["ema_rate"] + (rate - state["ema_rate"]) * alpha
        return {"threshold": thr, "integral": integral, "ema_rate": ema,
                "rounds": state["rounds"] + 1}


# ---------------------------------------------------------------------------
# Latency controller (the SAME multiplicative PI, steering a queue deadline
# toward a served-p99 target instead of a threshold toward an oracle rate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatencyController:
    """Adaptive ``ServingQueue`` deadline: steer ``max_wait_ms`` so the
    observed per-request p99 tracks ``target_ms``.

    The :class:`OracleBudgetController` law re-aimed: the observed-over-
    target p99 ratio plays the role of the realized rate (target 1.0) and
    the steered "threshold" is the queue deadline, on host floats because
    the update runs between microbatch dispatches.  The gains are NEGATED:
    p99 above target must SHRINK the deadline, p99 under target can GROW
    it.  ``wait_min_ms``/``wait_max_ms`` bound the controller's authority.
    """

    target_ms: float
    kp: float = 0.7
    ki: float = 0.12
    horizon: int = 12             # update windows: integral leak + EMA
    wait_min_ms: float = 0.05
    wait_max_ms: float = 50.0

    def init_state(self, wait_init_ms: float) -> Dict[str, Any]:
        return {
            "threshold": float(np.clip(wait_init_ms, self.wait_min_ms,
                                       self.wait_max_ms)),
            "integral": 0.0,
            "ema_rate": 1.0,
            "rounds": 0,
        }

    def update(self, state: Dict[str, Any], p99_ms) -> Dict[str, Any]:
        """One control step from one observed p99 window.  Returns the new
        state; ``wait_ms(state)`` reads the steered deadline."""
        rel = float(p99_ms) / max(self.target_ms, 1e-6)
        err = rel - 1.0
        leak = 1.0 - 1.0 / max(self.horizon, 1)
        integral = state["integral"] * leak + err
        wait = float(np.clip(
            state["threshold"] * np.exp(-(self.kp * err
                                          + self.ki * integral)),
            self.wait_min_ms, self.wait_max_ms))
        alpha = 1.0 / max(self.horizon, 1)
        ema = state["ema_rate"] + (rel - state["ema_rate"]) * alpha
        return {"threshold": wait, "integral": integral, "ema_rate": ema,
                "rounds": state["rounds"] + 1}

    @staticmethod
    def wait_ms(state: Dict[str, Any]) -> float:
        return float(state["threshold"])


# ---------------------------------------------------------------------------
# Stateful selection rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BudgetRule(SelectionRule):
    """Budgeted threshold selection: ``scalar_std > thr_t`` where ``thr_t``
    is steered by an :class:`OracleBudgetController` toward ``target``
    selected-per-round rate.

    Drop-in replacement for the static ``ThresholdRule``.  ``thr_init``
    seeds the effective threshold; ``thr_min``/``thr_max`` default to
    1e-3x / 1e+3x of it.  The rate is measured against this rule's OWN
    selection over the TRUE ``n_valid`` — bucket padding never counts.

    PER-STREAM TARGETS: ``target`` meters exchange-loop rounds;
    ``target_serve`` (when set and different) meters rounds tagged
    ``STREAM_SERVE``.  Both streams steer the SAME effective threshold
    (joint control), each round's error measured against its own stream's
    target.
    """

    target: float
    thr_init: float
    kp: float = 0.8
    ki: float = 0.15
    horizon: int = 16
    thr_min: Optional[float] = None     # default: thr_init * 1e-3
    thr_max: Optional[float] = None     # default: thr_init * 1e+3
    target_serve: Optional[float] = None  # default: target (shared budget)

    stateful = True

    @property
    def controller(self) -> OracleBudgetController:
        return OracleBudgetController(self.target, self.kp, self.ki,
                                      self.horizon)

    def _bounds(self) -> Tuple[float, float]:
        base = max(float(self.thr_init), 1e-6)
        lo = base * 1e-3 if self.thr_min is None else float(self.thr_min)
        hi = base * 1e+3 if self.thr_max is None else float(self.thr_max)
        return lo, hi

    def init_state(self) -> Dict[str, Any]:
        return self.controller.init_state(self.thr_init)

    def apply_stateful(self, stats: UQStats, mask, state):
        # n_valid and stream are 0-d device tensors: nothing here reads
        # the host, so the round can be captured in a CUDA graph
        # an fp32 compare against the fp32 state on both backends (the
        # reference's jnp rounds the legacy path's float64 stds to fp32)
        thr = state["threshold"]
        sel = mask & (stats.scalar_std.to(torch.float32) > thr)
        n = stats.n_valid.clamp_min(1).to(torch.float32)
        rate = torch.sum(sel).to(torch.float32) / n
        lo, hi = self._bounds()
        t_serve = self.target if self.target_serve is None \
            else float(self.target_serve)
        if t_serve == self.target:      # shared budget: single-target path
            return stats, sel, self.controller.update(state, rate, lo, hi)
        target = torch.where(stats.stream == STREAM_SERVE, _f32(t_serve),
                             _f32(self.target)).to(torch.float32)
        return stats, sel, self.controller.update(state, rate, lo, hi,
                                                  target=target)


@dataclasses.dataclass(frozen=True)
class RollingReweightRule(SelectionRule):
    """Rolling re-weighting of acquisition scores (the SI Use Case 2
    analog): regions of input space that recently produced high committee
    std get a boosted score for a while.

      * inputs are hashed to ``n_buckets`` region buckets with a fixed
        seeded projection:
        ``bucket = floor(x @ proj / bucket_width) mod n_buckets``
        (``torch.remainder``: the result takes the divisor's sign, as
        ``jnp.mod`` does);
      * each bucket carries an exponentially-decayed score — the running
        max committee std seen there:
        ``scores_t = max(decay * scores_{t-1}, scatter_max(std_t))``;
      * every sample's ``scalar_std`` is re-weighted
        ``std * (1 + boost * scores[bucket]/max(scores))`` for DOWNSTREAM
        rules in the pipeline.

    The rule never selects anything itself; the ``UQResult`` the engine
    reports keeps the RAW statistics.
    """

    n_buckets: int = 64
    decay: float = 0.9            # per-round score decay
    boost: float = 1.0            # max relative score boost
    bucket_width: float = 1.0     # projection quantization step
    seed: int = 0

    stateful = True
    needs_inputs = True

    def init_state(self) -> Dict[str, Any]:
        return {"scores": torch.zeros(self.n_buckets, dtype=torch.float32)}

    def _bucket_ids(self, x):
        x = x.to(torch.float32)
        proj = _device_projection(int(x.shape[-1]), self.seed, x.device)
        z = x @ proj
        idx = torch.floor(z / float(np.float32(self.bucket_width))).to(
            torch.int32)
        return torch.remainder(idx, self.n_buckets)

    def apply_stateful(self, stats: UQStats, mask, state):
        idx = self._bucket_ids(stats.x).long()
        sstd = stats.scalar_std.to(torch.float32)
        valid = stats.valid
        cur = torch.zeros(self.n_buckets, dtype=torch.float32,
                          device=sstd.device).scatter_reduce_(
            0, idx, torch.where(valid, sstd, 0.0), reduce="amax",
            include_self=True)
        scores = torch.maximum(state["scores"] * self.decay, cur)
        norm = scores / (torch.max(scores) + 1e-12)
        weight = 1.0 + self.boost * norm[idx]
        boosted = torch.where(valid, sstd * weight, 0.0)
        stats = dataclasses.replace(stats, scalar_std=boosted)
        return stats, mask, {"scores": scores}


# ---------------------------------------------------------------------------
# Config-driven pipeline construction
# ---------------------------------------------------------------------------


def rules_from_config(run_cfg) -> Optional[Tuple[SelectionRule, ...]]:
    """Selection-rule pipeline from ``PALRunConfig`` budget knobs.

    Returns ``None`` when no budget/re-weighting knob is set (the engine
    then installs its default static ``ThresholdRule``); otherwise the
    pipeline is ``(RollingReweightRule?, BudgetRule | ThresholdRule)`` —
    re-weighting first so the controller sees the boosted scores.

    Per-stream budgets: ``oracle_budget_exchange`` / ``oracle_budget_serve``
    default to the shared ``oracle_budget`` when unset (0), and a stream
    whose own knob AND the shared budget are both unset inherits the other
    stream's target (one controller, one threshold).
    """
    rules = []
    n_buckets = int(getattr(run_cfg, "reweight_buckets", 0) or 0)
    if n_buckets > 0:
        rules.append(RollingReweightRule(
            n_buckets=n_buckets,
            decay=float(getattr(run_cfg, "reweight_decay", 0.9)),
            boost=float(getattr(run_cfg, "reweight_boost", 1.0))))
    shared = float(getattr(run_cfg, "oracle_budget", 0.0) or 0.0)
    t_ex = float(getattr(run_cfg, "oracle_budget_exchange", 0.0) or 0.0) \
        or shared
    t_sv = float(getattr(run_cfg, "oracle_budget_serve", 0.0) or 0.0) \
        or shared
    if t_ex > 0.0 or t_sv > 0.0:
        rules.append(BudgetRule(
            target=(t_ex or t_sv), thr_init=run_cfg.std_threshold,
            horizon=int(getattr(run_cfg, "budget_horizon", 16)),
            target_serve=(t_sv or t_ex)))
    elif rules:
        rules.append(ThresholdRule(run_cfg.std_threshold))
    return tuple(rules) if rules else None
