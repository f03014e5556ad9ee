"""Centralized uncertainty-driven selection (paper §2.5 + SI Utilities).

``prediction_check`` is the paper's controller-side function deciding (a)
which generator proposals go to the oracle and (b) what each generator
receives back; on the unified path the acquisition engine
(core/acquisition.py) makes that decision and ``selection_from_uq`` routes
its ``UQResult`` into a ``SelectionResult``.  ``adjust_input_for_oracle``
(and its ``_uq`` variant consuming engine statistics) re-prioritizes the
oracle buffer with the freshest committee (``dynamic_oracle_list``).
``PatienceTracker`` implements
the generator-side "allow trajectories to propagate into regions of high
uncertainty for a given number of steps" policy (§2.2) — decision logic is
the generator's, UQ stays central, exactly as the paper splits it.

This module is the HOST-side realization layer: the selection decision
itself is made inside the acquisition engine (device-side rule pipeline —
``acquisition.ThresholdRule`` & friends, plus the cross-round stateful
rules in ``core/budget.py``); the functions here turn the resulting
``UQResult`` into oracle-queue entries and per-generator scatter lists,
and provide the float64 reference ports the parity tests compare against.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SelectionResult:
    """Outcome of one prediction_check round."""

    inputs_to_oracle: List[np.ndarray]
    data_to_generators: List[Any]            # one per generator, rank-sorted
    uncertain_mask: np.ndarray               # (n_gen,) bool
    std: np.ndarray                          # (n_gen,) scalar disagreement


def prediction_check(
    list_data_to_pred: Sequence[np.ndarray],    # gathered generator inputs
    committee_preds: np.ndarray,                # (K, n_gen, out_dim)
    threshold: float,
    flag_value: Optional[float] = None,
) -> SelectionResult:
    """Faithful port of the paper's utils.prediction_check.

    Committee std over members; samples whose std exceeds `threshold` in any
    output component are queued for the oracle.  Generators receive the
    committee mean; for uncertain samples the paper's example sends a flag
    (0) instead — we return the mean plus a mask so generators can apply
    their own patience policy (flag_value reproduces the paper's behavior
    when set).
    """
    preds = np.asarray(committee_preds, dtype=np.float64)
    k = preds.shape[0]
    std = preds.std(axis=0, ddof=1) if k > 1 else np.zeros_like(preds[0])
    uncertain = (std > threshold).any(axis=tuple(range(1, std.ndim)))
    scalar_std = std.reshape(std.shape[0], -1).max(axis=-1)

    inputs_to_oracle = [np.asarray(list_data_to_pred[i])
                        for i in np.where(uncertain)[0]]
    mean = preds.mean(axis=0)
    if flag_value is not None:
        mean = mean.copy()
        mean[uncertain] = flag_value
    data_to_generators = list(mean)
    return SelectionResult(inputs_to_oracle, data_to_generators, uncertain,
                           scalar_std)


def prediction_check_fast(
    list_data_to_pred: Sequence[np.ndarray],
    mean: np.ndarray,                           # (n_gen, out_dim)
    scalar_std: np.ndarray,                     # (n_gen,)
    uncertain_mask: np.ndarray,                 # (n_gen,) bool
    flag_value: Optional[float] = None,
    scatter_out: Optional[List[Any]] = None,
) -> SelectionResult:
    """Fast-path ``prediction_check`` consuming precomputed device UQ.

    The fused acquisition engine (acquisition.FusedEngine) already computed
    mean / ddof-1 scalar std / selection mask on device in the same
    dispatch as the committee forward; this just routes them — no float64
    recompute, no (K, n_gen, out_dim) host tensor.  Semantics match
    ``prediction_check`` exactly (same SelectionResult for the same
    committee outputs).

    ``scatter_out``: an optional preallocated per-generator list to fill
    in place (and return as ``data_to_generators``) instead of allocating
    a fresh scatter list every round — the Exchange hot loop reuses its
    buffer through this.
    """
    mean = np.asarray(mean)
    mask = np.asarray(uncertain_mask, dtype=bool)
    scalar_std = np.asarray(scalar_std)
    inputs_to_oracle = [np.asarray(list_data_to_pred[i])
                        for i in np.where(mask)[0]]
    if flag_value is not None:
        mean = mean.copy()
        mean[mask] = flag_value
    if scatter_out is None:
        scatter = list(mean)
    else:
        for i in range(len(mean)):
            scatter_out[i] = mean[i]
        scatter = scatter_out
    return SelectionResult(inputs_to_oracle, scatter, mask, scalar_std)


def selection_from_uq(
    list_data_to_pred: Sequence[np.ndarray],
    uq,                                         # acquisition.UQResult
    flag_value: Optional[float] = None,
    scatter_out: Optional[List[Any]] = None,
) -> SelectionResult:
    """Route an acquisition-engine ``UQResult`` into a SelectionResult.

    The engine already computed mean / std statistics AND the final rule
    mask (device-side on fused backends); this only materializes the
    per-generator scatter lists (into ``scatter_out`` when the caller
    reuses a buffer).  Semantics match ``prediction_check`` exactly for
    the default threshold rule.
    """
    return prediction_check_fast(list_data_to_pred, uq.mean, uq.scalar_std,
                                 uq.mask, flag_value,
                                 scatter_out=scatter_out)


def adjust_input_for_oracle(
    to_orcl_buffer: List[np.ndarray],
    committee_preds: np.ndarray,                # (K, n_buf, out_dim)
    threshold: float,
) -> List[np.ndarray]:
    """Faithful port of utils.adjust_input_for_oracle: sort the waiting
    oracle inputs by fresh-committee std (descending) and drop entries whose
    uncertainty no longer exceeds the threshold."""
    if not to_orcl_buffer:
        return []
    preds = np.asarray(committee_preds, dtype=np.float64)
    k = preds.shape[0]
    std = preds.std(axis=0, ddof=1) if k > 1 else np.zeros_like(preds[0])
    score = std.reshape(std.shape[0], -1).mean(axis=-1)
    order = np.argsort(score)[::-1]
    keep = [int(i) for i in order
            if (std[i] > threshold).any()]
    return [to_orcl_buffer[i] for i in keep]


def adjust_input_for_oracle_uq(
    to_orcl_buffer: List[np.ndarray],
    uq,                                         # acquisition.UQResult
    threshold: float,
    honor_selection: bool = False,
) -> List[np.ndarray]:
    """``adjust_input_for_oracle`` consuming an engine ``UQResult``: sort
    waiting oracle inputs by mean-over-components committee std
    (descending, ``uq.component_std``) and drop entries whose max-component
    std no longer exceeds ``threshold`` (``(std > t).any(components) ==
    scalar_std > t``).  Same kept-order semantics as the stacked-preds
    port, with no ``(K, n_buf, out_dim)`` host tensor and no float64
    recompute — the statistics come straight off the device pass.

    ``honor_selection``: additionally keep every entry the engine's OWN
    rule pipeline re-selected (``uq.mask``) even if below ``threshold`` —
    under the default threshold rule this is a no-op (mask == scalar_std >
    threshold for the same configured value), but with a custom pipeline
    (e.g. top-fraction) it guarantees the re-prioritization never drops a
    sample the active selection policy just chose."""
    if not to_orcl_buffer:
        return []
    order = np.argsort(np.asarray(uq.component_std))[::-1]
    keep_mask = np.asarray(uq.scalar_std) > threshold
    if honor_selection:
        keep_mask = keep_mask | np.asarray(uq.mask, dtype=bool)
    return [to_orcl_buffer[int(i)] for i in order if keep_mask[int(i)]]


class PatienceTracker:
    """Generator-side reaction policy to central uncertainty flags (§2.2).

    A trajectory may continue through up to ``patience`` consecutive
    uncertain steps; beyond that the generator should restart (reset to a
    trusted state).  One counter per generator rank.

    This is the HOST realization, used by the per-generator Exchange path.
    The device-resident exploration fleet applies the identical update as
    ``exploration.fleet.PatienceRestart`` — stacked ``jnp.where`` counters
    folded into the fused dispatch — and the parity test holds the two to
    the same counts/restarts/flags step for step."""

    def __init__(self, n_generators: int, patience: int):
        self.patience = patience
        self.counts = np.zeros(n_generators, dtype=int)
        self.restarts = np.zeros(n_generators, dtype=int)

    def step(self, uncertain_mask: np.ndarray) -> np.ndarray:
        """Returns a bool mask of generators that must restart now."""
        self.counts = np.where(uncertain_mask, self.counts + 1, 0)
        restart = self.counts > self.patience
        self.restarts += restart
        self.counts[restart] = 0
        return restart

    def state_dict(self):
        return {"counts": self.counts.copy(), "restarts": self.restarts.copy()}

    def load_state_dict(self, s):
        self.counts = np.asarray(s["counts"]).copy()
        self.restarts = np.asarray(s["restarts"]).copy()


# ---------------------------------------------------------------------------
# Alternative acquisition scores (beyond the paper's std-threshold, for the
# LM path and ablations)
# ---------------------------------------------------------------------------


def top_fraction(scores: np.ndarray, fraction: float) -> np.ndarray:
    """Indices of the top `fraction` most-uncertain samples."""
    n = max(int(round(len(scores) * fraction)), 0)
    if n == 0:
        return np.empty(0, dtype=int)
    return np.argsort(scores)[::-1][:n]


def diversity_filter(inputs: Sequence[np.ndarray], selected: np.ndarray,
                     min_dist: float) -> np.ndarray:
    """Greedy de-duplication: drop selected samples closer than min_dist to
    an already-kept one (paper §3.1: 'avoiding similar and thus redundant
    TDDFT calculations').

    The full pairwise-distance matrix is computed in one vectorized NumPy
    pass (Gram-matrix identity), with pairs that land within cancellation
    error of the ``min_dist`` boundary recomputed via direct differences;
    the greedy sweep then reduces each candidate to a single masked row
    lookup.  Kept-index semantics match the original O(n^2) pure-Python
    loop: candidates are visited in ``selected`` order and kept iff no
    already-kept sample lies strictly closer than ``min_dist``.
    """
    sel_idx = np.asarray(selected, dtype=int).reshape(-1)
    if sel_idx.size == 0:
        return np.empty(0, dtype=int)
    X = np.stack([np.asarray(inputs[int(i)], dtype=np.float64).reshape(-1)
                  for i in sel_idx])
    sq = np.einsum("id,id->i", X, X)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    md2 = float(min_dist) ** 2
    close = d2 < md2
    # Gram identity cancels catastrophically for large-norm inputs; pairs
    # within its error band of the threshold get the exact distance
    band = np.abs(d2 - md2) <= 1e-9 * np.maximum(
        1.0, sq[:, None] + sq[None, :])
    for i, j in zip(*np.nonzero(band)):
        close[i, j] = np.linalg.norm(X[i] - X[j]) < min_dist
    kept_mask = np.zeros(sel_idx.size, dtype=bool)
    for i in range(sel_idx.size):
        kept_mask[i] = not close[i, kept_mask].any()
    return sel_idx[kept_mask]
