"""The paper's analytic speedup model (SI S2, Eqs. 1–13).

T_serial   = (N/P) * t_oracle + t_train + t_gen                      (Eq. 1)
T_parallel = max((N/P) * t_oracle, t_train, t_gen)                   (Eq. 2)
S          = T_serial / T_parallel                                   (Eq. 3/4)

Regimes validated in tests/benchmarks:
* balanced oracle/train, N >= P:  S -> 1 + P/N  (Eq. 7)
* training-bound:                 S -> 1        (Eq. 10)
* all-balanced, P = N:            S -> 3        (Eq. 13)

The model is a LOWER bound: in PAL the non-bottleneck kernels keep working
(more epochs, more exploration) instead of idling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    t_oracle: float      # time to label one sample
    t_train: float       # one training round
    t_gen: float         # one generation/prediction round (1000 steps in SI)
    n_samples: int       # N: samples labeled per AL iteration
    n_workers: int       # P: parallel oracle workers (P <= N assumed)

    def __post_init__(self):
        if self.n_workers > self.n_samples:
            raise ValueError("model assumes P <= N (paper SI S2.1)")


def t_serial(w: WorkloadParams) -> float:
    return (w.n_samples / w.n_workers) * w.t_oracle + w.t_train + w.t_gen


def t_parallel(w: WorkloadParams) -> float:
    return max((w.n_samples / w.n_workers) * w.t_oracle, w.t_train, w.t_gen)


def speedup(w: WorkloadParams) -> float:
    return t_serial(w) / t_parallel(w)


def bottleneck(w: WorkloadParams) -> str:
    terms = {
        "oracle": (w.n_samples / w.n_workers) * w.t_oracle,
        "train": w.t_train,
        "gen": w.t_gen,
    }
    return max(terms, key=terms.get)


# --------------------------------------------------------------------------
# The three SI use cases
# --------------------------------------------------------------------------

USE_CASES: Dict[str, WorkloadParams] = {
    # Use Case 1: DFT + GNN (t_oracle = t_train = 1 h, t_gen << 1 h), P = N
    "dft_gnn": WorkloadParams(t_oracle=3600.0, t_train=3600.0, t_gen=36.0,
                              n_samples=16, n_workers=16),
    # Use Case 2: xTB oracle (10 s), GNN train 1 h, TS search 10 min
    "xtb_reaction": WorkloadParams(t_oracle=10.0, t_train=3600.0, t_gen=600.0,
                                   n_samples=64, n_workers=16),
    # Use Case 3: CFD — all balanced at 10 min, P = N
    "cfd": WorkloadParams(t_oracle=600.0, t_train=600.0, t_gen=600.0,
                          n_samples=8, n_workers=8),
}


def expected_speedups() -> Dict[str, float]:
    """Closed-form expectations from the paper for the three regimes."""
    uc1 = USE_CASES["dft_gnn"]
    return {
        "dft_gnn": 1.0 + uc1.n_workers / uc1.n_samples,   # Eq. 7 -> 2.0
        "xtb_reaction": 1.0,                               # Eq. 10 (approx)
        "cfd": 3.0,                                        # Eq. 13
    }
