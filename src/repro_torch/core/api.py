"""User-kernel interfaces — faithful to the paper's S4–S7 method surface.

Users implement these four classes (prediction+training share ``UserModel``
with a ``mode`` flag, exactly as in the paper) plus the two utils functions
(see core/selection.py defaults).  The controller/runtime only ever calls
the methods below, so any paper-style kernel drops in unchanged.
"""
from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.transport import Request


class UserModel(abc.ABC):
    """Prediction (mode='predict') / Training (mode='train') kernel (S4/S5)."""

    def __init__(self, rank: int, result_dir: str, i_device: int, mode: str):
        self.rank = rank
        self.result_dir = result_dir
        self.i_device = i_device
        self.mode = mode

    # ---- prediction side ---------------------------------------------------
    def predict(self, list_data_to_pred: Sequence[np.ndarray]
                ) -> List[np.ndarray]:
        """Inputs gathered from all generators -> predictions per generator."""
        raise NotImplementedError

    def update(self, weight_array: np.ndarray) -> None:
        """Install packed 1-D weights published by the training kernel."""
        raise NotImplementedError

    def get_weight_size(self) -> int:
        raise NotImplementedError

    # ---- training side -----------------------------------------------------
    def get_weight(self) -> np.ndarray:
        raise NotImplementedError

    def add_trainingset(self, datapoints: Sequence[Tuple[np.ndarray,
                                                         np.ndarray]]) -> None:
        raise NotImplementedError

    def retrain(self, req_data: Request) -> bool:
        """Train until new data arrives (req_data.test()) or early stop.
        Returns stop_run: True shuts the whole PAL workflow down."""
        raise NotImplementedError

    def save_progress(self) -> None:
        pass

    def stop_run(self) -> None:
        pass


class UserGene(abc.ABC):
    """Generator kernel (S6)."""

    def __init__(self, rank: int, result_dir: str):
        self.rank = rank
        self.result_dir = result_dir

    @abc.abstractmethod
    def generate_new_data(self, data_to_gene: Optional[np.ndarray]
                          ) -> Tuple[bool, np.ndarray]:
        """data_to_gene: predictions from the controller (None on the first
        iteration).  Returns (stop_run, data_to_pred)."""

    def save_progress(self) -> None:
        pass

    def stop_run(self) -> None:
        pass


class UserOracle(abc.ABC):
    """Oracle kernel (S7)."""

    def __init__(self, rank: int, result_dir: str):
        self.rank = rank
        self.result_dir = result_dir

    @abc.abstractmethod
    def run_calc(self, input_for_orcl: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (input_for_orcl, orcl_calc_res) — echoing the input back
        with the label, as the paper's controller expects."""

    def stop_run(self) -> None:
        pass
