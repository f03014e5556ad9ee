"""Committee serving with batch-level UQ.

``CommitteeServer`` scores every request batch through the SAME
``core/acquisition.UQEngine`` the exchange loop uses (one program per
shape bucket: committee forward + ``committee_uq`` statistics + rule
pipeline), returns a ``UQResult`` per batch and — when given an oracle
buffer — routes high-uncertainty requests to labeling through the same
cross-round budget controller (``core/budget.BudgetRule``).

The LM ``ServeEngine`` comes with the model-zoo slice.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.launch.platform import DeviceLike, resolve_device


class CommitteeServer:
    """Serve a committee ensemble through the unified acquisition engine.

    ``predict(batch) -> (mean, UQResult)``: the committee mean is the
    served answer; the ``UQResult`` (scalar/component std + selection mask)
    is the per-request reliability signal — nothing larger than the small
    UQ arrays ever crosses to the host.

    ``oracle_buffer``: when given, requests the engine's rule pipeline
    selects (``uq.mask``) are queued for labeling — online serving traffic
    becomes acquisition.  ``advance`` controls whether served batches
    advance cross-round rule state: True (default) means serving shares
    the oracle budget with the exchange loop; False makes serving a
    read-only consumer of the current threshold.

    ``device`` (default: the CUDA device; raises without CUDA) must be the
    engine's device: the server refuses to front an engine that runs
    somewhere the caller did not ask for.
    """

    def __init__(self, engine, oracle_buffer=None, *,
                 route_uncertain: bool = True, advance: bool = True,
                 monitor=None, out_dim: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        eng_dev = getattr(engine, "device", None)
        if eng_dev is not None and torch.device(eng_dev) != self.device:
            raise ValueError(f"CommitteeServer on {self.device} cannot serve "
                             f"an engine on {eng_dev}")
        self.engine = engine
        self.oracle_buffer = oracle_buffer
        self.route_uncertain = route_uncertain
        self.advance = advance
        self.monitor = monitor
        self.requests = 0
        self.routed = 0
        # output width for EMPTY results: the committee's width is only
        # observable from a scored batch, so before any non-empty traffic
        # an empty predict returns (0, out_dim) with this seed
        self._out_dim = int(out_dim)

    def weights_generation(self) -> Tuple[int, ...]:
        """Identity of the weights currently answering requests: the
        engine's store version plus its ``refresh_from_device`` count.
        Moves exactly when a weight refresh lands — the answer cache drops
        everything the moment it changes."""
        eng = self.engine
        return (int(getattr(eng, "version", 0)),
                int(getattr(eng, "device_refreshes", 0)))

    def predict(self, batch_inputs: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, Any]:
        """Score one request batch of input rows.  Returns
        ``(mean, UQResult)``.

        An empty batch short-circuits to an empty result — no engine
        dispatch, no request/routing counters, and no budget-controller
        round.  The empty mean keeps the 2-D (0, d) shape, with d from the
        last non-empty batch (or the ``out_dim`` constructor seed)."""
        rows = [np.asarray(r) for r in batch_inputs]
        if not rows:
            zf = np.zeros(0, np.float32)
            mean = np.zeros((0, self._out_dim), np.float32)
            return mean, acq.UQResult(mean, zf, zf.copy(),
                                      np.zeros(0, bool),
                                      np.zeros(0, np.int32))
        uq = self.engine.score(rows, advance=self.advance,
                               stream=acq.STREAM_SERVE)
        self._out_dim = int(uq.mean.shape[-1])
        self.requests += len(rows)
        if self.monitor is not None:
            self.monitor.incr("serve.requests", len(rows))
        if (self.oracle_buffer is not None and self.route_uncertain
                and uq.mask.any()):
            picked = [rows[int(i)] for i in np.where(uq.mask)[0]]
            self.oracle_buffer.put(picked)
            self.routed += len(picked)
            if self.monitor is not None:
                self.monitor.incr("serve.routed_to_oracle", len(picked))
        return uq.mean, uq

