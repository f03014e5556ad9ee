"""Batched serving engines.

``ServeEngine`` — LM prefill + decode loop over the model zoo's cache API
(the in-place KV caches, the rwkv6 family's in-place recurrent state,
which ignores the decode index; the encoder-decoder's ``enc_embeds`` and
the vision LM's ``patch_embeds`` ride with the prompt into the prefill).
``generate`` runs greedy (``argmax``) or temperature sampling
(``torch.multinomial`` over ``softmax(logits / T)`` with the engine's own
``torch.Generator``).  The
decode index is a host int, so the loop adds no host sync of its own; the
only syncs are the timers' and the final copy of the tokens.

``CommitteeServer`` — committee serving with batch-level UQ: it scores every request batch through the SAME
``core/acquisition.UQEngine`` the exchange loop uses (one program per
shape bucket: committee forward + ``committee_uq`` statistics + rule
pipeline), returns a ``UQResult`` per batch and — when given an oracle
buffer — routes high-uncertainty requests to labeling through the same
cross-round budget controller (``core/budget.BudgetRule``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import committee as cmte
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import model_zoo

# prefill inputs beside the tokens: the encoder-decoder's frame embeddings
# and the vision LM's patch embeddings
_EXTRA_INPUTS = ("enc_embeds", "patch_embeds")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt+gen)
    prefill_seconds: float
    decode_seconds: float
    steps: int

    @property
    def decode_tokens_per_s(self) -> float:
        if self.decode_seconds == 0:
            return float("inf")
        return self.tokens.shape[0] * self.steps / self.decode_seconds


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Prefill a prompt batch, then decode one token per step.

    ``params`` must already lie on ``device`` (default: the CUDA device;
    raises without it).  The engine keeps ``model.compute_params(params)``:
    the matmul weights cast once to the activation dtype (the bits of the
    model's per-product casts) and the layer stack split into views."""

    def __init__(self, model, params, max_seq: int, batch: int,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        for leaf in cmte.tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"ServeEngine on {self.device} got a "
                                 f"parameter on {leaf.device}")
        self.model = model
        self.params = model.compute_params(params)
        self.max_seq = max_seq
        self.batch = batch
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        cfg = model.cfg
        self._n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
        self._prefill = model_zoo.make_prefill_fn(model)
        self._decode = model_zoo.make_decode_fn(model)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[
            :, 0].to(torch.int32)

    def generate(self, batch_inputs: Dict[str, Any],
                 max_new_tokens: int) -> GenerationResult:
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]),
                                 dtype=torch.int32).to(self.device)
        B, T = tokens.shape
        n_prefix = self._n_prefix
        if n_prefix + T + max_new_tokens - 1 > self.max_seq:
            raise ValueError(f"prompt {T} + {max_new_tokens} new tokens do "
                             f"not fit max_seq={self.max_seq}")
        cache = self.model.init_cache(B, self.max_seq, device=self.device)
        # the encoder's frames and the vision prefix go to the device in
        # the activation dtype once, before the timed prefill
        dt = cm.torch_dtype(self.model.cfg.dtype)
        batch = dict(tokens=tokens, **{
            k: torch.as_tensor(batch_inputs[k]).to(self.device, dt)
            for k in _EXTRA_INPUTS if k in batch_inputs})

        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, batch, cache)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0

        out = [tokens]
        cur = self._sample(logits)[:, None]
        t1 = time.perf_counter()
        for i in range(max_new_tokens):
            out.append(cur)
            if i == max_new_tokens - 1:
                break
            index = n_prefix + T + i
            logits, cache = self._decode(self.params, cur, cache, index)
            cur = self._sample(logits)[:, None]
        _sync(self.device)
        t_decode = time.perf_counter() - t1
        return GenerationResult(
            tokens=torch.cat(out, dim=1).cpu().numpy(),
            prefill_seconds=t_prefill,
            decode_seconds=t_decode,
            steps=max_new_tokens,
        )
