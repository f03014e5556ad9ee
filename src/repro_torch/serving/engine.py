"""Batched serving engines.

``ServeEngine`` — LM prefill + decode loop over the model zoo's cache API
(the in-place KV caches, the rwkv6 family's in-place recurrent state,
which ignores the decode index; the encoder-decoder's ``enc_embeds`` and
the vision LM's ``patch_embeds`` ride with the prompt into the prefill).
``generate`` runs greedy (``argmax``) or temperature sampling
(``torch.multinomial`` over ``softmax(logits / T)`` with the engine's own
``torch.Generator``).  As the reference jits its prefill and its decode
step, the engine runs each as one program over static buffers: on the
card one CUDA graph per prefill shape and one per batch size for the
decode step, replayed; on the CPU the same programs run eagerly.  The
decode position lives on the device and the decode graph advances it, so
the decode loop makes no host sync; the only syncs are the timers' and
the final copy of the tokens.

``CommitteeServer`` — committee serving with batch-level UQ: it scores every request batch through the SAME
``core/acquisition.UQEngine`` the exchange loop uses (one program per
shape bucket: committee forward + ``committee_uq`` statistics + rule
pipeline), returns a ``UQResult`` per batch and — when given an oracle
buffer — routes high-uncertainty requests to labeling through the same
cross-round budget controller (``core/budget.BudgetRule``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import committee as cmte
from repro_torch.kernels import graphs
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


@dataclasses.dataclass
class _Prefill:
    """One prefill shape of a batch: its input buffers and its graph."""
    inputs: Dict[str, torch.Tensor]
    graph: Optional[graphs.CapturedProgram] = None


@dataclasses.dataclass
class _Slot:
    """The engine's static buffers for one batch size B: the cache, the
    next token (B, 1), the decode position (0-dim int32) and every token
    sampled so far, by position (B, max_seq + 1); the prefill shapes seen
    and the decode graph."""
    cache: Dict[str, torch.Tensor]
    cur: torch.Tensor
    index: torch.Tensor
    seq: torch.Tensor
    prefills: Dict[Any, _Prefill] = dataclasses.field(default_factory=dict)
    decode: Optional[graphs.CapturedProgram] = None


class ServeEngine:
    """Prefill a prompt batch, then decode one token per step.

    ``params`` must already lie on ``device`` (default: the CUDA device;
    raises without it).  The engine keeps ``model.compute_params(params)``:
    the matmul weights cast once to the activation dtype (the bits of the
    model's per-product casts) and the layer stack split into views.

    For each batch size the engine owns a cache and the token and position
    buffers; every ``generate`` starts its prefill by zeroing the cache
    (what the reference's ``init_cache`` gives).  The prefill program
    fills the cache and samples the first token; the decode program takes
    the token at the device-resident position, samples the next one, and
    advances the position.  On the card each program is captured once, on
    the engine's own stream, after two warm-up runs (``kernels.graphs``):
    a prefill graph per (B, input shapes), a decode graph per B, all in
    one memory pool (they never run at once), before the timed work; a
    capture that fails raises.  Greedy sampling runs inside the graphs;
    temperature sampling runs between the replays with the engine's
    generator, so its draws are those of the eager loop.  Counters:
    ``captures`` (graphs captured) and ``replays``."""

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
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._slots: Dict[int, _Slot] = {}
        self.captures = 0
        self.replays = 0

    def _greedy(self) -> bool:
        return self.temperature <= 0.0

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self._greedy():
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[
            :, 0].to(torch.int32)

    # ------------------------------------------------------------ programs
    def _slot(self, B: int) -> _Slot:
        slot = self._slots.get(B)
        if slot is None:
            dev = self.device
            slot = self._slots[B] = _Slot(
                cache=self.model.init_cache(B, self.max_seq, device=dev),
                cur=torch.zeros((B, 1), dtype=torch.int32, device=dev),
                index=torch.zeros((), dtype=torch.int32, device=dev),
                seq=torch.zeros((B, self.max_seq + 1), dtype=torch.int32,
                                device=dev))
        return slot

    def _emit(self, slot: _Slot, logits: torch.Tensor) -> None:
        """Sample the token at the current position: the next input and
        its column of ``seq``."""
        tok = self._sample(logits)[:, None]
        slot.cur.copy_(tok)
        slot.seq.index_copy_(1, slot.index.reshape(1).to(torch.int64), tok)

    def _prefill_program(self, slot: _Slot, inputs, start: int):
        for t in slot.cache.values():
            t.zero_()
        logits, _ = self._prefill(self.params, inputs, slot.cache)
        slot.index.fill_(start)
        if self._greedy():
            self._emit(slot, logits)
        return logits

    def _decode_program(self, slot: _Slot):
        logits, _ = self._decode(self.params, slot.cur, slot.cache,
                                 slot.index)
        slot.index.add_(1)
        if self._greedy():
            self._emit(slot, logits)
        return logits

    def _sync(self) -> None:
        """Wait for the engine's stream (its graphs and copies run there)."""
        if self._stream is not None:
            self._stream.synchronize()

    def _run(self, graph, program) -> torch.Tensor:
        """One program: a replay of its graph on the card, else eagerly.
        Returns its logits."""
        if graph is not None:
            logits = graph.replay()
            self.replays += 1
        else:
            logits = program()
        return logits

    def _capture(self, fn, warmup=None) -> graphs.CapturedProgram:
        graph = graphs.CapturedProgram(fn, self._stream, pool=self._pool,
                                       warmup=warmup)
        self.captures += 1
        return graph

    def _ensure_graphs(self, slot: _Slot, entry: _Prefill, start: int,
                       decode: bool) -> None:
        """Capture the prefill graph of ``entry`` and (``decode``) the
        decode graph of ``slot`` if not yet captured.  The decode warm-ups
        run from a filled cache, each at the first decode position."""
        if entry.graph is None:
            entry.graph = self._capture(
                lambda: self._prefill_program(slot, entry.inputs, start))
        if decode and slot.decode is None:
            entry.graph.replay()

            def warmup():
                slot.index.fill_(start)
                self._decode_program(slot)

            slot.decode = self._capture(
                lambda: self._decode_program(slot), warmup=warmup)

    def generate(self, batch_inputs: Dict[str, Any],
                 max_new_tokens: int) -> GenerationResult:
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]),
                                 dtype=torch.int32)
        B, T = tokens.shape
        n_prefix = self._n_prefix
        start = n_prefix + T              # the first new token's position
        # positions the run takes: the cache's rows and the tokens' columns
        # (the device index is never range-checked, so check them here)
        n_pos = start + max(max_new_tokens, 1) - 1
        if n_pos > self.max_seq:
            raise ValueError(f"prompt {T} + {max_new_tokens} new tokens do "
                             f"not fit max_seq={self.max_seq}")
        table = self.params.get("dec_pos")       # Whisper's learned ones
        if table is not None and n_pos > table.shape[0]:
            raise ValueError(f"decoder positions up to {n_pos - 1} past "
                             f"dec_pos ({table.shape[0]} rows, the max_seq "
                             f"the model was built with)")
        # the encoder's frames and the vision prefix go to the device in
        # the activation dtype, as the tokens do, before the timed prefill
        dt = cm.torch_dtype(self.model.cfg.dtype)
        host = dict(tokens=tokens, **{
            k: torch.as_tensor(batch_inputs[k]).to(dt)
            for k in _EXTRA_INPUTS if k in batch_inputs})
        slot = self._slot(B)
        key = tuple((k, tuple(v.shape)) for k, v in host.items())
        entry = slot.prefills.get(key)
        if entry is None:
            entry = slot.prefills[key] = _Prefill({
                k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in host.items()})
        cuda = self._stream is not None
        if cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(self._stream) if cuda
              else contextlib.nullcontext()):
            for k, v in host.items():
                entry.inputs[k].copy_(v)
            if cuda:
                self._ensure_graphs(slot, entry, start, max_new_tokens > 1)
            greedy = self._greedy()

            self._sync()
            t0 = time.perf_counter()
            logits = self._run(entry.graph, lambda: self._prefill_program(
                slot, entry.inputs, start))
            if not greedy:
                self._emit(slot, logits)
            self._sync()
            t_prefill = time.perf_counter() - t0

            t1 = time.perf_counter()
            for _ in range(max_new_tokens - 1):
                logits = self._run(slot.decode,
                                   lambda: self._decode_program(slot))
                if not greedy:
                    self._emit(slot, logits)
            self._sync()
            t_decode = time.perf_counter() - t1
            new = slot.seq[:, start:start + max_new_tokens].cpu()
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return GenerationResult(
            tokens=torch.cat([tokens, new], dim=1).numpy(),
            prefill_seconds=t_prefill,
            decode_seconds=t_decode,
            steps=max_new_tokens,
        )
