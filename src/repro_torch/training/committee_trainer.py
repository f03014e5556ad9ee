"""Fused committee training: ALL K members advance in ONE step program.

The reference's ``repro/training/committee_trainer.py`` in torch.  The
paper's training kernel retrains every committee member in parallel (one
MPI rank per member); here the whole committee is one program:

  * per-member ``TrainState`` (params + AdamW moments + step) stacked on a
    leading committee axis, built from the same stacked ``cparams`` the
    acquisition engine scores;
  * ``training/train_step.make_train_step`` mapped over that axis with
    ``torch.func.vmap``: one program advances all K members, each on its
    OWN minibatch (``bootstrap=False`` gives every member the same one);
  * minibatches are gathered ON THE DEVICE from a
    ``data/replay.ReplayTrainingBuffer`` ring — a train step moves no
    training bytes across the host boundary;
  * a per-member quarantine in the same program: a member whose loss or
    any updated param is non-finite keeps its old params, moments AND step;
  * refreshed weights hand off device to device:
    ``FusedEngine.refresh_from_device(trainer.snapshot_cparams())``.

On the card the step program is ONE CUDA graph per trainer, captured at
the first ``train()`` (after a warm-up of its pure part on the trainer's
stream; a failed capture raises) and replayed once per step — the
counterpart of the reference's one ``jax.jit``.  The graph reads and
writes the trainer's own buffers (the stacked state, the ring, the ring's
device row count and a device step counter), so those are never rebound:
``load_state_dict``, ``poison_member`` and ``add_blocks`` write into them
in place, on the trainer's stream, under the state lock.  Nothing is read
on the host inside a round; the last step's metrics come to the host once,
at the round's end.  ``capture=False`` runs the same program eagerly on the
card (comparisons); the CPU always runs it eagerly.

The minibatch draw is a counter-based integer hash of (seed, step counter,
member, position) reduced modulo the ring's row count, in int64 tensor ops
that cannot overflow: the same indices on every device, capturable, and
replayable on the host (``minibatch_indices``) — JAX's threefry draws are
not reproduced.

Per-member storage is a POLICY (``optim/memory_policy.MemoryPolicy`` or a
preset name): the AdamW moment format (fp32 | bf16 | int8 ``QTensor``),
the stacked-param dtype and the ring's row dtype.  Quantize/dequantize run
inside the one program; update math is fp32 under every policy.
``state_dict`` snapshots the full TrainState (int8 moments natively, bf16
leaves as ``BF16Bits``), the step counter and the ring; restoring a
snapshot in another storage format raises.  ``state_dict_from_reference``
turns the JAX trainer's snapshot into this one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from repro_torch.checkpoint.pytree_ckpt import (
    BF16Bits, leaf_from_host, leaf_to_host,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.committee import committee_size, member
from repro_torch.data.replay import ReplayTrainingBuffer
from repro_torch.launch import platform
from repro_torch.launch.platform import DeviceLike, resolve_device
from repro_torch.models.common import torch_dtype
from repro_torch.optim.adamw import AdamWState, QTensor, resolve_moments
from repro_torch.optim.memory_policy import MemoryPolicy, resolve_policy
from repro_torch.training.train_step import (
    TrainState, make_train_state, make_train_step,
)

log = logging.getLogger(__name__)


def default_train_config(lr: float) -> TrainConfig:
    """The committee-retrain optimizer defaults: constant-LR AdamW without
    warmup (retraining resumes continuously; a re-warmup every round would
    stall the member right when fresh labels arrive)."""
    return TrainConfig(learning_rate=lr, schedule="constant",
                       warmup_steps=0, weight_decay=0.0)


# ---------------------------------------------------------------------------
# The minibatch draw: a counter-based hash, the same on every device
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x7FEB352D, 0x6C8E9CF5      # odd, below 2**31


def _mix32(h):
    """A 32-bit xorshift-multiply finalizer, on int64 tensors or Python
    ints: each product is a value below 2**32 times a constant below 2**31,
    so nothing overflows int64; the masks keep 32 bits."""
    h = h ^ (h >> 16)
    h = (h * _MIX1) & _M32
    h = h ^ (h >> 15)
    h = (h * _MIX2) & _M32
    return h ^ (h >> 16)


def draw_indices(seed: int, step_seq: torch.Tensor, size: torch.Tensor,
                 k: int, batch: int, bootstrap: bool) -> torch.Tensor:
    """(k, batch) int64 row indices in ``[0, max(size, 1))`` for the step
    ``step_seq`` (a 0-d integer tensor): a hash of (seed, step_seq, member,
    position).  ``bootstrap=False`` tiles member 0's draw to every member."""
    dev = step_seq.device
    base = _mix32((int(seed) & _M32) ^ 0x9E3779B9)
    h = _mix32((step_seq.to(torch.int64) & _M32) ^ base)
    members = torch.arange(k if bootstrap else 1, dtype=torch.int64,
                           device=dev)
    h = _mix32(h ^ members)[:, None]
    h = _mix32(h ^ torch.arange(batch, dtype=torch.int64, device=dev))
    idx = h % size.to(torch.int64).clamp(min=1)
    return idx if bootstrap else idx.repeat(k, 1)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------


class _Mismatch(Exception):
    pass


def _is_qtensor(t) -> bool:
    return all(hasattr(t, a) for a in ("q", "scale", "block", "axis"))


def _is_bf16(a) -> bool:
    if isinstance(a, BF16Bits):
        return True
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.bfloat16
    return np.asarray(a).dtype.name == "bfloat16"


def _host_leaves(tree) -> list:
    """Leaves of a host snapshot tree, whole QTensor moments included."""
    if _is_qtensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _host_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _host_leaves(t)]
    return [tree]


def _restore_like(live, snap, device):
    """``snap`` (host leaves) as tensors on ``device`` in the structure of
    ``live``; raises ``_Mismatch`` on another structure, shape or dtype."""
    if isinstance(live, QTensor):
        if not _is_qtensor(snap) or (int(snap.block), int(snap.axis)) != (
                live.block, live.axis):
            raise _Mismatch("quantized moment layout")
        return QTensor(_restore_like(live.q, snap.q, device),
                       _restore_like(live.scale, snap.scale, device),
                       live.block, live.axis)
    if isinstance(live, dict):
        if not isinstance(snap, dict) or set(snap) != set(live):
            raise _Mismatch("keys")
        return {k: _restore_like(live[k], snap[k], device) for k in live}
    if isinstance(live, (list, tuple)):
        if (not isinstance(snap, (list, tuple)) or _is_qtensor(snap)
                or len(snap) != len(live)):
            raise _Mismatch("sequence")
        vals = [_restore_like(a, b, device) for a, b in zip(live, snap)]
        return type(live)(*vals) if hasattr(live, "_fields") \
            else type(live)(vals)
    if isinstance(snap, (dict, list, tuple)) or _is_qtensor(snap):
        raise _Mismatch("leaf")
    t = leaf_from_host(snap, device)
    if tuple(t.shape) != tuple(live.shape) or t.dtype != live.dtype:
        raise _Mismatch(f"leaf {tuple(t.shape)} {t.dtype} vs "
                        f"{tuple(live.shape)} {live.dtype}")
    return t


def state_dict_from_reference(state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``CommitteeTrainer.state_dict()`` (numpy leaves; QTensor
    moments with ``q``/``scale``/``block``/``axis``; ml_dtypes bfloat16
    leaves) -> this trainer's snapshot: the same keys, the port's
    ``TrainState``/``AdamWState``/``QTensor``, bf16 leaves as ``BF16Bits``
    (read through a uint16 view).  ``load_state_dict`` then continues the
    reference run mid-schedule."""
    def leaf(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return BF16Bits(arr.view(np.uint16).copy())
        return np.array(arr, copy=True)

    def tree(t):
        if _is_qtensor(t):
            return QTensor(leaf(t.q), leaf(t.scale), int(t.block),
                           int(t.axis))
        if isinstance(t, dict):
            return {k: tree(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(tree(x) for x in t)
        return leaf(t)

    cs = state["cstate"]
    out: Dict[str, Any] = {"cstate": TrainState(
        step=leaf(cs.step), params=tree(cs.params),
        opt=AdamWState(step=leaf(cs.opt.step), mu=tree(cs.opt.mu),
                       nu=tree(cs.opt.nu)))}
    if state.get("memory_policy") is not None:
        out["memory_policy"] = dict(state["memory_policy"])
    for k in ("step_seq", "steps_done", "rounds"):
        if k in state:
            out[k] = int(state[k])
    replay = dict(state.get("replay", {}))
    for k in ("x", "y"):
        if k in replay:
            replay[k] = leaf(replay[k])
    out["replay"] = replay
    return out


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


class CommitteeTrainer:
    """One-program K-member retraining on a device-resident replay ring.

    ``loss_fn(params, batch) -> (loss, aux_dict)`` is a SINGLE member's
    loss over a minibatch ``{"x": (B, dx), "y": (B, dy)}`` — the signature
    ``make_train_step`` consumes; the trainer vmaps it over the committee
    axis.  ``cparams`` is the stacked committee
    (``committee.stack_members``), copied to ``device`` (default: the CUDA
    device; raises without CUDA).

    Counters: ``captures`` (graphs captured; 1 per trainer unless a
    restored ring of another shape forces a new one), ``graph_replays``
    (one per step on the card), ``steps_done``, ``rounds``.
    """

    def __init__(
        self,
        loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                          Tuple[torch.Tensor, Dict]],
        cparams: Any,
        *,
        steps: int = 200,
        batch: int = 32,
        lr: float = 1e-3,
        bootstrap: bool = True,
        replay_capacity: int = 2048,
        train_cfg: Optional[TrainConfig] = None,
        mesh=None,
        sharding_rules=None,
        seed: int = 0,
        monitor=None,
        memory_policy: Union[str, MemoryPolicy, None] = None,
        device: DeviceLike = None,
        capture: bool = True,
    ):
        if mesh is not None or sharding_rules is not None:
            raise NotImplementedError(
                "the mesh-sharded committee trainer comes with the "
                "multi-device slice (ROADMAP §A: multi-device)")
        self.device = resolve_device(device)
        self.size = committee_size(cparams)
        self.steps = int(steps)
        self.batch = int(batch)
        self.bootstrap = bool(bootstrap)
        self.seed = int(seed)
        self.monitor = monitor
        tcfg = train_cfg if train_cfg is not None else default_train_config(lr)
        policy = resolve_policy(memory_policy)
        if policy is None:
            # legacy path: derive the effective policy from TrainConfig so
            # snapshots always carry storage metadata, but leave tcfg alone
            fmt = resolve_moments(getattr(tcfg, "opt_moments", ""),
                                  tcfg.quantized_opt_state)
            policy = MemoryPolicy(name=fmt, moments=fmt)
        else:
            tcfg = dataclasses.replace(
                tcfg, opt_moments=policy.moments,
                quantized_opt_state=(policy.moments == "int8"))
        self.policy = policy
        self.replay = ReplayTrainingBuffer(replay_capacity,
                                           dtype=policy.replay_dtype,
                                           device=self.device)
        self._member_step = make_train_step(loss_fn, tcfg)
        self._vstep = vmap(self._member_step)
        pd = torch_dtype(policy.params_dtype)

        def own(a):
            t = leaf_from_host(a, self.device)
            return t.to(pd) if t.is_floating_point() else t

        cparams = pytree.tree_map(own, cparams)
        # stacked TrainState: every leaf (step, params, mu, nu) grows a
        # leading K axis
        states = [make_train_state(member(cparams, i), tcfg)
                  for i in range(self.size)]
        self.cstate = pytree.tree_map(lambda *xs: torch.stack(xs), *states)
        self._seq_dev = torch.zeros((), dtype=torch.int64,
                                    device=self.device)

        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.replay.stream = self._stream
        if cuda:        # the buffers were filled on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.capture = bool(capture) and cuda
        self._graph = None
        self._graph_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._graph_ring = -1
        self.captures = 0
        self.graph_replays = 0

        self._step_seq = 0              # host mirror of the step counter
        self.steps_done = 0
        self.rounds = 0
        # (K,) bool verdict of the last trained round's final step: False
        # entries are members whose step was rolled back
        self.last_member_ok: Optional[np.ndarray] = None
        # round lock: serializes whole train() rounds; state lock: guards
        # every write into the trainer's buffers at step granularity
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------- program
    def _body(self, cstate, x, y, size, step_seq):
        """The pure part of a step: draw, gather, the vmapped member step
        and the quarantine.  Returns (new_state, metrics); writes nothing."""
        idx = draw_indices(self.seed, step_seq, size, self.size, self.batch,
                           self.bootstrap)                       # (K, B)
        # gathered and cast to fp32 on the device: a bf16 ring never leaks
        # its storage dtype into the loss math
        mb = {"x": x[idx].to(torch.float32), "y": y[idx].to(torch.float32)}
        new_state, metrics = self._vstep(cstate, mb)
        # per-member quarantine: a non-finite loss or any non-finite
        # updated param rolls the member back to its pre-step params,
        # moments AND step, inside the same program
        ok = torch.isfinite(metrics["loss"])
        for leaf in pytree.tree_leaves(new_state.params):
            ok = ok & torch.isfinite(leaf).reshape(self.size, -1).all(dim=1)

        def keep(new, old):
            return torch.where(ok.reshape((-1,) + (1,) * (new.ndim - 1)),
                               new, old)

        rolled = pytree.tree_map(keep, new_state, cstate)
        metrics = dict(metrics)
        metrics["member_ok"] = ok
        return rolled, metrics

    def _program(self) -> Dict[str, torch.Tensor]:
        """One step: the body, the new state copied into the trainer's
        buffers, the device step counter advanced.  Reads nothing on the
        host, so the card captures it as it stands."""
        new_state, metrics = self._body(self.cstate, self.replay.x,
                                        self.replay.y, self.replay.size_dev,
                                        self._seq_dev)
        torch._foreach_copy_(pytree.tree_leaves(self.cstate),
                             pytree.tree_leaves(new_state))
        self._seq_dev.add_(1)
        return metrics

    def _capture(self) -> None:
        """Warm up the pure body twice (kernel and cuBLAS initialisation
        may not happen under capture), then capture the step program, on
        the trainer's stream (current here), under the process-wide
        capture lock (an engine in another thread may be capturing)."""
        with platform.capture_lock:
            for _ in range(2):
                self._body(self.cstate, self.replay.x, self.replay.y,
                           self.replay.size_dev, self._seq_dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                metrics = self._program()
        self._graph, self._graph_metrics = graph, metrics
        self._graph_ring = self.replay.generation
        self.captures += 1

    def _step(self) -> Dict[str, torch.Tensor]:
        """Run one step (caller holds the state lock)."""
        if self._stream is None:                       # the CPU: eagerly
            return self._program()
        with torch.cuda.stream(self._stream):
            if not self.capture:
                return self._program()
            if self._graph is None \
                    or self._graph_ring != self.replay.generation:
                self._capture()
            self._graph.replay()
            self.graph_replays += 1
            return self._graph_metrics

    # ---------------------------------------------------------------- data
    def add_blocks(self, datapoints: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Absorb a Manager-released block of (input, label) pairs into the
        device replay ring (one copy; two where it wraps), on the trainer's
        stream under the state lock: safe concurrently with a round."""
        if not datapoints:
            return
        xs = [np.asarray(x, np.float32).reshape(-1) for x, _ in datapoints]
        ys = [np.asarray(y, np.float32).reshape(-1) for _, y in datapoints]
        with self._state_lock:
            self.replay.append(np.stack(xs), np.stack(ys))

    def minibatch_indices(self, step_seq: int, size: int) -> np.ndarray:
        """The (K, B) indices step ``step_seq`` draws over ``size`` rows —
        the exact computation the step program runs, on the host."""
        return draw_indices(
            self.seed, torch.tensor(int(step_seq), dtype=torch.int64),
            torch.tensor(int(size), dtype=torch.int32), self.size,
            self.batch, self.bootstrap).numpy()

    # --------------------------------------------------------------- train
    def train(self, interrupt=None, steps: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        """Advance all K members ``steps`` fused steps (default: the
        configured per-round budget).  ``interrupt`` is the transport
        Request of the NEXT pending data block — training yields early the
        moment new labels arrive.  Returns the last step's per-member
        metrics (host numpy), read once at the round's end."""
        n_steps = self.steps if steps is None else int(steps)
        with self._lock:
            if len(self.replay) == 0 or n_steps <= 0:
                return {}
            metrics, done = None, 0
            # a graph captured in inference mode computes no gradients
            with torch.inference_mode(False):
                for _ in range(n_steps):
                    with self._state_lock:
                        metrics = self._step()
                        self._step_seq += 1
                        self.steps_done += 1
                    done += 1
                    if interrupt is not None and interrupt.test():
                        break
            with self._state_lock, self._on_stream():
                out = {k: leaf_to_host(v) for k, v in metrics.items()}
            self.rounds += 1
            if self.monitor is not None:
                self.monitor.incr("train.fused_steps", done)
        ok = out.get("member_ok")
        if ok is not None:
            self.last_member_ok = np.asarray(ok, bool)
            bad = int((~self.last_member_ok).sum())
            if bad and self.monitor is not None:
                self.monitor.incr("train.member_rollbacks", bad)
        return out

    # ------------------------------------------------------------- weights
    @property
    def cparams(self) -> Any:
        """The live stacked committee params (the trainer's buffers)."""
        return self.cstate.params

    def snapshot_cparams(self) -> Any:
        """A device copy of the stacked params for the handoff to the
        acquisition engine.  On the card the copy is made on the CALLER's
        current stream after every step enqueued so far, and the next step
        waits for it; ``FusedEngine.refresh_from_device`` orders its own
        copy after the caller's stream, so the engine sees these weights.
        Nothing touches the host."""
        with self._state_lock:
            if self._stream is None:
                return pytree.tree_map(torch.clone, self.cstate.params)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._stream)
            snap = pytree.tree_map(torch.clone, self.cstate.params)
            self._stream.wait_stream(cur)
            return snap

    def poison_member(self, i: int):
        """Chaos/test hook: overwrite member ``i``'s parameters with NaN —
        the observable signature of a diverged member.  The step's
        quarantine then rolls back every later update of that member, and
        the acquisition kernel's degraded-K statistics exclude it once the
        poisoned weights publish."""
        if not 0 <= int(i) < self.size:
            raise ValueError(f"member index {i} out of range 0..{self.size - 1}")
        with self._state_lock, self._on_stream():
            for leaf in pytree.tree_leaves(self.cstate.params):
                if leaf.is_floating_point():
                    leaf[int(i)].fill_(float("nan"))
        if self.monitor is not None:
            self.monitor.incr("train.members_poisoned")

    # ---------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Any]:
        """FULL training snapshot: TrainState (params + AdamW mu/nu + step;
        QTensor moments as their int8 ``q`` and fp32 ``scale``, bf16 leaves
        as ``BF16Bits``), the step counter and the replay ring, taken under
        the state lock after the steps enqueued so far."""
        with self._state_lock, self._on_stream():
            return {
                "cstate": pytree.tree_map(leaf_to_host, self.cstate),
                "memory_policy": dataclasses.asdict(self.policy),
                "step_seq": self._step_seq,
                "steps_done": self.steps_done,
                "rounds": self.rounds,
                "replay": self.replay.state_dict(),
            }

    @staticmethod
    def _snapshot_formats(cstate) -> Optional[Dict[str, str]]:
        """Infer {moments, params_dtype} from a snapshot's leaves (legacy
        snapshots carry no policy metadata); None if the structure is too
        foreign to inspect."""
        try:
            mu, params = cstate.opt.mu, cstate.params
        except AttributeError:
            return None
        mu_leaves = _host_leaves(mu)
        if any(_is_qtensor(l) for l in mu_leaves):
            moments = "int8"
        elif any(_is_bf16(l) for l in mu_leaves):
            moments = "bf16"
        else:
            moments = "fp32"
        params_dtype = ("bfloat16" if any(_is_bf16(l) for l in
                                          _host_leaves(params))
                        else "float32")
        return {"moments": moments, "params_dtype": params_dtype}

    def load_state_dict(self, state: Dict[str, Any]):
        """Restore a ``state_dict`` snapshot into the trainer's buffers if
        it structurally matches the current committee; mismatches
        (different K, param shapes, optimizer layout) are skipped with a
        warning.  A MEMORY-POLICY mismatch raises ``ValueError``: the
        snapshot is valid data in another storage format, and silently
        re-formatting it would corrupt the run."""
        snap = state["cstate"]
        snap_policy = state.get("memory_policy")
        if snap_policy is None:
            snap_policy = self._snapshot_formats(snap)
        if snap_policy is not None:
            mine = {"moments": self.policy.moments,
                    "params_dtype": self.policy.params_dtype}
            bad = {k: (snap_policy[k], mine[k]) for k in mine
                   if k in snap_policy and snap_policy[k] != mine[k]}
            if bad:
                raise ValueError(
                    "committee-trainer snapshot memory policy does not "
                    "match the configured policy — refusing to silently "
                    "re-format optimizer state: "
                    + ", ".join(f"{k}: snapshot={s!r} vs config={c!r}"
                                for k, (s, c) in sorted(bad.items()))
                    + ". Restore with a matching memory_policy (or retrain "
                    "from scratch).")
        with self._state_lock, self._on_stream():
            try:
                restored = _restore_like(self.cstate, snap, self.device)
            except _Mismatch as e:
                log.warning(
                    "committee-trainer snapshot does not match the current "
                    "committee (%s) — skipping restore, training state "
                    "starts fresh", e)
                return
            torch._foreach_copy_(pytree.tree_leaves(self.cstate),
                                 pytree.tree_leaves(restored))
            self._step_seq = int(state.get("step_seq", 0))
            self._seq_dev.fill_(self._step_seq)
            self.steps_done = int(state.get("steps_done", 0))
            self.rounds = int(state.get("rounds", 0))
            self.replay.load_state_dict(state.get("replay", {}))
