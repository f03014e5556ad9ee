"""Device-resident acquisition engine — ONE UQ path from the exchange loop
and the serving path to the oracle buffer.

  * ``UQResult``  — everything the controller ever needs from a committee
    evaluation: mean, scalar (max-over-components) std, mean-over-components
    std, the final selection mask and the finite-member count.  Nothing
    larger ever crosses to the host.
  * ``UQEngine``  — the one interface: ``score(inputs) -> UQResult``.
  * ``FusedEngine`` — the vmapped committee forward, the ``committee_uq``
    statistics (the hand-written CUDA kernel on the card, its plain PyTorch
    version on the CPU) and the selection-rule pipeline, run as ONE program
    per power-of-two shape bucket on the engine's device: on the card one
    captured CUDA graph per bucket, replayed; on the CPU the same program
    body, run eagerly.  Per call the host uploads the padded batch and the
    two run-time scalars in one copy and downloads the five small outputs,
    packed by the kernel, in one copy.
  * Rules        — composable selection logic (``ThresholdRule``,
    ``TopFractionRule``, ``DiversityRule``) in tensor ops on the engine's
    device.  Rules may be STATEFUL (``stateful = True`` + ``init_state`` /
    ``apply_stateful``): their small carried state stays on the device
    across rounds — ``core/budget.py`` builds the cross-round oracle-rate
    controller (``BudgetRule``) and the rolling re-weighting rule
    (``RollingReweightRule``) on this protocol.
  * ``LegacyEngine`` — the per-member backend for arbitrary ``UserModel``
    kernels: K ``predict`` calls, float64 host statistics, then the SAME
    rule objects run eagerly on CPU tensors.
  * ``make_engine`` — config-driven factory (``PALRunConfig`` knobs).

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP item
that brings it): ``score_after`` (the exploration fleet) and the mesh path
(multi-device).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.committee import (
    committee_size, make_committee_apply, shape_bucket, stack_members,
    tree_leaves, tree_map, tree_paths, update,
)
from repro_torch.kernels import committee_uq as cuq_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import platform
from repro_torch.launch.platform import DeviceLike, resolve_device

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Results and statistics
# ---------------------------------------------------------------------------

# Scoring-stream tags: every ``UQEngine.score`` round is attributed to the
# traffic stream that produced it — the exchange hot loop or the serving
# path.  Stream-aware rules (``core/budget.BudgetRule`` with a distinct
# ``target_serve``) meter both streams through one program per bucket.
STREAM_EXCHANGE = 0
STREAM_SERVE = 1


def _f32(x: float) -> float:
    """``x`` rounded to float32 (exactly representable as a Python float):
    comparing an fp32 tensor against it decides as the reference's fp32
    compare does."""
    return float(np.float32(x))


@dataclasses.dataclass
class UQResult:
    """Host-side outcome of one committee scoring round (numpy arrays over
    the true n inputs scored).

    ``scalar_std``    max over output components of the ddof=1 committee std
                      — the quantity the paper's ``prediction_check``
                      thresholds.
    ``component_std`` mean over output components of the same std — the
                      ranking score of ``adjust_input_for_oracle``.
    ``mask``          final selection decision after the rule pipeline.
    ``finite_members`` per-row count of committee members whose outputs
                      were finite (int32); members with any non-finite
                      component are quarantined out of the statistics.
    """

    mean: np.ndarray            # (n, d)
    scalar_std: np.ndarray      # (n,)
    component_std: np.ndarray   # (n,)
    mask: np.ndarray            # (n,) bool
    finite_members: Optional[np.ndarray] = None   # (n,) int32


@dataclasses.dataclass
class UQStats:
    """Per-round statistics handed to selection rules: tensors on the
    engine's device over the PADDED bucket.  ``valid`` masks real rows
    (padding rows are never selectable); ``n_valid`` is the true input
    count and ``stream`` the traffic tag, both 0-d int32 tensors on the
    device, filled at run time — one program per bucket serves every n and
    both streams, and no rule reads either on the host (a CUDA graph
    replays the program with new values)."""

    x: Any                      # (nb, in_dim) the stacked proposal batch
    mean: Any                   # (nb, d)
    scalar_std: Any             # (nb,)
    component_std: Any          # (nb,)
    valid: Any                  # (nb,) bool
    n_valid: Any                # 0-d int32 tensor
    stream: Any = STREAM_EXCHANGE  # 0-d int32: STREAM_EXCHANGE | STREAM_SERVE
    finite_members: Any = None  # (nb,) int32 finite-member count


# ---------------------------------------------------------------------------
# Selection rules — tensor ops on the engine's device
# ---------------------------------------------------------------------------


class SelectionRule:
    """Composable selection logic: ``apply(stats, mask) -> mask``.

    Rules are folded in order over the incoming mask (initially every valid
    row).  Set ``needs_inputs`` when the rule reads ``stats.x``.

    STATEFUL rules (``stateful = True``) carry a small state (a dict of 0-d
    or 1-d tensors) across scoring rounds.  They implement ``init_state()``
    (host tensors; the engine moves them to its device) and
    ``apply_stateful(stats, mask, state) -> (stats, mask, new_state)``
    instead of ``apply``; returning ``stats`` lets a rule transform the
    statistics downstream rules consume without touching the raw
    ``UQResult`` the engine reports.
    """

    needs_inputs: bool = False
    stateful: bool = False

    def apply(self, stats: UQStats, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self) -> Any:
        """Initial carried state (stateful rules only)."""
        raise NotImplementedError

    def apply_stateful(self, stats: UQStats, mask: torch.Tensor,
                       state: Any) -> Tuple[UQStats, torch.Tensor, Any]:
        """Stateful fold step: ``(stats, mask, state) -> (stats', mask',
        state')``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ThresholdRule(SelectionRule):
    """The paper's central check: select where scalar_std > threshold.

    Compares in the statistics' native dtype, as the reference does: fp32
    on the fused path (against the threshold rounded to fp32), float64 on
    the legacy host path (against the threshold itself — rounding it would
    drop a row whose std lies between the two)."""

    threshold: float

    def apply(self, stats: UQStats, mask):
        std = stats.scalar_std
        thr = self.threshold if std.dtype == torch.float64 \
            else _f32(self.threshold)
        return mask & (std > thr)


@functools.lru_cache(maxsize=64)
def k_table(n: int, fraction: float, device: torch.device) -> torch.Tensor:
    """``[int(round(m * fraction)) for m in range(n + 1)]`` (float64
    rounding, the reference's trace-time table) as int32 on ``device``,
    uploaded once per (n, fraction, device)."""
    return torch.tensor([int(round(m * fraction)) for m in range(n + 1)],
                        dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class TopFractionRule(SelectionRule):
    """Keep exactly the top ``round(fraction * n_valid)`` most-uncertain
    candidates (by scalar_std) among those still masked.  Rank-based, so
    exact ties never push the selection over the cap; tied ranks break
    toward the lower index (stable sort).
    """

    fraction: float

    def apply(self, stats: UQStats, mask):
        n = int(mask.shape[0])
        # k must be the host's int(round(m * fraction)) in float64, EXACTLY
        # — fp32 arithmetic cannot reproduce float64 rounding for arbitrary
        # (m, fraction) (e.g. 45*0.7: fp32 lands on 31.5 -> 32, float64 on
        # 31.499999999999996 -> 31).  As in the reference, the exact k of
        # every m <= n is a table built on the host once per bucket, and
        # the device-resident n_valid indexes it
        k = k_table(n, self.fraction, mask.device).index_select(
            0, stats.n_valid.reshape(1).clamp(0, n).long())
        # fp32 scores on both backends (the reference's jnp ranks the
        # legacy path's float64 statistics in fp32 too)
        sstd = stats.scalar_std.to(torch.float32)
        score = torch.where(mask, sstd, torch.full_like(sstd, -np.inf))
        order = torch.argsort(-score, stable=True)   # ties by lower index
        rank = torch.empty(n, dtype=torch.int32, device=mask.device)
        rank[order] = torch.arange(n, dtype=torch.int32, device=mask.device)
        return mask & (rank < k)


@dataclasses.dataclass(frozen=True)
class DiversityRule(SelectionRule):
    """Greedy de-duplication in input space (paper §3.1: avoid redundant
    oracle calculations): visit masked candidates in descending-uncertainty
    order and keep one only if no already-kept candidate lies closer than
    ``min_dist``.

    A Python loop of tensor ops over the bucket, the reference's
    ``fori_loop``: indices stay on the device (``index_select`` /
    ``index_put_``), so no step syncs with the host and the loop is
    captured into the bucket's CUDA graph as it stands.  Distances come from
    direct differences (not the Gram identity, which cancels in fp32) with
    O(n * d) memory.
    """

    min_dist: float
    needs_inputs = True

    def apply(self, stats: UQStats, mask):
        x = stats.x.to(torch.float32)
        n = x.shape[0]
        md2 = float(np.float32(self.min_dist) ** 2)
        sstd = stats.scalar_std.to(torch.float32)
        order = torch.argsort(
            torch.where(mask, -sstd, torch.full_like(sstd, np.inf)),
            stable=True)
        kept = torch.zeros(n, dtype=torch.bool, device=x.device)
        for t in range(n):
            i = order[t:t + 1]                              # (1,) on device
            di = torch.sum((x - x.index_select(0, i)) ** 2, dim=-1)
            ok = mask.index_select(0, i) & ~torch.any(kept & (di < md2))
            kept.index_put_((i,), ok)
        return kept


def default_rules(threshold: float) -> Tuple[SelectionRule, ...]:
    return (ThresholdRule(threshold),)


# ---------------------------------------------------------------------------
# Engine protocol
# ---------------------------------------------------------------------------


def _copy_leaves(dst: Any, src: Any) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in one
    call (one host round trip, whatever the number of leaves)."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if d:
        torch._foreach_copy_(d, s)


class UQEngine:
    """One interface for committee scoring.  ``score`` is the ONLY call the
    controller makes on the hot path; ``refresh_from`` pulls fresh weights
    from a ``WeightStore`` (0 for backends whose members refresh
    themselves); ``uses_models`` tells the PredictionPool whether the
    per-member ``UserModel`` instances are part of this engine's path.

    ``rule_state`` carries the state of stateful rules across rounds — one
    dict per stateful rule, in pipeline order; its tensors are the engine's
    own buffers, updated in place.  ``score(..., advance=False)`` evaluates
    the pipeline against the current state WITHOUT advancing it (read-only
    serving, re-scoring).  ``state_dict`` / ``load_state_dict`` snapshot the
    carried state to host numpy and restore it into the same buffers."""

    uses_models: bool = False
    rule_state: Tuple[Any, ...] = ()

    def score(self, list_data: Sequence[np.ndarray], *,
              advance: bool = True,
              stream: int = STREAM_EXCHANGE) -> UQResult:
        raise NotImplementedError

    def refresh_from(self, store) -> int:
        return 0

    def _init_rule_state(self):
        """One state per stateful rule (pipeline order), on the engine's
        device, plus the lock that makes an ADVANCING round's read-state ->
        score -> store-state cycle atomic."""
        self.rule_state = tuple(
            tree_map(lambda t: torch.as_tensor(t).to(self.device),
                     r.init_state())
            for r in self.rules if r.stateful)
        self._state_lock = threading.Lock()

    def _state_guard(self, advance: bool):
        """Lock held by advancing scorers: without it, concurrent rounds
        would both update from the same base state and the second store
        would drop the first round's update.  advance=False scorers take
        no state lock — they only read the state."""
        if advance and self.rule_state:
            return self._state_lock
        return contextlib.nullcontext()

    def _copy_into(self, dst: Any, src: Any) -> None:
        """Copy the leaves of ``src`` into the buffers of ``dst``."""
        _copy_leaves(dst, src)

    def state_dict(self) -> Tuple[Any, ...]:
        """Host-numpy snapshot (a copy) of the carried cross-round rule
        state."""
        return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(),
                        tuple(self.rule_state))

    def load_state_dict(self, state: Sequence[Any]):
        """Restore a ``state_dict`` snapshot into the carried state's
        buffers — if it structurally matches the CURRENT rule pipeline
        (same rule count, keys and shapes).  A mismatched snapshot is
        skipped with a warning and the fresh state kept: the controller
        re-converges instead of failing mid-round."""
        new = tree_map(lambda a: torch.as_tensor(np.asarray(a)),
                       tuple(state))
        cur = tuple(self.rule_state)
        if tree_paths(cur) != tree_paths(new) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(tree_leaves(cur), tree_leaves(new))):
            log.warning(
                "engine rule-state snapshot does not match the current "
                "rule pipeline (%s vs %s) — skipping restore, carried "
                "acquisition state re-converges from scratch",
                tree_paths(new), tree_paths(cur))
            return
        self._copy_into(cur, new)


class _Bucket:
    """One shape bucket's static buffers.  ``dev_in`` holds the padded
    batch (nb, in_dim) f32 followed by ``n_valid`` and ``stream`` (int32),
    the program's inputs; ``host_in`` is its host twin (pinned on the card,
    the same tensor on the CPU), so one copy uploads all three.  ``packed``
    is the program's output (``ref.packed_uq_views`` layout) and
    ``host_out`` its pinned host twin.  On the card with capture on,
    ``graph`` is the captured program, ``new_state`` its rule-state
    outputs and ``launches`` the ``committee_uq`` launches one replay
    makes."""

    def __init__(self, nb: int, in_dim: int, device: torch.device):
        self.nb, self.in_dim = nb, in_dim
        self.lock = threading.Lock()
        xbytes = nb * in_dim * 4
        self.dev_in = torch.zeros(xbytes + 8, dtype=torch.uint8,
                                  device=device)
        cuda = device.type == "cuda"
        self.host_in = torch.zeros(xbytes + 8, dtype=torch.uint8,
                                   pin_memory=True) if cuda else self.dev_in
        host = self.host_in.numpy()
        self.host_x = host[:xbytes].view(np.float32).reshape(nb, in_dim)
        self.host_scalars = host[xbytes:].view(np.int32)
        self.x = self.dev_in[:xbytes].view(torch.float32).view(nb, in_dim)
        scalars = self.dev_in[xbytes:].view(torch.int32)
        self.n_valid, self.stream = scalars[0], scalars[1]
        self.d: Optional[int] = None
        self.packed: Optional[torch.Tensor] = None
        self.host_out: Optional[torch.Tensor] = None
        self.graph = None
        self.new_state: Tuple[Any, ...] = ()
        self.launches = 0
        self.event = torch.cuda.Event() if cuda else None

    def set_output(self, packed: torch.Tensor) -> None:
        """Keep the program's packed output buffer (and its host twin)."""
        self.packed = packed
        self.d = (packed.numel() - self.nb) // (4 * self.nb) - 3
        if packed.device.type == "cuda":
            self.host_out = torch.empty(packed.numel(), dtype=torch.uint8,
                                        pin_memory=True)


_MESH = ("the mesh-parallel engine comes with the multi-device slice "
         "(ROADMAP §A: multi-device)")


class FusedEngine(UQEngine):
    """One program per shape bucket: committee forward + UQ + selection.

    The vmapped committee forward, ``ops.committee_uq_packed`` (the
    statistics and the row-validity mask, packed into one buffer by the
    kernel on the card) and the rule pipeline run on the engine's device;
    only ``(mean, scalar_std, component_std, finite, mask)`` cross back to
    the host, in ONE copy — the ``(K, n, d)`` prediction tensor never
    leaves the device.  With the default pipeline (a lone
    ``ThresholdRule`` at the engine's threshold) the kernel's mask is the
    final mask; any other pipeline folds over the kernel's statistics and
    writes its mask into the packed buffer.

    Varying input counts are padded to power-of-two shape buckets.  On the
    card each bucket's program is captured ONCE as a CUDA graph at its
    first use (after a warm-up on the engine's side stream) and replayed
    from then on: the batch and the run-time scalars ``n_valid`` and
    ``stream`` are staged in one pinned buffer and uploaded in one copy,
    the graph is replayed, the packed output comes back in one copy, and
    the host waits once, on an event.  A failed capture raises; no bucket
    runs eagerly in its place.  ``capture=False`` runs the same program
    eagerly on the card (comparisons, profiles); the CPU always runs it
    eagerly.  ``trace_counts`` records program builds per bucket (captures
    on the card; tests assert <= 1); ``dispatches`` counts programs run —
    one ``committee_uq`` launch each on the card, added to the kernel's
    count at every replay.

    The committee params and the carried rule state are buffers owned by
    the engine: ``refresh_from_device``, assigning ``cparams`` and
    ``load_state_dict`` copy into them, so every captured graph sees the
    new values.  An advancing round copies the program's new rule state
    into the carried state; ``advance=False`` leaves it untouched.

    ``apply_fn(params, x)`` maps a single member's params over a batch
    ``x: (n, in_dim) -> (n, out_dim)``; ``cparams`` is the stacked committee
    (leading K axis), copied to ``device`` (default: the CUDA device; raises
    without CUDA).
    """

    def __init__(self, apply_fn: Callable, cparams: Any, threshold: float,
                 *, rules: Optional[Sequence[SelectionRule]] = None,
                 min_bucket: int = 8, block_n: int = 128,
                 mesh=None, device: DeviceLike = None,
                 capture: bool = True):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.device = resolve_device(device)
        self.apply = make_committee_apply(apply_fn)
        self._cparams = tree_map(
            lambda t: t.to(self.device, copy=True), cparams)
        self.threshold = float(threshold)
        self.rules = tuple(rules) if rules is not None \
            else default_rules(threshold)
        # the kernel's mask (valid & finite & sstd > threshold) is the
        # whole default pipeline's answer
        self._kernel_mask_final = (
            len(self.rules) == 1 and type(self.rules[0]) is ThresholdRule
            and _f32(self.rules[0].threshold) == _f32(self.threshold))
        self._init_rule_state()
        self.min_bucket = min_bucket
        self.block_n = block_n
        self.capture = bool(capture) and self.device.type == "cuda"
        self.version = -1                      # last WeightStore version seen
        self._buckets: Dict[int, _Bucket] = {}
        self.trace_counts: Dict[int, int] = {}
        # the exchange loop, the Manager and the serving queue may score
        # through the SAME engine: bucket builds, the order of work on the
        # engine's stream and the counters need locks
        self._compile_lock = threading.Lock()
        self._enqueue_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.dispatches = 0
        # host<->device traffic accounting
        self.bytes_to_device = 0
        self.bytes_to_host = 0
        # weight-refresh accounting: the device path stays at 0 host bytes
        self.refresh_host_bytes = 0
        self.device_refreshes = 0
        # quarantine observability: finite-member count of the most recent
        # round's worst row, and how many rounds quarantined any member
        self.last_finite_min: Optional[int] = None
        self.quarantine_rounds = 0

    @property
    def size(self) -> int:
        return committee_size(self._cparams)

    @property
    def cparams(self) -> Any:
        """The engine's committee params (its own buffers)."""
        return self._cparams

    @cparams.setter
    def cparams(self, tree: Any) -> None:
        # copied into the existing buffers: rebinding would leave every
        # captured graph reading the old weights
        self._load_params(tree)

    # ------------------------------------------------------------- program
    def program(self, cparams, x, n_valid, stream, rstate, *, out=None):
        """The bucket program: ``x`` (nb, in_dim) f32, ``n_valid`` and
        ``stream`` 0-d int32 tensors, ``rstate`` the carried rule state.
        Returns ``(packed, new_state)``: the packed outputs (written into
        ``out`` when given) and the rules' new state.  Reads nothing on the
        host, so the card captures it as it stands."""
        preds = self.apply(cparams, x).contiguous()
        packed = ops.committee_uq_packed(preds, self.threshold, n_valid,
                                         out=out)
        if self._kernel_mask_final:
            return packed, ()
        nb, d = preds.shape[1], preds.shape[2]
        mean, sstd, cstd, finite, out_mask = ref.packed_uq_views(
            packed, nb, d)
        valid = torch.arange(nb, device=x.device) < n_valid
        stats = UQStats(x=x, mean=mean, scalar_std=sstd, component_std=cstd,
                        valid=valid, n_valid=n_valid, stream=stream,
                        finite_members=finite)
        mask = valid
        new_state, si = [], 0
        for rule in self.rules:
            if rule.stateful:
                stats, mask, ns = rule.apply_stateful(stats, mask, rstate[si])
                mask = mask & valid
                new_state.append(ns)
                si += 1
            else:
                mask = rule.apply(stats, mask) & valid
        # quarantine floor: a row no finite member scored carries no
        # information — never selectable, whatever the rules say
        out_mask.copy_(mask & (finite > 0))
        return packed, tuple(new_state)

    def _bucket(self, nb: int, in_dim: int) -> _Bucket:
        b = self._buckets.get(nb)
        if b is None:
            with self._compile_lock:
                b = self._buckets.get(nb)
                if b is None:
                    b = _Bucket(nb, in_dim, self.device)
                    if not self.capture:
                        self.trace_counts[nb] = \
                            self.trace_counts.get(nb, 0) + 1
                    self._buckets[nb] = b
        if b.in_dim != in_dim:
            raise ValueError(f"engine bucket {nb} takes rows of {b.in_dim} "
                             f"inputs, got {in_dim}")
        return b

    def _run_program(self, b: _Bucket):
        packed, new_state = self.program(
            self._cparams, b.x, b.n_valid, b.stream, self.rule_state,
            out=b.packed)
        if b.packed is None:
            b.set_output(packed)
        return new_state

    def _capture(self, b: _Bucket) -> None:
        """Warm up, then capture the bucket's program as a CUDA graph, on
        the engine's stream (the caller holds the enqueue lock and the
        stream is current).  The warm-up loads the kernel library,
        initialises cuBLAS and fills the rules' device caches (LSH
        projection, k table), none of which may happen under capture.
        Both run under the process-wide capture lock: one capture at a
        time (a committee trainer may capture in another thread), and the
        kernel's capture count is read around it."""
        with platform.capture_lock:
            for _ in range(2):
                self._run_program(b)
            graph = torch.cuda.CUDAGraph()
            before = cuq_kernel.captured
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                _, new_state = self.program(
                    self._cparams, b.x, b.n_valid, b.stream,
                    self.rule_state, out=b.packed)
            b.launches = cuq_kernel.captured - before
            b.graph, b.new_state = graph, new_state
            with self._counter_lock:
                self.trace_counts[b.nb] = self.trace_counts.get(b.nb, 0) + 1

    def _dispatch(self, b: _Bucket, advance: bool) -> np.ndarray:
        """Run the bucket's program on the staged inputs; returns a host
        copy of the packed outputs.  Caller holds ``b.lock``."""
        if self._stream is None:                       # the CPU: eagerly
            with self._enqueue_lock:
                new_state = self._run_program(b)
                if advance:
                    _copy_leaves(self.rule_state, new_state)
            return b.packed.numpy().copy()
        with self._enqueue_lock, torch.cuda.stream(self._stream):
            b.dev_in.copy_(b.host_in, non_blocking=True)
            if self.capture:
                if b.graph is None:
                    self._capture(b)
                b.graph.replay()
                cuq_kernel.count_replays(b.launches)
                new_state = b.new_state
            else:
                new_state = self._run_program(b)
            if advance:             # the state lives on this stream alone
                _copy_leaves(self.rule_state, new_state)
            b.host_out.copy_(b.packed, non_blocking=True)
            b.event.record(self._stream)
        b.event.synchronize()
        return b.host_out.numpy().copy()

    def _pad_batch(self, list_data: Sequence[np.ndarray]):
        """Stack proposals into one padded (bucket, in_dim) float32 batch.
        Pre-stacked 2-D input takes a vectorized path; ragged input is
        normalized row by row."""
        if isinstance(list_data, np.ndarray):
            arr = list_data.astype(np.float32, copy=False)
        else:
            try:
                arr = np.asarray(list_data, dtype=np.float32)
            except ValueError:          # ragged rows: slow path below
                arr = np.empty(0, np.float32)
        if arr.ndim == 2:
            n = arr.shape[0]
            nb = shape_bucket(n, self.min_bucket)
            if nb == n:
                return np.ascontiguousarray(arr), n, nb
            x = np.zeros((nb, arr.shape[1]), np.float32)
            x[:n] = arr
            return x, n, nb
        rows = [np.asarray(x, dtype=np.float32).reshape(-1)
                for x in list_data]
        n = len(rows)
        nb = shape_bucket(n, self.min_bucket)
        x = np.zeros((nb, rows[0].size), np.float32)
        for i, r in enumerate(rows):
            x[i] = r
        return x, n, nb

    # -------------------------------------------------------------- score
    def score(self, list_data: Sequence[np.ndarray], *,
              advance: bool = True,
              stream: int = STREAM_EXCHANGE) -> UQResult:
        x, n, nb = self._pad_batch(list_data)
        # buffers and programs are built outside inference mode whatever
        # the caller's mode: a graph captured in it computes no forces
        with torch.inference_mode(False):
            b = self._bucket(nb, x.shape[1])
            with self._state_guard(advance), b.lock:
                b.host_x[...] = x
                b.host_scalars[...] = (n, stream)
                buf = self._dispatch(b, advance)
                d = b.d
        mean, sstd, cstd, finite, mask = ref.packed_uq_views(buf, nb, d)
        finite_n = finite[:n]
        with self._counter_lock:
            self.dispatches += 1
            self.bytes_to_device += x.nbytes
            self.bytes_to_host += buf.nbytes
            if finite_n.size:
                self.last_finite_min = int(finite_n.min())
                if self.last_finite_min < self.size:
                    self.quarantine_rounds += 1
        return UQResult(mean[:n], sstd[:n], cstd[:n], mask[:n], finite_n)

    def score_after(self, *args, **kwargs):
        raise NotImplementedError(
            "score_after (fused walker advance + scoring) comes with the "
            "exploration-fleet slice (ROADMAP §A: the exploration fleet)")

    # -------------------------------------------------------------- weights
    def _copy_into(self, dst: Any, src: Any) -> None:
        """Copy ``src``'s leaves into the engine's buffers ``dst``, ordered
        on the card against every dispatch: on the engine's stream, after
        the caller's stream, which then waits for the copies."""
        if self._stream is None:
            return super()._copy_into(dst, src)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            super()._copy_into(dst, src)
        cur.wait_stream(self._stream)

    def _load_params(self, cparams) -> None:
        cur = self._cparams
        if tree_paths(cparams) != tree_paths(cur) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(tree_leaves(cparams), tree_leaves(cur))):
            raise ValueError(
                "committee params must keep the engine's keys and shapes "
                f"(committee size {self.size})")
        with self._enqueue_lock:
            self._copy_into(cur, cparams)

    def load_state_dict(self, state: Sequence[Any]):
        with self._enqueue_lock:
            super().load_state_dict(state)

    def refresh_from(self, store) -> int:
        """Refresh the stacked committee from a ``WeightStore`` if anything
        newer exists.  Prediction member i replicates training member
        ``i % store.n_members`` (paper: prediction models are replicas of
        training models), so the committee size K is kept even when fewer
        trainers publish.  The packed weights are unpacked on the host and
        copied into the engine's own buffers, so every captured graph sees
        them; ``refresh_host_bytes`` counts the packed bytes pulled.
        Returns the number of refreshed committees (0 or 1)."""
        v = store.version()
        if v <= self.version:
            return 0
        K = self.size
        packs = [store.pull_packed(i % store.n_members) for i in range(K)]
        if any(p is None for p in packs):
            return 0              # not all trainers have published yet
        with self._counter_lock:
            self.refresh_host_bytes += sum(p[0].nbytes for p in packs)
        like = tree_map(lambda t: torch.empty(tuple(t.shape[1:]),
                                              dtype=t.dtype), self._cparams)
        self._load_params(stack_members(
            [update(like, packs[i][0]) for i in range(K)]))
        self.version = v
        return 1

    def refresh_from_device(self, cparams) -> int:
        """Weight handoff from a trainer on the same device: the stacked
        tree is copied device to device into the engine's own buffers
        (which every captured graph reads) — no packed host round trip,
        so ``refresh_host_bytes`` stays untouched.  The committee size and
        every leaf's shape must not change."""
        k = committee_size(cparams)
        if k != self.size:
            raise ValueError(
                f"refresh_from_device: committee size changed ({k} vs "
                f"{self.size})")
        self._load_params(cparams)
        self.device_refreshes += 1
        return 1


class LegacyEngine(UQEngine):
    """Per-member backend for arbitrary ``UserModel`` kernels (the paper's
    original per-process structure): K sequential ``model.predict`` calls
    (or a user ``predict_all_override``), float64 host statistics, then the
    SAME rule objects run eagerly on CPU tensors — swapping a user model in
    never changes selection semantics, only throughput.  The engine has no
    device: its statistics are host numpy, as in the reference, and its
    carried rule state lives in CPU tensors.

    Weight refresh stays with the PredictionPool (the models own their
    parameters), hence ``uses_models`` and the no-op ``refresh_from``.
    """

    uses_models = True

    def __init__(self, predict_all: Callable[[Sequence[np.ndarray]],
                                             np.ndarray],
                 threshold: float,
                 *, rules: Optional[Sequence[SelectionRule]] = None):
        self.predict_all = predict_all
        self.threshold = float(threshold)
        self.rules = tuple(rules) if rules is not None \
            else default_rules(threshold)
        self.device = torch.device("cpu")
        self._init_rule_state()
        self.last_finite_min: Optional[int] = None
        self.quarantine_rounds = 0

    def score(self, list_data: Sequence[np.ndarray], *,
              advance: bool = True,
              stream: int = STREAM_EXCHANGE) -> UQResult:
        with self._state_guard(advance):
            return self._score(list_data, advance=advance, stream=stream)

    def _score(self, list_data: Sequence[np.ndarray], *,
               advance: bool, stream: int = STREAM_EXCHANGE) -> UQResult:
        preds = np.asarray(self.predict_all(list_data), dtype=np.float64)
        k = preds.shape[0]
        fin = np.isfinite(preds).all(axis=tuple(range(2, preds.ndim)))  # (K, n)
        cnt = fin.sum(axis=0).astype(np.int32)                          # (n,)
        if fin.all():
            # steady state: the exact float64 reductions
            mean = preds.mean(axis=0)
            std = preds.std(axis=0, ddof=1) if k > 1 \
                else np.zeros_like(preds[0])
        else:
            # degraded-K statistics over the finite members only — the
            # fused kernel's quarantine semantics (ref.committee_uq_ref)
            w = fin.reshape(fin.shape + (1,) * (preds.ndim - 2))
            safe = np.maximum(cnt, 1).astype(np.float64)
            safe = safe.reshape((-1,) + (1,) * (preds.ndim - 2))
            mean = np.where(w, preds, 0.0).sum(axis=0) / safe
            dev = np.where(w, preds - mean, 0.0)
            var = (dev * dev).sum(axis=0) / np.maximum(
                cnt - 1, 1).reshape(safe.shape)
            var[cnt < 2] = 0.0
            std = np.sqrt(var)
        flat = std.reshape(std.shape[0], -1)
        sstd = flat.max(axis=-1)
        cstd = flat.mean(axis=-1)
        n = len(list_data)
        x = torch.from_numpy(np.stack([
            np.asarray(r, np.float32).reshape(-1) for r in list_data])) \
            if any(r.needs_inputs for r in self.rules) else None
        stats = UQStats(
            x=x, mean=torch.from_numpy(mean),
            scalar_std=torch.from_numpy(sstd),
            component_std=torch.from_numpy(cstd),
            valid=torch.ones(n, dtype=torch.bool),
            n_valid=torch.tensor(n, dtype=torch.int32),
            stream=torch.tensor(stream, dtype=torch.int32),
            finite_members=torch.from_numpy(cnt))
        mask = torch.ones(n, dtype=torch.bool)
        states, si = list(self.rule_state), 0
        for rule in self.rules:
            if rule.stateful:
                # the SAME rule code the fused backend captures, eagerly
                stats, mask, states[si] = rule.apply_stateful(
                    stats, mask, states[si])
                si += 1
            else:
                mask = rule.apply(stats, mask)
        mask = mask.numpy().astype(bool) & (cnt > 0)
        if advance:
            _copy_leaves(self.rule_state, tuple(states))
        if cnt.size:
            self.last_finite_min = int(cnt.min())
            if self.last_finite_min < k:
                self.quarantine_rounds += 1
        return UQResult(mean, sstd, cstd, mask, cnt)


# ---------------------------------------------------------------------------
# Config-driven construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommitteeSpec:
    """What the fused backend needs from the user: a single-member batch
    apply ``apply_fn(params, x: (n, in_dim)) -> (n, out_dim)`` plus the
    stacked committee parameters (leading K axis,
    ``committee.stack_members``)."""

    apply_fn: Callable
    cparams: Any


def wants_legacy(run_cfg, committee: Optional[CommitteeSpec],
                 force_legacy: bool = False) -> bool:
    """Whether the configuration asks for the per-member legacy backend."""
    impl = getattr(run_cfg, "uq_impl", "auto")
    return force_legacy or impl == "legacy" or (impl == "auto"
                                                and committee is None)


def make_engine(
    run_cfg,
    *,
    committee: Optional[CommitteeSpec] = None,
    predict_all: Optional[Callable] = None,
    rules: Optional[Sequence[SelectionRule]] = None,
    force_legacy: bool = False,
    mesh=None,
    sharding_rules=None,
    device: DeviceLike = None,
    capture: bool = True,
) -> UQEngine:
    """Build the acquisition engine from ``PALRunConfig`` knobs.

    ``uq_impl``:
      'auto'   — the fused engine when a ``CommitteeSpec`` is given, the
                 per-member legacy engine otherwise
      'xla', 'pallas', 'pallas_interpret'
               — the same ``FusedEngine``: the implementation of the
                 statistics follows ``device`` (the CUDA kernel on the
                 card, the plain PyTorch version on the CPU)
      'legacy' — per-member ``UserModel.predict`` (``predict_all``) +
                 float64 host statistics; it has no device

    ``force_legacy`` overrides everything (a ``predict_all_override`` puts
    the user in control of raw predictions).  A mesh (``mesh=``,
    ``sharding_rules=`` or ``uq_mesh``) on a fused engine raises
    ``NotImplementedError``; the legacy path ignores meshes, as in the
    reference.

    When no explicit ``rules=`` are given, the pipeline comes from the
    config's budget knobs (``core/budget.rules_from_config``).
    ``capture=False`` runs the engine's bucket programs eagerly on the card
    instead of replaying captured CUDA graphs (``FusedEngine``).
    """
    if rules is None:
        from repro_torch.core import budget as _budget

        rules = _budget.rules_from_config(run_cfg)
    if wants_legacy(run_cfg, committee, force_legacy):
        if predict_all is None:
            raise ValueError(
                "legacy UQ backend needs a predict_all callable "
                "(no committee spec was provided)")
        return LegacyEngine(predict_all, run_cfg.std_threshold, rules=rules)
    dev = resolve_device(device)
    if committee is None:
        raise ValueError(
            f"uq_impl={getattr(run_cfg, 'uq_impl', 'auto')!r} is a fused "
            "backend and needs a CommitteeSpec (apply_fn + stacked cparams)")
    if (mesh is not None or sharding_rules is not None
            or getattr(run_cfg, "uq_mesh", "")):
        raise NotImplementedError(_MESH)
    return FusedEngine(
        committee.apply_fn, committee.cparams, run_cfg.std_threshold,
        rules=rules,
        block_n=getattr(run_cfg, "uq_block_n", 128),
        min_bucket=getattr(run_cfg, "uq_bucket", 8),
        device=dev, capture=capture,
    )
