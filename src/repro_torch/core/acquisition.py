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
    per power-of-two shape bucket on the engine's device.  Per call the host
    uploads the padded batch once and downloads the five small outputs in
    one copy.
  * Rules        — composable selection logic (``ThresholdRule``,
    ``TopFractionRule``, ``DiversityRule``) in tensor ops on the engine's
    device.  Rules may be STATEFUL (``stateful = True`` + ``init_state`` /
    ``apply_stateful``): their small carried state stays on the device
    across rounds — ``core/budget.py`` builds the cross-round oracle-rate
    controller (``BudgetRule``) and the rolling re-weighting rule
    (``RollingReweightRule``) on this protocol.
  * ``make_engine`` — config-driven factory (``PALRunConfig`` knobs).

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP item
that brings it): the per-member ``LegacyEngine`` and ``refresh_from(store)``
(item 5, runtime), ``score_after`` (item 6, exploration fleet) and the mesh
path (item 8, multi-device).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.committee import (
    committee_size, make_committee_apply, shape_bucket, tree_leaves,
    tree_map, tree_paths,
)
from repro_torch.kernels import ops
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
    count and ``stream`` the traffic tag, both Python ints passed at run
    time — one program per bucket serves every n and both streams."""

    x: Any                      # (nb, in_dim) the stacked proposal batch
    mean: Any                   # (nb, d)
    scalar_std: Any             # (nb,)
    component_std: Any          # (nb,)
    valid: Any                  # (nb,) bool
    n_valid: Any                # int
    stream: Any = STREAM_EXCHANGE  # int: STREAM_EXCHANGE | STREAM_SERVE
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
    """The paper's central check: select where scalar_std > threshold
    (an fp32 compare, as on the reference's fused path)."""

    threshold: float

    def apply(self, stats: UQStats, mask):
        return mask & (stats.scalar_std > _f32(self.threshold))


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
        # k is the host's int(round(m * fraction)) in float64, EXACTLY —
        # fp32 arithmetic cannot reproduce float64 rounding for arbitrary
        # (m, fraction) (e.g. 45*0.7: fp32 lands on 31.5 -> 32, float64 on
        # 31.499999999999996 -> 31); n_valid is a host int, so the k table
        # the reference builds at trace time is one host expression here
        m = min(max(int(stats.n_valid), 0), n)
        k = int(round(m * self.fraction))
        score = torch.where(mask, stats.scalar_std,
                            torch.full_like(stats.scalar_std, -np.inf))
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
    ``index_put_``), so no step syncs with the host.  Distances come from
    direct differences (not the Gram identity, which cancels in fp32) with
    O(n * d) memory.
    """

    min_dist: float
    needs_inputs = True

    def apply(self, stats: UQStats, mask):
        x = stats.x.to(torch.float32)
        n = x.shape[0]
        md2 = float(np.float32(self.min_dist) ** 2)
        order = torch.argsort(
            torch.where(mask, -stats.scalar_std,
                        torch.full_like(stats.scalar_std, np.inf)),
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


class UQEngine:
    """One interface for committee scoring.  ``score`` is the ONLY call the
    controller makes on the hot path.

    ``rule_state`` carries the state of stateful rules across rounds — one
    dict per stateful rule, in pipeline order.  ``score(..., advance=False)``
    evaluates the pipeline against the current state WITHOUT advancing it
    (read-only serving, re-scoring).  ``state_dict`` / ``load_state_dict``
    snapshot the carried state to host numpy and restore it."""

    rule_state: Tuple[Any, ...] = ()

    def score(self, list_data: Sequence[np.ndarray], *,
              advance: bool = True,
              stream: int = STREAM_EXCHANGE) -> UQResult:
        raise NotImplementedError

    def refresh_from(self, store) -> int:
        raise NotImplementedError(
            "refresh_from(WeightStore) comes with the runtime slice "
            "(ROADMAP §A item 5: core/weight_sync.py)")

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
        would drop the first round's update.  advance=False scorers stay
        lock-free — they only read the state tuple."""
        if advance and self.rule_state:
            return self._state_lock
        return contextlib.nullcontext()

    def state_dict(self) -> Tuple[Any, ...]:
        """Host-numpy snapshot of the carried cross-round rule state."""
        return tree_map(lambda t: t.detach().cpu().numpy(),
                        tuple(self.rule_state))

    def load_state_dict(self, state: Sequence[Any]):
        """Restore a ``state_dict`` snapshot — if it structurally matches
        the CURRENT rule pipeline (same rule count, keys and shapes).  A
        mismatched snapshot is skipped with a warning and the fresh state
        kept: the controller re-converges instead of failing mid-round."""
        restored = tree_map(
            lambda a: torch.as_tensor(np.asarray(a)).to(self.device),
            tuple(state))
        cur, new = tuple(self.rule_state), restored
        if tree_paths(cur) != tree_paths(new) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(tree_leaves(cur), tree_leaves(new))):
            log.warning(
                "engine rule-state snapshot does not match the current "
                "rule pipeline (%s vs %s) — skipping restore, carried "
                "acquisition state re-converges from scratch",
                tree_paths(new), tree_paths(cur))
            return
        self.rule_state = restored


class FusedEngine(UQEngine):
    """One program per shape bucket: committee forward + UQ + selection.

    The vmapped committee forward, the ``ops.committee_uq`` statistics and
    the rule pipeline run on the engine's device; only ``(mean, scalar_std,
    component_std, mask, finite)`` cross back to the host, in ONE copy —
    the ``(K, n, d)`` prediction tensor never leaves the device.

    Varying input counts are padded to power-of-two shape buckets; each
    bucket's program is built once (``trace_counts`` records builds per
    bucket; tests assert <= 1) and the true count enters it at run time, so
    fraction-of-n rules need no rebuild.  ``dispatches`` counts programs
    run — one ``committee_uq`` launch each on the card.

    ``apply_fn(params, x)`` maps a single member's params over a batch
    ``x: (n, in_dim) -> (n, out_dim)``; ``cparams`` is the stacked committee
    (leading K axis), moved to ``device`` (default: the CUDA device; raises
    without CUDA).
    """

    def __init__(self, apply_fn: Callable, cparams: Any, threshold: float,
                 *, rules: Optional[Sequence[SelectionRule]] = None,
                 min_bucket: int = 8, block_n: int = 128,
                 mesh=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "the mesh-parallel engine comes with the multi-device slice "
                "(ROADMAP §A item 8)")
        self.device = resolve_device(device)
        self.apply = make_committee_apply(apply_fn)
        self.cparams = tree_map(lambda t: t.to(self.device), cparams)
        self.threshold = float(threshold)
        self.rules = tuple(rules) if rules is not None \
            else default_rules(threshold)
        self._init_rule_state()
        self.min_bucket = min_bucket
        self.block_n = block_n
        self.version = -1                      # last WeightStore version seen
        self._cache: Dict[int, Callable] = {}
        self.trace_counts: Dict[int, int] = {}
        # the exchange loop, the Manager and the serving queue may score
        # through the SAME engine: program builds and counters need locks
        self._compile_lock = threading.Lock()
        self._counter_lock = threading.Lock()
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
        return committee_size(self.cparams)

    # ------------------------------------------------------------- programs
    def _compiled_locked(self, nb: int) -> Callable:
        # caller holds self._compile_lock
        fn = self._cache.get(nb)
        if fn is None:
            self.trace_counts[nb] = self.trace_counts.get(nb, 0) + 1
            rows = torch.arange(nb, device=self.device)

            def fused(cparams, x, n_valid: int, stream: int, rstate):
                preds = self.apply(cparams, x).contiguous()
                mean, sstd, cstd, _, finite = ops.committee_uq(
                    preds, self.threshold, block_n=self.block_n)
                valid = rows < n_valid
                stats = UQStats(x=x, mean=mean, scalar_std=sstd,
                                component_std=cstd, valid=valid,
                                n_valid=n_valid, stream=stream,
                                finite_members=finite)
                mask = valid
                new_state, si = [], 0
                for rule in self.rules:
                    if rule.stateful:
                        stats, mask, ns = rule.apply_stateful(
                            stats, mask, rstate[si])
                        mask = mask & valid
                        new_state.append(ns)
                        si += 1
                    else:
                        mask = rule.apply(stats, mask) & valid
                # quarantine floor: a row no finite member scored carries
                # no information — never selectable, whatever the rules say
                mask = mask & (finite > 0)
                return mean, sstd, cstd, mask, finite, tuple(new_state)

            fn = fused
            self._cache[nb] = fn
        return fn

    def _dispatch(self, nb: int, args):
        fn = self._cache.get(nb)
        if fn is None:
            with self._compile_lock:
                fn = self._compiled_locked(nb)
        out = fn(*args)
        with self._counter_lock:
            self.dispatches += 1
        return out

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

    @staticmethod
    def _to_host(mean, sstd, cstd, mask, finite):
        """ONE device-to-host copy of the five outputs: their bytes are
        packed into one buffer on the device, copied, and viewed back."""
        nb, d = mean.shape
        parts = (mean.reshape(-1), sstd, cstd, finite, mask)
        buf = torch.cat([p.view(torch.uint8) for p in parts]).cpu().numpy()
        out, off = [], 0
        for p, dt in zip(parts, (np.float32, np.float32, np.float32,
                                 np.int32, np.bool_)):
            nbytes = p.numel() * p.element_size()
            out.append(buf[off:off + nbytes].view(dt))
            off += nbytes
        m, s, c, f, k = out
        return m.reshape(nb, d), s, c, k, f

    # -------------------------------------------------------------- score
    def score(self, list_data: Sequence[np.ndarray], *,
              advance: bool = True,
              stream: int = STREAM_EXCHANGE) -> UQResult:
        x, n, nb = self._pad_batch(list_data)
        xd = torch.from_numpy(x).to(self.device)
        with self._state_guard(advance):
            out = self._dispatch(
                nb, (self.cparams, xd, int(n), int(stream), self.rule_state))
            if advance:
                self.rule_state = out[5]
        mean, sstd, cstd, mask, finite = self._to_host(*out[:5])
        finite_n = finite[:n]
        with self._counter_lock:
            self.bytes_to_device += x.nbytes
            self.bytes_to_host += (mean.nbytes + sstd.nbytes + cstd.nbytes
                                   + mask.nbytes + finite.nbytes)
            if finite_n.size:
                self.last_finite_min = int(finite_n.min())
                if self.last_finite_min < self.size:
                    self.quarantine_rounds += 1
        return UQResult(mean[:n], sstd[:n], cstd[:n], mask[:n], finite_n)

    def score_after(self, *args, **kwargs):
        raise NotImplementedError(
            "score_after (fused walker advance + scoring) comes with the "
            "exploration-fleet slice (ROADMAP §A item 6)")

    # -------------------------------------------------------------- weights
    def refresh_from_device(self, cparams) -> int:
        """Weight handoff from a trainer on the same device: the stacked
        tree is placed on the engine's device (no copy when it already
        lies there) — no packed host round trip, so
        ``refresh_host_bytes`` stays untouched.  The committee size must
        not change."""
        k = committee_size(cparams)
        if k != self.size:
            raise ValueError(
                f"refresh_from_device: committee size changed ({k} vs "
                f"{self.size})")
        self.cparams = tree_map(lambda t: t.to(self.device), cparams)
        self.device_refreshes += 1
        return 1


_LEGACY = ("LegacyEngine (per-member UserModel scoring) comes with the "
           "runtime slice (ROADMAP §A item 5)")


class LegacyEngine(UQEngine):
    """The per-member backend (K ``UserModel.predict`` calls, float64 host
    statistics) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_LEGACY)


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
    rules: Optional[Sequence[SelectionRule]] = None,
    force_legacy: bool = False,
    mesh=None,
    device: DeviceLike = None,
) -> UQEngine:
    """Build the acquisition engine from ``PALRunConfig`` knobs.

    Every fused ``uq_impl`` ('auto', 'xla', 'pallas', 'pallas_interpret')
    builds the same ``FusedEngine``: the implementation of the statistics
    follows ``device`` (the CUDA kernel on the card, the plain PyTorch
    version on the CPU).  'legacy' and a mesh (``mesh=`` or ``uq_mesh``)
    raise ``NotImplementedError``.

    When no explicit ``rules=`` are given, the pipeline comes from the
    config's budget knobs (``core/budget.rules_from_config``).
    """
    dev = resolve_device(device)
    if wants_legacy(run_cfg, committee, force_legacy):
        raise NotImplementedError(_LEGACY)
    if committee is None:
        raise ValueError(
            f"uq_impl={getattr(run_cfg, 'uq_impl', 'auto')!r} is a fused "
            "backend and needs a CommitteeSpec (apply_fn + stacked cparams)")
    if mesh is not None or getattr(run_cfg, "uq_mesh", ""):
        raise NotImplementedError(
            "the mesh-parallel engine comes with the multi-device slice "
            "(ROADMAP §A item 8)")
    if rules is None:
        from repro_torch.core import budget as _budget

        rules = _budget.rules_from_config(run_cfg)
    return FusedEngine(
        committee.apply_fn, committee.cparams, run_cfg.std_threshold,
        rules=rules,
        block_n=getattr(run_cfg, "uq_block_n", 128),
        min_bucket=getattr(run_cfg, "uq_bucket", 8),
        device=dev,
    )
