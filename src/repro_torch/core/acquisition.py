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
  * ``FusedEngine.score_after`` — the exploration fleet's entry: a caller's
    walker advance, the same scoring program and a react step folded back
    into the caller's device-resident carry, one program per (cache key,
    bucket) — on the card one captured CUDA graph, replayed.  The host gets
    the selected rows and one int32 count (``FusedStepOut``).
  * ``make_engine`` — config-driven factory (``PALRunConfig`` knobs);
    ``resolve_mesh`` turns ``uq_mesh`` into a ``launch/mesh.Mesh``.

On a mesh (``FusedEngine(mesh=)``, ``launch/mesh.py``: one process per
device over ``torch.distributed``) every rank holds its committee members
(``COMMITTEE -> ('model',)``) and scores its rows of each bucket (the BATCH
axes); the members are gathered before ``committee_uq``, the statistics'
rows after it, and every rank runs the rule pipeline over the whole batch,
so the carried rule state is replicated.  A bucket whose mesh axes are all
of size 1 is exactly the unsharded program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.committee import (
    committee_size, make_committee_apply, shape_bucket, stack_members,
    tree_leaves, tree_map, tree_paths, update,
)
from repro_torch.kernels import committee_uq as cuq_kernel
from repro_torch.kernels import graphs, ops, ref
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
class FusedStepOut:
    """Host-side outcome of one ``FusedEngine.score_after`` round — the
    fused walker-advance + scoring program of the exploration fleet
    (``exploration/fleet.py``).

    Unlike ``UQResult``, the per-row statistics stay on the engine's device
    (``mask``/``scalar_std``/... are tensors over the padded bucket, a copy
    of the round's outputs): the exchange loop never needs them on the
    host.  The only host fields are ``n_selected`` (one int32 read back)
    and ``selected`` — the selected rows, packed to the front of the bucket
    on the device, of which exactly ``n_selected`` rows are copied back, so
    unselected walkers cost zero host bytes.
    """

    n_selected: int             # rows selected this round (host int)
    selected: np.ndarray        # (n_selected, d) host — the oracle candidates
    mask: Any                   # (nb,) bool, device
    mean: Any                   # (nb, d), device
    scalar_std: Any             # (nb,), device
    component_std: Any          # (nb,), device
    finite_members: Any         # (nb,) int32, device


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
    makes.  Dropped, it hands all of it to ``graphs.release``: the pinned
    twins carried copies on the engine's stream, so they are freed only
    where no capture runs."""

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
        self.staged: Optional[_Staged] = None      # a sharded bucket's

    def __del__(self):
        graphs.release(vars(self))

    def set_output(self, packed: torch.Tensor) -> None:
        """Keep the program's packed output buffer (and its host twin)."""
        self.packed = packed
        self.d = (packed.numel() - self.nb) // (4 * self.nb) - 3
        if packed.device.type == "cuda":
            self.host_out = torch.empty(packed.numel(), dtype=torch.uint8,
                                        pin_memory=True)


class _StepBucket:
    """One ``score_after`` program's static buffers, per (cache key,
    bucket).  ``scalars`` holds ``n_valid`` and ``stream`` (int32) on the
    device, uploaded only when they change; ``packed`` is the scoring
    output, ``sel_x`` the proposal rows with the selected ones packed to
    the front, ``n_sel`` their count; ``host_n``/``host_sel`` are pinned
    twins on the card (the same tensors on the CPU).  ``carry`` is the
    carried tree the program reads and writes in place (a captured graph
    keeps its addresses), ``graph`` the captured program on the card.
    Dropped, it hands all of it to ``graphs.release``, as ``_Bucket``
    does."""

    def __init__(self, nb: int, device: torch.device):
        self.nb = nb
        self.lock = threading.Lock()
        self.scalars = torch.zeros(2, dtype=torch.int32, device=device)
        self.n_valid, self.stream = self.scalars[0], self.scalars[1]
        self.uploaded: Optional[Tuple[int, int]] = None
        self.n_sel = torch.zeros(1, dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self.host_n = torch.zeros(1, dtype=torch.int32, pin_memory=True) \
            if cuda else self.n_sel
        self.ranks = torch.arange(1, nb + 1, dtype=torch.int64,
                                  device=device)
        self.packed: Optional[torch.Tensor] = None
        self.sel_x: Optional[torch.Tensor] = None
        self.host_sel: Optional[torch.Tensor] = None
        self.carry: Optional[Tuple[torch.Tensor, ...]] = None
        self.d: Optional[int] = None
        self.graph = None
        self.new_state: Tuple[Any, ...] = ()
        self.launches = 0
        self.event = torch.cuda.Event() if cuda else None
        self.staged: Optional[_Staged] = None      # a sharded bucket's

    def __del__(self):
        graphs.release(vars(self))


class _Staged:
    """A sharded bucket's program: stages of tensor work between the
    collectives that exchange members and rows.  ``steps`` is a list of
    ``("stage", fn)`` and ``("coll", fn)``; a collective's ``fn`` returns
    the bytes it staged through host memory.  Adjacent stages run as one.
    On the CPU (and with capture off) every step runs eagerly; on the card
    each stage is captured as its own CUDA graph and replayed, the
    collectives run eagerly between the replays on the engine's stream
    (gloo cannot be captured; NCCL under capture is not verified)."""

    def __init__(self, steps):
        self.steps: List[Tuple[str, Callable]] = []
        for kind, fn in steps:
            if kind == "stage" and self.steps and \
                    self.steps[-1][0] == "stage":
                first = self.steps[-1][1]
                self.steps[-1] = ("stage", _chain(first, fn))
            else:
                self.steps.append((kind, fn))
        self.graphs: Optional[List[Any]] = None

    def run(self) -> int:
        """Every step eagerly; returns the bytes staged through the host."""
        staged = 0
        for kind, fn in self.steps:
            out = fn()
            if kind == "coll":
                staged += out
        return staged

    def capture(self, stream, warmup: Callable[[], Any]) -> List[Any]:
        """Run ``warmup``, then capture every stage as a CUDA graph on
        ``stream`` (``graphs.capture``); the collectives are not run.
        Returns the kernels' launches one replay makes."""
        got = graphs.capture([fn for kind, fn in self.steps
                              if kind == "stage"], stream, warmup=warmup)
        stage_graphs = iter(got.graphs)
        self.graphs = [next(stage_graphs) if kind == "stage" else None
                       for kind, _ in self.steps]
        return got.launches

    def replay(self) -> int:
        staged = 0
        for (kind, fn), g in zip(self.steps, self.graphs):
            if g is not None:
                g.replay()
            else:
                staged += fn()
        return staged


def _cuq_launches(launches: List[Any]) -> int:
    """``committee_uq``'s count in ``graphs.capture``'s launches."""
    return launches[graphs.KERNELS.index(cuq_kernel)]


def _chain(f: Callable, g: Callable) -> Callable:
    def both():
        f()
        g()
    return both


def _write_carry(carry: Any, new_carry: Any) -> None:
    """Copy ``new_carry``'s leaves into ``carry``'s buffers (a leaf that is
    the buffer itself is skipped)."""
    if tree_paths(new_carry) != tree_paths(carry):
        raise ValueError(
            f"score_after: the new carry's keys {tree_paths(new_carry)} "
            f"are not the carry's {tree_paths(carry)}")
    pairs = [(a, b) for a, b in zip(tree_leaves(carry),
                                    tree_leaves(new_carry)) if a is not b]
    if pairs:
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])


def _unpack_rows(rows: torch.Tensor, packed: torch.Tensor, nb: int,
                 d: int) -> None:
    """Write the gathered rows (``_row_matrix`` of the packed statistics,
    columns ``[0, d + 4)``) into the packed buffer of ``nb`` rows."""
    mean, sstd, cstd, finite, mask = ref.packed_uq_views(packed, nb, d)
    mean.view(torch.int32).copy_(rows[:, :d])
    sstd.view(torch.int32).copy_(rows[:, d])
    cstd.view(torch.int32).copy_(rows[:, d + 1])
    finite.copy_(rows[:, d + 2])
    mask.copy_(rows[:, d + 3] != 0)


def _row_matrix(*cols: torch.Tensor) -> torch.Tensor:
    """Per-row fields as one int32 (rows, width) matrix, bit for bit: fp32
    and int32 columns by their bits, bool as 0/1 (one collective carries
    every field of a row)."""
    out = []
    for c in cols:
        c = c.reshape(c.shape[0], -1)
        if c.dtype == torch.bool:
            c = c.to(torch.int32)
        out.append(c.view(torch.int32))
    return torch.cat(out, dim=1)


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

    ``score_after`` (the exploration fleet) runs a caller's step function
    and the same scoring body as one program per (cache key, bucket), with
    its own table: ``step_trace_counts`` (captures per key on the card,
    program builds on the CPU; <= 1) and ``step_dispatches``, apart from
    ``score``'s ``trace_counts`` and ``dispatches``.

    ``apply_fn(params, x)`` maps a single member's params over a batch
    ``x: (n, in_dim) -> (n, out_dim)``; ``cparams`` is the stacked committee
    (leading K axis), copied to ``device`` (default: the CUDA device; raises
    without CUDA).

    MESH PATH (``mesh=``, a ``launch/mesh.Mesh``; ``sharding_rules=``
    overrides the logical-axis rules).  Every rank of the mesh builds the
    same engine from the same global inputs and scores the same batches
    in the same order (SPMD); under ``PAL`` the leader's engine lane
    (``core/dispatch.py``) sets that order for every thread that scores.
    The stacked committee goes over the ``COMMITTEE`` rules' axes
    (``('model',)``, with the divisibility fallback, warned once):
    each rank keeps its own members.  Each bucket's rows go over the
    ``BATCH`` rules' axes (``('pod', 'data')``, fallback per bucket).  The
    rank's members score the rank's rows; the members' predictions are
    gathered over the committee axes BEFORE ``committee_uq`` (the Welford
    order over K is the unsharded one), the packed statistics of the rows
    after it, and every rank runs the rule pipeline over the whole batch —
    the carried rule state is replicated and equals the unsharded engine's.
    A bucket whose mesh axes all have size 1 is the unsharded program (one
    CUDA graph); any other is captured as the graphs between its
    collectives (``_Staged``).  Every rank uploads the whole batch and
    downloads the whole packed result, so ``bytes_to_device`` and
    ``bytes_to_host`` are the unsharded engine's; bytes a gloo collective
    stages through host memory are counted apart, in
    ``collective_host_bytes``.
    """

    def __init__(self, apply_fn: Callable, cparams: Any, threshold: float,
                 *, rules: Optional[Sequence[SelectionRule]] = None,
                 min_bucket: int = 8, block_n: int = 128,
                 mesh=None, sharding_rules=None, device: DeviceLike = None,
                 capture: bool = True):
        self.device = resolve_device(device)
        self.apply = make_committee_apply(apply_fn)
        self.mesh = mesh
        self._mesh_rules = None
        self._k = committee_size(cparams)
        # this rank's members and the mesh axes the committee is split over
        self._member_axes: Tuple[str, ...] = ()
        self._members = slice(0, self._k)
        if mesh is not None:
            from repro_torch.sharding.rules import (
                MeshRules, committee_shardings, spec_axes, warn_fallbacks,
            )

            self._mesh_rules = MeshRules(mesh, sharding_rules)
            spec = tree_leaves(committee_shardings(self._mesh_rules,
                                                   cparams))[0].spec
            self._member_axes = tuple(a for a in spec_axes(spec[0])
                                      if mesh.shape[a] > 1)
            # surface divisibility fallbacks (e.g. K=3 on a 2-way model
            # axis degrading to replicated) once, with the chosen layout
            warn_fallbacks(self._mesh_rules, "FusedEngine")
            if self._member_axes:
                kl = self._k // mesh.axes_size(self._member_axes)
                i = mesh.axes_index(self._member_axes)
                self._members = slice(i * kl, (i + 1) * kl)
        self._row_axes_cache: Dict[int, Tuple[str, ...]] = {}
        self._cparams = tree_map(
            lambda t: t[self._members].to(self.device, copy=True), cparams)
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
        self._step_buckets: Dict[Tuple[str, int], _StepBucket] = {}
        self.step_trace_counts: Dict[Tuple[str, int], int] = {}
        self.step_dispatches = 0
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
        self.collective_host_bytes = 0       # gloo's staging (mesh path)
        # weight-refresh accounting: the device path stays at 0 host bytes
        self.refresh_host_bytes = 0
        self.device_refreshes = 0
        # quarantine observability: finite-member count of the most recent
        # round's worst row, and how many rounds quarantined any member
        self.last_finite_min: Optional[int] = None
        self.quarantine_rounds = 0

    @property
    def size(self) -> int:
        """The committee size K (over every rank of a mesh)."""
        return self._k

    @property
    def cparams(self) -> Any:
        """The engine's committee params (its own buffers): this rank's
        members on a mesh whose committee axes are sharded."""
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
        packed, new_state, _, _ = self._score_body(
            cparams, x, n_valid, stream, rstate, out, want_stats=False)
        return packed, new_state

    def _score_body(self, cparams, x, n_valid, stream, rstate, out, *,
                    want_stats: bool):
        """``program``'s body; also returns the ``UQStats`` the rules saw
        (built on the kernel-mask path too when ``want_stats``) and the final
        mask, a view into the packed outputs."""
        preds = self.apply(cparams, x).contiguous()
        packed = ops.committee_uq_packed(preds, self.threshold, n_valid,
                                         out=out)
        return (packed,) + self._rules_body(packed, x, n_valid, stream,
                                            rstate, want_stats=want_stats)

    def _rules_body(self, packed, x, n_valid, stream, rstate, *,
                    want_stats: bool):
        """The rule pipeline over the packed statistics of the batch ``x``;
        writes the final mask into ``packed`` and returns ``(new_state,
        stats, mask)`` (``stats`` None on the kernel-mask path unless
        ``want_stats``)."""
        nb = x.shape[0]
        d = (packed.numel() - nb) // (4 * nb) - 3
        mean, sstd, cstd, finite, out_mask = ref.packed_uq_views(
            packed, nb, d)
        if self._kernel_mask_final and not want_stats:
            return (), None, out_mask
        valid = torch.arange(nb, device=x.device) < n_valid
        stats = UQStats(x=x, mean=mean, scalar_std=sstd, component_std=cstd,
                        valid=valid, n_valid=n_valid, stream=stream,
                        finite_members=finite)
        if self._kernel_mask_final:
            return (), stats, out_mask
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
        return tuple(new_state), stats, out_mask

    def _bucket(self, nb: int, in_dim: int) -> _Bucket:
        b = self._buckets.get(nb)
        if b is None:
            with self._compile_lock:
                b = self._buckets.get(nb)
                if b is None:
                    # made on the engine's stream, which writes it
                    b = self._on_stream(
                        lambda: _Bucket(nb, in_dim, self.device))
                    if not self.capture:
                        self.trace_counts[nb] = \
                            self.trace_counts.get(nb, 0) + 1
                    self._buckets[nb] = b
        if b.in_dim != in_dim:
            raise ValueError(f"engine bucket {nb} takes rows of {b.in_dim} "
                             f"inputs, got {in_dim}")
        return b

    # ---------------------------------------------------------------- mesh
    def _row_axes(self, nb: int) -> Tuple[str, ...]:
        """The mesh axes (of size > 1) a bucket's rows are split over: the
        BATCH rules' axes, with the divisibility fallback for this nb."""
        if self._mesh_rules is None:
            return ()
        ax = self._row_axes_cache.get(nb)
        if ax is None:
            from repro_torch.configs import base as axes
            from repro_torch.sharding.rules import spec_axes

            spec = self._mesh_rules.pspec((axes.BATCH, None), (nb, 1),
                                          name="uq_batch")
            ax = tuple(a for a in spec_axes(spec[0])
                       if self.mesh.shape[a] > 1)
            self._row_axes_cache[nb] = ax
        return ax

    def rows_of(self, nb: int) -> Tuple[int, int]:
        """This rank's rows ``[r0, r1)`` of a bucket of ``nb`` rows
        (``(0, nb)`` unsharded)."""
        ax = self._row_axes(nb)
        if not ax:
            return 0, nb
        n = nb // self.mesh.axes_size(ax)
        i = self.mesh.axes_index(ax)
        return i * n, (i + 1) * n

    def _sharded(self, nb: int) -> bool:
        return bool(self._member_axes or self._row_axes(nb))

    def _count_staged(self, nbytes: int) -> None:
        if nbytes:
            with self._counter_lock:
                self.collective_host_bytes += nbytes

    def gather_rows(self, t: torch.Tensor, nb: int) -> torch.Tensor:
        """A row-split tensor of a bucket of ``nb`` rows (dim 0 = this
        rank's rows) with every rank's rows, in order; ``t`` itself
        unsharded.  Every rank of the mesh must call it (a collective)."""
        ax = self._row_axes(nb)
        if not ax:
            return t
        out, staged = self.mesh.all_gather(t, ax)
        self._count_staged(staged)
        return out

    def sum_rows(self, t: torch.Tensor, nb: int) -> torch.Tensor:
        """The sum over the row ranks of a per-rank partial ``t`` (a count
        over this rank's rows); ``t`` itself unsharded.  A collective."""
        ax = self._row_axes(nb)
        return self.mesh.all_reduce_sum(t, ax) if ax else t

    def _gather_step(self, env: Dict[str, Any], src: str, dst: str,
                     axes: Tuple[str, ...]) -> Callable[[], int]:
        """A collective step: ``env[src]`` of every rank over ``axes``
        (dim 0) into the static buffer ``env[dst]``."""
        def gather() -> int:
            out, staged = self.mesh.all_gather(env[src], axes)
            if dst in env:
                env[dst].copy_(out)
            else:
                env[dst] = out
            return staged
        return gather

    def _mesh_steps(self, nb: int, n_valid, forward: Callable,
                    finish: Callable) -> Tuple[_Staged, Dict[str, Any]]:
        """A sharded program of a bucket of ``nb`` rows as a ``_Staged``,
        and the dict of buffers its steps share: ``forward(env)`` sets
        ``env['preds']`` (this rank's members on this rank's rows) and, for
        ``score_after``, ``env['x']`` (the rank's proposals); the
        predictions are gathered over the committee axes; ``committee_uq``
        runs on the rank's rows (``n_valid`` shifted to them) into
        ``env['packed_loc']``; the rows' statistics (and ``env['x']``) are
        gathered over the row axes into ``env['rows']``; ``finish(env)``
        runs over the whole batch."""
        r0, r1 = self.rows_of(nb)
        rows_ax = self._row_axes(nb)
        env: Dict[str, Any] = {}

        def uq():
            src = env["preds_all"] if self._member_axes else env["preds"]
            env["d"] = int(src.shape[2])
            env["nv"] = (n_valid - r0).clamp(0, r1 - r0)
            env["packed_loc"] = ops.committee_uq_packed(
                src, self.threshold, env["nv"], out=env.get("packed_loc"))
            if rows_ax:
                env["rows_loc"] = _row_matrix(*ref.packed_uq_views(
                    env["packed_loc"], r1 - r0, env["d"]),
                    *([env["x"]] if "x" in env else []))

        steps: List[Tuple[str, Callable]] = [("stage", lambda: forward(env))]
        if self._member_axes:
            steps.append(("coll", self._gather_step(
                env, "preds", "preds_all", self._member_axes)))
        steps.append(("stage", uq))
        if rows_ax:
            steps.append(("coll", self._gather_step(env, "rows_loc", "rows",
                                                    rows_ax)))
        steps.append(("stage", lambda: finish(env)))
        return _Staged(steps), env

    def _whole_packed(self, env: Dict[str, Any], packed, nb: int):
        """The packed statistics of the whole bucket: the rank's own when
        its rows are the bucket's, else the gathered rows written into
        ``packed`` (allocated at the first run when None)."""
        if not self._row_axes(nb):
            return env["packed_loc"]
        if packed is None:
            packed = torch.empty(ref.packed_uq_nbytes(nb, env["d"]),
                                 dtype=torch.uint8, device=self.device)
        _unpack_rows(env["rows"], packed, nb, env["d"])
        return packed

    def _score_steps(self, b: _Bucket) -> Tuple[_Staged, Dict[str, Any]]:
        """A sharded bucket's ``_Staged`` program (``_mesh_steps``): the
        rank's members on the rank's rows of the batch, then the rule
        pipeline over the whole batch writing the bucket's packed
        output."""
        r0, r1 = self.rows_of(b.nb)

        def forward(env):
            env["preds"] = self.apply(self._cparams, b.x[r0:r1]).contiguous()

        def finish(env):
            packed = self._whole_packed(env, b.packed, b.nb)
            if b.packed is None:
                b.set_output(packed)
            env["new_state"] = self._rules_body(
                b.packed, b.x, b.n_valid, b.stream, self.rule_state,
                want_stats=False)[0]

        return self._mesh_steps(b.nb, b.n_valid, forward, finish)

    def _run_program(self, b: _Bucket):
        if self._sharded(b.nb):
            if b.staged is None:
                b.staged, b.env = self._score_steps(b)
            self._count_staged(b.staged.run())
            return b.env["new_state"]
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
        Both run in ``graphs.capture``: one capture at a time (a committee
        trainer may capture in another thread), and the kernel's capture
        count is read around it."""
        def warmup():
            for _ in range(2):
                self._run_program(b)

        if self._sharded(b.nb):                 # a sharded bucket's stages
            if b.staged is None:
                b.staged, b.env = self._score_steps(b)
            launches = b.staged.capture(self._stream, warmup)
            graph, new_state = b.staged, b.env["new_state"]
        else:
            (graph,), ((_, new_state),), launches = graphs.capture(
                [lambda: self.program(self._cparams, b.x, b.n_valid,
                                      b.stream, self.rule_state,
                                      out=b.packed)],
                self._stream, warmup=warmup)
        b.launches = _cuq_launches(launches)
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
                if b.staged is not None:
                    self._count_staged(b.staged.replay())
                else:
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

    # ------------------------------------------------- fused step + score
    def place_carry(self, carry: Any, nb: int) -> Any:
        """A copy of the carried tree ``carry`` on the engine's device — the
        buffers a ``score_after`` caller then owns and passes every round.
        On a mesh whose bucket ``nb`` splits its rows, a leaf whose leading
        dimension is ``nb`` (per-walker state: positions, velocities, noise
        counters, patience counters) keeps this rank's rows
        (``rows_of(nb)``); every other leaf is copied whole (replicated)."""
        r0, r1 = self.rows_of(nb)
        split = (r0, r1) != (0, nb)

        def leaf(t):
            t = torch.as_tensor(t)
            if split and t.dim() and int(t.shape[0]) == nb:
                t = t[r0:r1]
            return t.to(self.device, copy=True)

        return self.carry_call(lambda: tree_map(leaf, carry))

    def carry_call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` (writes into, or reads of, a carry's buffers) ordered
        against every dispatch: under the enqueue lock, on the engine's
        stream after the caller's stream, which then waits for it.  Outside
        inference mode, whatever the caller's: the programs write the
        carry in place."""
        with self._enqueue_lock, torch.inference_mode(False):
            return self._on_stream(fn)

    def step_program(self, step_fn, react_fn, carry, n_valid, stream, rstate,
                     sb: _StepBucket):
        """The ``score_after`` program: ``step_fn(carry) -> (x, mid)``, the
        scoring body on ``x``, ``react_fn(mid, stats, mask)`` (or ``mid``)
        written back into ``carry``'s buffers, and the selected rows packed
        to the front of ``sb.sel_x`` in stable order (a cumsum compaction:
        output slot j takes the row where the running count of selected
        rows first reaches j + 1), their count into ``sb.n_sel``.  Reads
        nothing on the host.  Returns the rules' new state."""
        x, mid = step_fn(carry)
        packed, new_state, stats, mask = self._score_body(
            self._cparams, x, n_valid, stream, rstate, sb.packed,
            want_stats=True)
        if sb.packed is None:
            self._step_outputs(sb, packed, stats.mean.shape[1], x)
        new_carry = react_fn(mid, stats, mask) if react_fn is not None \
            else mid
        self._select(sb, x, mask)
        _write_carry(carry, new_carry)
        return new_state

    @staticmethod
    def _step_outputs(sb: _StepBucket, packed: torch.Tensor, d: int,
                      x: torch.Tensor) -> None:
        """Keep a step program's packed output and allocate its selection
        buffers (and their pinned host twins on the card)."""
        sb.packed, sb.d = packed, d
        sb.sel_x = torch.empty_like(x)
        if x.device.type == "cuda":
            sb.host_sel = torch.empty(tuple(x.shape), dtype=x.dtype,
                                      pin_memory=True)

    @staticmethod
    def _select(sb: _StepBucket, x: torch.Tensor, mask: torch.Tensor
                ) -> None:
        """The selected rows of ``x`` packed to the front of ``sb.sel_x``
        in stable order, their count into ``sb.n_sel``."""
        csum = torch.cumsum(mask.to(torch.int64), 0)
        rows = torch.searchsorted(csum, sb.ranks).clamp_(max=sb.nb - 1)
        torch.index_select(x, 0, rows, out=sb.sel_x)
        sb.n_sel.copy_(csum[-1:])

    def _step_steps(self, sb: _StepBucket, step_fn, react_fn, carry
                    ) -> Tuple[_Staged, Dict[str, Any]]:
        """A sharded ``score_after`` program (``_mesh_steps``): the step
        and the rank's members on the rank's rows of the carry, then the
        rule pipeline and the selection over the whole batch (the
        proposals gathered with the statistics) and the react on the
        rank's rows."""
        nb = sb.nb
        r0, r1 = self.rows_of(nb)
        split = bool(self._row_axes(nb))

        def forward(env):
            env["x"], env["mid"] = step_fn(carry)
            env["preds"] = self.apply(self._cparams, env["x"]).contiguous()

        def finish(env):
            d, x = env["d"], env["x"]
            if split:
                if sb.packed is None:
                    env["x_all"] = torch.empty((nb, x.shape[1]),
                                               dtype=x.dtype,
                                               device=self.device)
                env["x_all"].view(torch.int32).copy_(env["rows"][:, d + 4:])
            x_all = env["x_all"] if split else x
            packed = self._whole_packed(env, sb.packed, nb)
            if sb.packed is None:
                self._step_outputs(sb, packed, d, x_all)
            new_state, stats, mask = self._rules_body(
                sb.packed, x_all, sb.n_valid, sb.stream, self.rule_state,
                want_stats=True)
            if split:                    # the react sees this rank's rows
                stats = UQStats(
                    x=x, mean=stats.mean[r0:r1],
                    scalar_std=stats.scalar_std[r0:r1],
                    component_std=stats.component_std[r0:r1],
                    valid=stats.valid[r0:r1], n_valid=env["nv"],
                    stream=stats.stream,
                    finite_members=stats.finite_members[r0:r1])
            mid = env["mid"]
            new_carry = react_fn(mid, stats, mask[r0:r1]) \
                if react_fn is not None else mid
            self._select(sb, x_all, mask)
            _write_carry(carry, new_carry)
            env["new_state"] = new_state

        return self._mesh_steps(nb, sb.n_valid, forward, finish)

    def _run_step(self, sb: _StepBucket, step_fn, react_fn, carry):
        """One eager run of a step program; returns the rules' new state."""
        if not self._sharded(sb.nb):
            return self.step_program(step_fn, react_fn, carry, sb.n_valid,
                                     sb.stream, self.rule_state, sb)
        if sb.staged is None:
            sb.staged, sb.env = self._step_steps(sb, step_fn, react_fn,
                                                 carry)
        self._count_staged(sb.staged.run())
        return sb.env["new_state"]

    def _step_bucket(self, key: Tuple[str, int], carry: Any) -> _StepBucket:
        sb = self._step_buckets.get(key)
        if sb is None:
            with self._compile_lock:
                sb = self._step_buckets.get(key)
                if sb is None:
                    sb = self._on_stream(
                        lambda: _StepBucket(key[1], self.device))
                    sb.carry = tuple(tree_leaves(carry))
                    if not self.capture:
                        self.step_trace_counts[key] = \
                            self.step_trace_counts.get(key, 0) + 1
                    self._step_buckets[key] = sb
        leaves = tree_leaves(carry)
        if len(leaves) != len(sb.carry) or any(
                a is not b for a, b in zip(leaves, sb.carry)):
            raise ValueError(
                f"score_after {key}: the carry must keep the buffers of its "
                "first round (write new values into them, never rebind): "
                "the program reads and writes them in place")
        return sb

    def bind_step(self, cache_key: str, carry: Any, n: int, nb: int,
                  stream: int = STREAM_EXCHANGE) -> None:
        """Register ``carry`` as the (cache_key, nb) program's buffers and
        upload its ``n`` and ``stream`` now, so that no round of a caller
        that keeps them uploads anything."""
        sb = self._step_bucket((cache_key, nb), carry)
        with sb.lock:
            self.carry_call(lambda: self._upload_step(sb, int(n),
                                                      int(stream)))

    def _upload_step(self, sb: _StepBucket, n: int, stream: int) -> None:
        # caller holds sb.lock and the enqueue lock, on the engine's stream
        if sb.uploaded != (n, stream):
            sb.scalars.copy_(torch.tensor([n, stream], dtype=torch.int32))
            sb.uploaded = (n, stream)
            with self._counter_lock:
                self.bytes_to_device += 8

    def _capture_step(self, sb: _StepBucket, step_fn, react_fn, carry,
                      key) -> None:
        """``_capture`` for a ``score_after`` program.  Its warm-up runs
        advance the carry in place, so the carry is saved before them and
        restored after (capture itself runs nothing)."""
        def warmup():
            saved = [t.clone() for t in sb.carry]
            for _ in range(2):
                self._run_step(sb, step_fn, react_fn, carry)
            torch._foreach_copy_(list(sb.carry), saved)

        if self._sharded(sb.nb):                # a sharded bucket's stages
            if sb.staged is None:
                sb.staged, sb.env = self._step_steps(sb, step_fn, react_fn,
                                                     carry)
            launches = sb.staged.capture(self._stream, warmup)
            graph, new_state = sb.staged, sb.env["new_state"]
        else:
            (graph,), (new_state,), launches = graphs.capture(
                [lambda: self.step_program(step_fn, react_fn, carry,
                                           sb.n_valid, sb.stream,
                                           self.rule_state, sb)],
                self._stream, warmup=warmup)
        sb.launches = _cuq_launches(launches)
        sb.graph, sb.new_state = graph, new_state
        with self._counter_lock:
            self.step_trace_counts[key] = \
                self.step_trace_counts.get(key, 0) + 1

    def score_after(self, step_fn: Callable, carry: Any, n: int, nb: int,
                    *, react_fn: Optional[Callable] = None,
                    cache_key: str = "step", advance: bool = True,
                    stream: int = STREAM_EXCHANGE
                    ) -> Tuple[Any, FusedStepOut]:
        """Fuse a caller-supplied advance step with committee scoring:
        ``step_fn(carry) -> (x, mid)`` produces the (nb, in_dim) proposal
        batch inside the program, then the committee forward, the
        ``committee_uq`` statistics and the selection-rule pipeline run as
        in :meth:`score`, and ``react_fn(mid, stats, mask) -> new_carry``
        (e.g. the fleet's patience/restart update) folds the round's
        outcome back — written into ``carry``'s own buffers, which the
        program reads and writes in place.  One program per (cache_key,
        bucket): on the card a CUDA graph captured at first use (after a
        warm-up whose effect on the carry is undone) and replayed.

        ``carry`` is a tree of tensors on the engine's device that the
        caller owns (``place_carry``) and passes unchanged every round;
        ``n`` is the true row count and ``nb`` the padded bucket.  ``n``
        and ``stream`` are uploaded when they change (8 bytes), so the
        steady state uploads nothing; per call the host reads back the
        int32 selected count and then exactly the selected rows.

        Stateful-rule state is shared with :meth:`score` under the same
        ``_state_guard``, so a budget controller meters fleet and served
        traffic jointly; ``advance=False`` leaves it untouched.  Returns
        ``(carry, FusedStepOut)``: the same carry, updated."""
        key = (cache_key, nb)
        with torch.inference_mode(False):
            sb = self._step_bucket(key, carry)
            with self._state_guard(advance), sb.lock:
                n_sel, packed = self._step_dispatch(
                    sb, key, step_fn, react_fn, carry, int(n), int(stream),
                    advance)
                selected = self._selected_rows(sb, n_sel)
        mean, sstd, cstd, finite, mask = ref.packed_uq_views(
            packed, nb, sb.d)
        with self._counter_lock:
            self.step_dispatches += 1
            self.bytes_to_host += 4 + selected.nbytes
        return carry, FusedStepOut(
            n_selected=n_sel, selected=selected, mask=mask, mean=mean,
            scalar_std=sstd, component_std=cstd, finite_members=finite)

    def _step_dispatch(self, sb: _StepBucket, key, step_fn, react_fn, carry,
                       n: int, stream: int, advance: bool):
        """Run the step program once; returns the selected count (read back
        into pinned memory, one event wait) and a copy of the packed
        outputs on the device.  Caller holds ``sb.lock``."""
        with self._enqueue_lock, contextlib.ExitStack() as stack:
            if self._stream is not None:
                stack.enter_context(torch.cuda.stream(self._stream))
            self._upload_step(sb, n, stream)
            if self.capture:
                if sb.graph is None:
                    self._capture_step(sb, step_fn, react_fn, carry, key)
                if sb.staged is not None:
                    self._count_staged(sb.staged.replay())
                else:
                    sb.graph.replay()
                cuq_kernel.count_replays(sb.launches)
                new_state = sb.new_state
            else:
                new_state = self._run_step(sb, step_fn, react_fn, carry)
            if advance:
                _copy_leaves(self.rule_state, new_state)
            packed = sb.packed.clone()
            if self._stream is None:
                return int(sb.n_sel[0]), packed
            sb.host_n.copy_(sb.n_sel, non_blocking=True)
            sb.event.record(self._stream)
        sb.event.synchronize()
        return int(sb.host_n[0]), packed

    def _selected_rows(self, sb: _StepBucket, n_sel: int) -> np.ndarray:
        """Exactly the first ``n_sel`` rows of ``sb.sel_x``, on the host."""
        if n_sel == 0:
            return np.zeros((0,) + tuple(sb.sel_x.shape[1:]), np.float32)
        if self._stream is None:
            return sb.sel_x[:n_sel].numpy().copy()
        with self._enqueue_lock, torch.cuda.stream(self._stream):
            sb.host_sel[:n_sel].copy_(sb.sel_x[:n_sel], non_blocking=True)
            sb.event.record(self._stream)
        sb.event.synchronize()
        return sb.host_sel[:n_sel].numpy().copy()

    def synchronize(self) -> None:
        """Wait for the work queued on the engine's stream (nothing on the
        CPU)."""
        if self._stream is not None:
            self._stream.synchronize()

    # -------------------------------------------------------------- weights
    def _on_stream(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` ordered on the card against every dispatch: on the
        engine's stream, after the caller's stream, which then waits for
        it."""
        if self._stream is None:
            return fn()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        return out

    def _copy_into(self, dst: Any, src: Any) -> None:
        """Copy ``src``'s leaves into the engine's buffers ``dst``, ordered
        against every dispatch (``_on_stream``)."""
        self._on_stream(lambda: _copy_leaves(dst, src))

    def _load_params(self, cparams) -> None:
        """Copy ``cparams`` into the engine's buffers: the rank's members
        (on a mesh whose committee axes are split, a whole committee is cut
        to this rank's members first)."""
        cur = self._cparams
        local = self._members.stop - self._members.start
        if local != self._k and committee_size(cparams) == self._k:
            cparams = tree_map(lambda t: t[self._members], cparams)
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
        every leaf's shape must not change.  On a mesh ``cparams`` is the
        whole committee or this rank's members (a mesh trainer's
        ``snapshot_cparams``)."""
        k = committee_size(cparams)
        if k not in (self.size, self._members.stop - self._members.start):
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


def resolve_mesh(run_cfg):
    """``PALRunConfig.uq_mesh`` -> a ``launch/mesh.Mesh`` (or None).

    ''  (default) — no mesh: single-device dispatch.
    'host'        — ``make_host_mesh()``: the degenerate 1x1
                    ('data', 'model') mesh; the unsharded program.
    'scaleout'    — ``make_scaleout_mesh()``: every rank on the 'data'
                    axis (committee replicated, rows scale out).
    'DxM'         — e.g. ``'4x2'``: an explicit ('data', 'model') grid
                    over the first D*M ranks.
    'production'  — ``make_production_mesh()``: the 16x16 ('data',
                    'model') mesh (raises unless 256 ranks are up).

    Divisibility fallbacks are NOT silent: ``FusedEngine`` and
    ``CommitteeTrainer`` log a WARNING with the chosen fallback layout at
    construction (``sharding.rules.warn_fallbacks``).
    """
    name = getattr(run_cfg, "uq_mesh", "") or ""
    if not name:
        return None
    from repro_torch.launch import mesh as mesh_mod

    if name == "host":
        return mesh_mod.make_host_mesh()
    if name == "scaleout":
        return mesh_mod.make_scaleout_mesh()
    if name == "production":
        return mesh_mod.make_production_mesh()
    m = re.fullmatch(r"(\d+)x(\d+)", name)
    if m:
        return mesh_mod.make_scaleout_mesh(int(m.group(1)), int(m.group(2)))
    raise ValueError(f"uq_mesh={name!r}: expected '', 'host', 'scaleout', "
                     "'DxM' (e.g. '4x2') or 'production'")


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
    the user in control of raw predictions).  ``mesh`` /
    ``sharding_rules`` select the fused engine's mesh path; when ``mesh``
    is None it is resolved from ``run_cfg.uq_mesh`` (:func:`resolve_mesh`).
    The legacy path ignores meshes, as in the reference.

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
    if mesh is None:
        mesh = resolve_mesh(run_cfg)
    return FusedEngine(
        committee.apply_fn, committee.cparams, run_cfg.std_threshold,
        rules=rules,
        block_n=getattr(run_cfg, "uq_block_n", 128),
        min_bucket=getattr(run_cfg, "uq_bucket", 8),
        mesh=mesh, sharding_rules=sharding_rules,
        device=dev, capture=capture,
    )
