"""The controller kernel — two sub-controllers, as in the paper (Fig. 2):

* ``Exchange``: the high-frequency generator<->prediction loop.  Gathers
  proposals from every generator, scores them through the ONE acquisition
  engine (core/acquisition.UQEngine — committee forward, UQ statistics, and
  the device-side selection-rule pipeline in a single dispatch on fused
  backends), queues selected samples for the oracle, scatters committee
  means (with restart flags realized as ``None``, the paper's
  first-iteration semantics) back to generators.  There is no fast/legacy
  branching here: every backend returns the same ``UQResult`` and the loop
  body is identical.
* ``Manager``: oracle dispatch (first-available, point-to-point), labeled
  data collection into the training buffer, retrain_size-block release to
  trainers, dynamic oracle-buffer re-prioritization (consuming the SAME
  engine's ``UQResult`` — no stacked ``(K, n_buf, out_dim)`` host tensor,
  no float64 recompute), fault handling (timeout->requeue, dead-worker
  requeue), and AL-state checkpoints.

Both are plain objects with ``step()`` methods — the threaded runtime
(core/runtime.py) drives them, and tests drive them synchronously.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import acquisition as acq
from repro_torch.core import selection as sel
from repro_torch.core.buffers import OracleInputBuffer, TrainingDataBuffer
from repro_torch.core.fault import Heartbeat, TaskLedger
from repro_torch.core.monitor import Monitor
from repro_torch.core.transport import Channel, StopToken
from repro_torch.core.weight_sync import WeightStore


class PredictionPool:
    """The prediction kernel: committee members + their acquisition engine.

    All scoring flows through ``engine.score`` (core/acquisition.UQEngine).
    The engine decides HOW: fused backends run one compiled device program
    over the stacked committee; the legacy backend calls each
    ``UserModel(mode='predict').predict`` — the paper's per-process
    structure — via ``predict_all``.  A user ``predict_all_override``
    replaces the raw committee predictions and therefore forces the legacy
    backend (installed by the runtime / ``Exchange`` default).

    Weights refresh from the WeightStore at pull cadence (paper §2.1):
    fused engines refresh their stacked params directly; per-member models
    are pulled only when the engine actually uses them.
    """

    def __init__(self, models: Sequence[Any], store: Optional[WeightStore],
                 monitor: Optional[Monitor] = None,
                 engine: Optional[acq.UQEngine] = None,
                 predict_all_override: Optional[Callable] = None):
        self.models = list(models)
        self.store = store
        self.monitor = monitor or Monitor()
        self._versions = [-1] * len(self.models)
        self._override = predict_all_override
        self._engine: Optional[acq.UQEngine] = None
        self.engine = engine

    @property
    def engine(self) -> Optional[acq.UQEngine]:
        return self._engine

    @engine.setter
    def engine(self, eng: Optional[acq.UQEngine]):
        # invariant: a predict_all_override puts the user in control of the
        # raw committee predictions, so only backends that consume
        # predict_all (the legacy path) may score this pool — a fused
        # engine would silently bypass the override
        if (eng is not None and self._override is not None
                and not eng.uses_models):
            raise ValueError(
                "predict_all_override requires a legacy (per-member) UQ "
                "backend; a fused engine would bypass the override")
        self._engine = eng

    def refresh_weights(self):
        if self.store is None:
            return 0
        n = 0
        if self.engine is not None:
            n = self.engine.refresh_from(self.store)
        if self.engine is None or self.engine.uses_models:
            for i, m in enumerate(self.models):
                # prediction member i replicates training member
                # i % ml_process (paper: prediction models are replicas of
                # training models)
                packed = self.store.pull_packed(i % self.store.n_members,
                                                newer_than=self._versions[i])
                if packed is not None:
                    arr, v = packed
                    m.update(arr)
                    self._versions[i] = v
                    n += 1
        if n:
            self.monitor.incr("prediction.weight_refreshes", n)
        return n

    def predict_uq(self, list_data_to_pred: List[np.ndarray]) -> acq.UQResult:
        """The one scoring call: engine -> UQResult (mean, scalar_std,
        component_std, mask)."""
        with self.monitor.timer("exchange.predict"):
            return self.engine.score(list_data_to_pred)

    def predict_all(self, list_data_to_pred: List[np.ndarray]) -> np.ndarray:
        """-> (K, n_gen, out_dim) stacked committee predictions — the raw
        input of the legacy backend (and of user overrides)."""
        if self._override is not None:
            return np.asarray(self._override(list_data_to_pred))
        if not self.models:
            raise RuntimeError(
                "PredictionPool has no per-member models; fused engines "
                "never materialize stacked predictions")
        outs = [m.predict(list_data_to_pred) for m in self.models]
        return np.asarray(outs)


@dataclasses.dataclass
class ExchangeConfig:
    std_threshold: float = 0.05
    patience: int = 5
    weight_pull_every: int = 1       # exchange iterations between pulls
    progress_save_interval: float = 60.0
    flag_restart_with_none: bool = True
    min_interval: float = 0.0        # iteration floor (few-core fairness)


class Exchange:
    """High-frequency generator<->prediction loop (one dedicated
    sub-controller in the paper).

    The loop body is backend-agnostic: gather -> ``engine.score`` ->
    scatter.  If the PredictionPool arrives without an engine (direct
    construction in tests/tools), a legacy per-member engine with the
    config's threshold rule is installed — the runtime normally builds the
    engine from ``PALRunConfig`` via ``acquisition.make_engine``.
    """

    def __init__(
        self,
        generators: Sequence[Any],               # UserGene instances
        prediction: PredictionPool,
        oracle_buffer: OracleInputBuffer,
        cfg: ExchangeConfig,
        monitor: Optional[Monitor] = None,
        fleet=None,                              # exploration.WalkerFleet
    ):
        self.generators = list(generators)
        self.prediction = prediction
        self.oracle_buffer = oracle_buffer
        self.cfg = cfg
        self.monitor = monitor or Monitor()
        self.fleet = fleet
        if self.prediction.engine is None:
            self.prediction.engine = acq.LegacyEngine(
                self.prediction.predict_all, cfg.std_threshold)
        n = len(self.generators)
        self.data_to_gene: List[Optional[np.ndarray]] = [None] * n
        # gather buffer, preallocated and reused across iterations — the
        # per-iteration list rebuild was measurable against the fused
        # engine's single-dispatch scoring
        self._gather: List[Optional[np.ndarray]] = [None] * n
        self.patience = sel.PatienceTracker(n, cfg.patience)
        self.iteration = 0
        self._last_save = time.time()

    def step(self) -> Optional[StopToken]:
        if self.fleet is not None:
            return self._step_fleet()
        t0 = time.perf_counter()
        # 1. gather proposals from every generator (paper: MPI gather)
        inputs = self._gather
        for i, g in enumerate(self.generators):
            stop, x = g.generate_new_data(self.data_to_gene[i])
            if stop:
                # proposals gathered BEFORE the stopping generator would
                # otherwise be dropped un-scored — drain them first
                self._drain_on_stop(i)
                return StopToken(f"generator{i}", "generator stop criterion")
            inputs[i] = np.asarray(x)
        t_gen = time.perf_counter() - t0
        self.monitor.incr("exchange.gather_ns", int(t_gen * 1e9))

        # 2. committee inference + UQ + selection rules — one engine call
        #    (one device dispatch on fused backends)
        if self.iteration % max(1, self.cfg.weight_pull_every) == 0:
            self.prediction.refresh_weights()
        uq = self.prediction.predict_uq(inputs)

        # 3. realize the selection; queue to oracle; scatter back
        t1 = time.perf_counter()
        res = sel.selection_from_uq(inputs, uq,
                                    scatter_out=self.data_to_gene)
        # acquisition accounting: queued_to_oracle/proposals is the
        # realized oracle rate the cross-round budget controller
        # (core/budget.BudgetRule) steers toward PALRunConfig.oracle_budget
        self.monitor.incr("exchange.proposals", len(inputs))
        if res.inputs_to_oracle:
            self.oracle_buffer.put(res.inputs_to_oracle)
            self.monitor.incr("exchange.queued_to_oracle",
                              len(res.inputs_to_oracle))
        restart = self.patience.step(res.uncertain_mask)
        out = res.data_to_generators          # == self.data_to_gene, reused
        if self.cfg.flag_restart_with_none:
            for i in np.where(restart)[0]:
                out[int(i)] = None
        self.monitor.timer("exchange.comm").add(
            t_gen + (time.perf_counter() - t1))
        self.monitor.incr("exchange.iterations")
        self.iteration += 1

        # periodic progress save (paper: progress_save_interval)
        if (time.time() - self._last_save) >= self.cfg.progress_save_interval:
            for g in self.generators:
                g.save_progress()
            self._last_save = time.time()
        if self.cfg.min_interval:
            left = self.cfg.min_interval - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)
        return None

    def _drain_on_stop(self, n_gathered: int):
        """A StopToken mid-gather used to silently drop the proposals
        already gathered from earlier generators this iteration.  Score
        that prefix (advance=False — a partial round must not consume
        cross-round budget state) and queue whatever is selected, so no
        proposal vanishes on stop."""
        if n_gathered <= 0:
            return
        inputs = [self._gather[i] for i in range(n_gathered)]
        uq = self.prediction.engine.score(inputs, advance=False)
        res = sel.selection_from_uq(inputs, uq)
        if res.inputs_to_oracle:
            self.oracle_buffer.put(res.inputs_to_oracle)
            self.monitor.incr("exchange.queued_to_oracle",
                              len(res.inputs_to_oracle))
        self.monitor.incr("exchange.drained_on_stop", n_gathered)

    def _step_fleet(self) -> Optional[StopToken]:
        """Fleet fast path: the whole gather → score → select → scatter
        cycle is ONE fused device dispatch inside ``WalkerFleet.step``.
        The only per-iteration host traffic is the selected oracle
        candidates (plus one int32 count); patience/restart run as device
        rules, so the host ``PatienceTracker`` stays untouched."""
        t0 = time.perf_counter()
        if self.iteration % max(1, self.cfg.weight_pull_every) == 0:
            self.prediction.refresh_weights()
        with self.monitor.timer("exchange.predict"):
            out = self.fleet.step()
        self.monitor.incr("exchange.proposals", self.fleet.n_walkers)
        if out.n_selected:
            self.oracle_buffer.put(list(out.selected))
            self.monitor.incr("exchange.queued_to_oracle", out.n_selected)
        self.monitor.incr("exchange.iterations")
        self.iteration += 1
        max_steps = self.fleet.cfg.max_steps
        if max_steps and self.fleet.steps_done >= max_steps:
            return StopToken("fleet", "fleet max_steps reached")
        if self.cfg.min_interval:
            left = self.cfg.min_interval - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)
        return None


class OracleTaskFailure:
    """Result-channel sentinel: a worker exhausted its in-place retries on
    ONE task (FailurePolicy.task_retries) and is reporting the failure
    instead of dying.  The Manager redispatches the payload while ledger
    retries remain, then records the task as failed — task failure never
    becomes worker death, worker death never becomes run death."""

    __slots__ = ("error",)

    def __init__(self, error: str):
        self.error = error

    def __repr__(self):
        return f"OracleTaskFailure({self.error!r})"


def _payload_fp(payload) -> bytes:
    """Content fingerprint for oracle payloads (dtype+shape+bytes) — the
    dedupe key for requeued-task twins."""
    arr = np.ascontiguousarray(payload)
    return f"{arr.dtype.str}|{arr.shape}|".encode() + arr.tobytes()


@dataclasses.dataclass
class ManagerConfig:
    retrain_size: int = 20
    dynamic_oracle_list: bool = True
    oracle_timeout: float = 30.0
    max_oracle_retries: int = 2
    heartbeat_interval: float = 5.0
    # dynamic_oracle_list drop threshold: waiting inputs whose fresh
    # max-component committee std fell to or below this are dropped (stale —
    # the retrained committee is no longer uncertain about them).  The
    # runtime plumbs PALRunConfig.std_threshold here; 0.0 keeps entries with
    # any disagreement at all.
    std_threshold: float = 0.0


class OracleEndpoint:
    """Manager-side handle for one oracle worker: job + result channels."""

    def __init__(self, rank: str):
        self.rank = rank
        self.jobs = Channel(f"jobs:{rank}")
        self.results = Channel(f"results:{rank}")
        self.busy_task: Optional[int] = None


class Manager:
    """Oracle/training traffic sub-controller."""

    def __init__(
        self,
        oracle_buffer: OracleInputBuffer,
        train_buffer: TrainingDataBuffer,
        trainer_channels: Sequence[Channel],
        cfg: ManagerConfig,
        monitor: Optional[Monitor] = None,
        adjust_fn: Optional[Callable] = None,   # (items, UQResult) -> items
        fresh_score: Optional[Callable] = None,  # inputs -> UQResult
    ):
        self.oracle_buffer = oracle_buffer
        self.train_buffer = train_buffer
        self.trainer_channels = list(trainer_channels)
        self.cfg = cfg
        self.monitor = monitor or Monitor()
        self.ledger = TaskLedger(cfg.oracle_timeout, cfg.max_oracle_retries)
        self.heartbeat = Heartbeat(cfg.heartbeat_interval)
        self.endpoints: Dict[str, OracleEndpoint] = {}
        self.adjust_fn = adjust_fn
        self.fresh_score = fresh_score
        self.releases = 0
        self._retrain_completions_seen = 0
        # late-straggler dedupe state (keyed by payload fingerprint):
        # _requeued_fp counts payloads requeued by fault handling whose
        # original result may still arrive; _expect_duplicate counts twins
        # whose label was already delivered by that late result, so the
        # twin's own result must be dropped when it lands
        self._requeued_fp: Dict[bytes, int] = {}
        self._expect_duplicate: Dict[bytes, int] = {}

    # ------------------------------------------------------------ elasticity
    def register_oracle(self, rank: str) -> OracleEndpoint:
        ep = OracleEndpoint(rank)
        self.endpoints[rank] = ep
        self.heartbeat.beat(rank)
        return ep

    def unregister_oracle(self, rank: str):
        ep = self.endpoints.pop(rank, None)
        if ep is None:
            return
        for t in self.ledger.requeue_worker(rank):
            self._note_requeued(t.payload)
            self.oracle_buffer.put([t.payload])
        self.heartbeat.forget(rank)

    def requeue_crashed_worker(self, rank: str):
        """Crash-recovery hook (runtime ``on_crash``): pull the crashed
        worker's in-flight tasks back into the oracle buffer and free its
        endpoint, WITHOUT unregistering — the supervised restart re-enters
        the same rank.  A result the worker managed to send before dying is
        then absorbed by the late-straggler dedupe path."""
        ep = self.endpoints.get(rank)
        if ep is not None:
            ep.busy_task = None
        for t in self.ledger.requeue_worker(rank):
            self._note_requeued(t.payload)
            self.oracle_buffer.put([t.payload])
        self.monitor.incr("manager.requeued_crash")

    def _note_requeued(self, payload):
        fp = _payload_fp(payload)
        self._requeued_fp[fp] = self._requeued_fp.get(fp, 0) + 1

    # ---------------------------------------------------------------- step
    def step(self, retrain_completions: int = 0) -> None:
        self._collect_results()
        self._handle_faults()
        self._dispatch()
        self._release_training_data()
        if (self.cfg.dynamic_oracle_list
                and retrain_completions > self._retrain_completions_seen):
            self._retrain_completions_seen = retrain_completions
            self._adjust_oracle_buffer()

    def _collect_results(self):
        for ep in list(self.endpoints.values()):
            while ep.results.poll():
                task_id, inp, label = ep.results.recv()
                self.heartbeat.beat(ep.rank)
                if ep.busy_task == task_id:
                    ep.busy_task = None
                t = self.ledger.complete(task_id)
                if isinstance(label, OracleTaskFailure):
                    self._handle_task_failure(t, label)
                    continue
                if t is None:
                    self._handle_late_result(inp, label)
                    continue
                fp = _payload_fp(t.payload)
                if self._expect_duplicate.get(fp, 0) > 0:
                    # this task's payload was already labeled by its timed-out
                    # twin's late result — adding it again would duplicate a
                    # training row
                    self._dec(self._expect_duplicate, fp)
                    self.monitor.incr("oracle.duplicate_results")
                    continue
                if self._requeued_fp.get(fp, 0) > 0:
                    # the requeued twin delivered first: any late straggler
                    # for this payload is now a duplicate, not a usable label
                    self._dec(self._requeued_fp, fp)
                if not self._label_ok(label):
                    self._handle_bad_label(t)
                    continue
                self.train_buffer.add(inp, label)
                self.monitor.incr("manager.labeled")

    @staticmethod
    def _label_ok(label) -> bool:
        lab = np.asarray(label)
        if lab.dtype.kind != "f":
            return True
        return bool(np.isfinite(lab).all())

    @staticmethod
    def _dec(counts: Dict[bytes, int], fp: bytes):
        n = counts.get(fp, 0) - 1
        if n > 0:
            counts[fp] = n
        else:
            counts.pop(fp, None)

    def _handle_task_failure(self, t, failure: OracleTaskFailure):
        """Worker-reported task failure (retries exhausted in place)."""
        self.monitor.incr("oracle.task_failures_reported")
        if t is None:       # already requeued by timeout — twin handles it
            return
        if t.retries < self.ledger.max_retries:
            self._redispatch(t.payload, t.retries + 1)
        else:
            self.ledger.fail(t)
            self.monitor.incr("oracle.task_gave_up")

    def _handle_bad_label(self, t):
        """Non-finite label (chaos nan_label / genuinely broken oracle):
        never admit it to the training buffer; retry the task elsewhere."""
        self.monitor.incr("oracle.nonfinite_labels")
        if t.retries < self.ledger.max_retries:
            self._redispatch(t.payload, t.retries + 1)
        else:
            self.ledger.fail(t)
            self.monitor.incr("oracle.task_gave_up")

    def _handle_late_result(self, inp, label):
        """Result for a task the ledger already requeued (timeout / dead or
        crashed worker).  The old behavior discarded the label and let the
        twin recompute it — wasted oracle work, and the only guard against
        DOUBLE-labeling was the discard itself.  Now: if the twin has not
        delivered yet, USE this label and cancel the twin (drop it from the
        buffer if still queued, else mark its future result a duplicate);
        if the twin already delivered, this is a true duplicate."""
        fp = _payload_fp(inp)
        if self._requeued_fp.get(fp, 0) > 0 and self._label_ok(label):
            self._dec(self._requeued_fp, fp)
            self.train_buffer.add(inp, label)
            self.monitor.incr("manager.labeled")
            self.monitor.incr("manager.late_results_used")
            if not self.oracle_buffer.remove_one(
                    lambda item: _payload_fp(item) == fp):
                # twin already dispatched (or mid-flight): its result must
                # be dropped when it arrives
                self._expect_duplicate[fp] = \
                    self._expect_duplicate.get(fp, 0) + 1
            return
        self.monitor.incr("oracle.duplicate_results")
        self.monitor.incr("manager.duplicate_results")

    def _handle_faults(self):
        for t in self.ledger.expired():
            self.monitor.incr("manager.requeued_timeout")
            ep = self.endpoints.get(t.worker)
            if ep is not None and ep.busy_task == t.task_id:
                ep.busy_task = None
            self._note_requeued(t.payload)
            self._redispatch(t.payload, t.retries + 1)
        for rank in self.heartbeat.dead_workers():
            self.monitor.incr("manager.dead_workers")
            ep = self.endpoints.get(rank)
            if ep is not None:
                ep.busy_task = None
            for t in self.ledger.requeue_worker(rank):
                self._note_requeued(t.payload)
                self._redispatch(t.payload, t.retries + 1)

    def _redispatch(self, payload, retries: int):
        ep = self._free_endpoint()
        if ep is None:
            self.oracle_buffer.put([payload])
            return
        tid = self.ledger.dispatch(payload, ep.rank, retries)
        ep.busy_task = tid
        ep.jobs.isend((tid, payload))

    def _free_endpoint(self) -> Optional[OracleEndpoint]:
        # list() copy: workers register/unregister concurrently
        for ep in list(self.endpoints.values()):
            if ep.busy_task is None and not self.heartbeat.is_dead(ep.rank):
                return ep
        return None

    def _dispatch(self):
        """Paper §2.5: buffered data sent to the first available oracle."""
        while True:
            ep = self._free_endpoint()
            if ep is None:
                return
            payload = self.oracle_buffer.pop()
            if payload is None:
                return
            tid = self.ledger.dispatch(payload, ep.rank)
            ep.busy_task = tid
            ep.jobs.isend((tid, payload))
            self.monitor.incr("manager.dispatched")

    def _release_training_data(self):
        """Broadcast retrain_size blocks to every trainer (paper §2.5)."""
        while self.train_buffer.ready():
            block = self.train_buffer.release()
            for ch in self.trainer_channels:
                ch.isend(block)
            self.releases += 1
            self.monitor.incr("manager.releases")

    def _adjust_oracle_buffer(self):
        """dynamic_oracle_list: re-score waiting inputs with the freshest
        committee and drop/reorder (paper SI Utilities).

        ``fresh_score`` is the SAME acquisition engine the exchange loop
        uses — one ``UQResult`` (scalar_std for the drop decision,
        component_std for the ranking) replaces the former stacked
        ``(K, n_buf, out_dim)`` host tensor + float64 recompute."""
        if self.fresh_score is None:
            return
        items, enq0 = self.oracle_buffer.snapshot_for_adjust()
        if not items:
            return
        uq = self.fresh_score(items)
        if self.adjust_fn is not None:
            new_items = self.adjust_fn(items, uq)
        else:
            # honor_selection: whatever the engine's rule pipeline just
            # re-selected survives even below the drop threshold, so a
            # custom policy (e.g. top-fraction) is never contradicted here
            new_items = sel.adjust_input_for_oracle_uq(
                items, uq, self.cfg.std_threshold, honor_selection=True)
        # merge, don't restore: the Exchange thread kept enqueueing while
        # the engine scored the snapshot — those must survive un-dropped
        self.oracle_buffer.merge_adjusted(new_items, enq0,
                                          snapshot_len=len(items))
        self.monitor.incr("manager.buffer_adjusts")
