"""PAL runtime: wires the five kernels into a running, fault-tolerant,
checkpointable system (paper Fig. 2), on the CUDA card or the CPU.

Acquisition is config-driven: ``PAL.__init__`` builds ONE
``core/acquisition.UQEngine`` from ``PALRunConfig`` (``uq_impl`` /
``uq_bucket`` / ``std_threshold`` / the budget knobs) via
``acquisition.make_engine`` and installs it on the PredictionPool; the
Exchange hot loop and the Manager's ``dynamic_oracle_list`` consume the
same engine's ``UQResult``.  Pass ``committee=CommitteeSpec(apply_fn,
cparams)`` to get the fused engine (on the card one captured CUDA graph per
shape bucket, replayed by every exchange round, Manager re-score and served
microbatch); omit it and the engine falls back to per-member
``UserModel.predict`` (the paper's structure, float64 host statistics) with
identical selection semantics.

Training is config-driven the same way: pass ``loss_fn=`` alongside the
``CommitteeSpec`` and the per-member ``ml_process`` trainer threads collapse
into ONE ``training/committee_trainer.CommitteeTrainer`` loop — all K
members advance in one step program (one CUDA graph replay on the card) per
step (``PALRunConfig.train_steps`` / ``train_batch`` / ``train_lr`` /
``train_bootstrap``), fed from a device-resident replay ring, with refreshed
weights copied into the acquisition engine device-to-device
(``FusedEngine.refresh_from_device`` — no packed host round trip).  Omit
``loss_fn`` and the per-member ``make_model(..., 'train')`` factories remain
the legacy path, publishing packed weights through ``WeightStore``.

``device=`` places the engine and the trainer: the CUDA device by default
(raises without CUDA), ``"cpu"`` for the plain PyTorch path.

In-process realization: each kernel pool runs on threads (PyTorch releases
the GIL inside its kernels and while the host waits on the device, so
committee inference, retraining and oracle calls overlap); the transport
layer is MPI-shaped so the controller logic matches the paper's
process-based structure.  Every loop thread keeps PyTorch's default grad
mode: the engine and the trainer need autograd inside their programs.

Beyond the paper: whole-state checkpoint/restart (including requeue of
dispatched-but-unlabeled oracle work), oracle heartbeats with
timeout->requeue, elastic pool resize, supervised loops with chaos
injection, and monitoring (see core/fault.py, core/supervisor.py,
core/chaos.py, core/al_checkpoint.py, core/monitor.py).

``fleet_walkers > 0`` replaces the host generators with ONE
device-resident ``exploration.WalkerFleet`` on the engine's device: each
exchange round is one ``FusedEngine.score_after`` program (on the card one
captured CUDA graph replay) that advances, scores and selects every walker.

``mesh=`` / ``sharding_rules=`` (or ``PALRunConfig.uq_mesh``) put the
engine on a ``launch/mesh.Mesh`` and hand the engine's mesh to the trainer,
as the reference does.  A mesh of one process (``uq_mesh='host'``, or any
mesh of a one-rank process group) runs the unsharded program.

A mesh of more than one process (``launch/distributed.initialize`` or
``initialize_from_config`` first, on every rank) runs the reference's
single-controller loop as one leader and its followers.  Every rank builds
the same engine, trainer and fleet from the same global inputs; the
leader (the mesh's first rank) runs the paper's loop as above.  Each call
that touches the mesh (scoring, the fleet's steps, the trainer's rounds
and blocks, the handoff, snapshots) goes through one of two ordered lanes
(``core/dispatch.py``): the engine lane (engine and fleet) and the trainer
lane (trainer), so scoring and training still overlap.  A follower runs no
host kernel: its lanes make the leader's calls, in the leader's order, on
its own objects.  The trainer's stop-early decision is the leader's, sent
after every step; the handoff is a snapshot taken on the trainer lane and
taken up by id on the engine lane, so every rank's engine gets the same
step's weights.  The leader's lanes start at construction; a follower's
start in ``start()``, which ``run()`` calls, and its lanes make no call
before then (the leader's first call waits for them, at most
``dispatch.TIMEOUT_S``).  ``run()`` on a follower returns the leader's
stop token; every rank must end with ``run()`` or ``shutdown()``.  A call
that fails on any rank ends the run on every rank within
``dispatch.TIMEOUT_S``, and ``run()`` raises that rank's traceback.  The
leader writes checkpoints; every rank restores from the same file.  Chaos
runs on the leader; a fault that changes device state reaches the
followers as a lane call.  The legacy engine ignores the mesh (as in the
reference): its followers only wait for the stop.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.pal_potential import PALRunConfig
from repro_torch.core import acquisition as acq
from repro_torch.core import committee as cmte
from repro_torch.core import dispatch, transport
from repro_torch.core.al_checkpoint import ALCheckpointer
from repro_torch.core.buffers import OracleInputBuffer, TrainingDataBuffer
from repro_torch.core.chaos import ChaosCrash, ChaosInjector, FaultPlan
from repro_torch.core.controller import (
    Exchange, ExchangeConfig, Manager, ManagerConfig, OracleTaskFailure,
    PredictionPool,
)
from repro_torch.core.fault import ElasticPool
from repro_torch.core.monitor import Monitor
from repro_torch.core.supervisor import Supervisor, policies_from_config
from repro_torch.core.transport import Channel, StopToken
from repro_torch.core.weight_sync import WeightStore, WeightSyncPolicy
from repro_torch.launch.platform import DeviceLike, resolve_device

log = logging.getLogger(__name__)


class PAL:
    """The parallel active-learning workflow.

    Parameters mirror the paper's AL_SETTING (SI S3): user supplies
    generator / model / oracle factories plus optional utils functions.

    On a mesh of several processes every rank builds the same ``PAL``;
    ``leader`` is True on the mesh's first rank, which runs the loop, and
    its ``engine``, ``fleet`` and ``committee_trainer`` are lane proxies
    (``core/dispatch.py``).  The leader's lanes start at construction, so
    it may step the loop by hand; a follower's start in ``start()``
    (which ``run()`` calls), so nothing its owner does between
    construction and ``run()`` races the leader's calls.  A follower's
    ``run()`` makes the leader's mesh calls until the leader stops; one
    that has not called it within ``dispatch.TIMEOUT_S`` of the leader's
    first call breaks the leader's lane with a ``LaneError`` that names
    it.  ``lane_error`` holds a broken lane's error, which ``run()``
    raises (module docstring).
    """

    def __init__(
        self,
        run_cfg: PALRunConfig,
        *,
        make_generator: Callable[[int, str], Any],        # rank, result_dir
        make_model: Optional[Callable[[int, str, int, str], Any]] = None,
        make_oracle: Callable[[int, str], Any],
        committee: Optional[acq.CommitteeSpec] = None,
        loss_fn: Optional[Callable] = None,
        rules: Optional[Sequence[acq.SelectionRule]] = None,
        adjust_input_for_oracle: Optional[Callable] = None,
        predict_all_override: Optional[Callable] = None,
        mesh=None,
        sharding_rules=None,
        resume: bool = False,
        chaos: Optional[Union[FaultPlan, ChaosInjector]] = None,
        fleet_init: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        if mesh is None:
            mesh = acq.resolve_mesh(run_cfg)
        self.device = resolve_device(device)
        self.cfg = run_cfg
        self.monitor = Monitor()
        self.stop_event = threading.Event()
        self.stop_token: Optional[StopToken] = None
        rd = run_cfg.result_dir
        # a mesh of several processes: one leader, followers, two lanes
        self._engine_lane = self._trainer_lane = None
        self.lane_error: Optional[BaseException] = None
        if mesh is not None and mesh.size > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"PAL on a mesh of {mesh.size} ranks ({mesh.shape}) "
                    "needs a process group: call launch/distributed."
                    "initialize (or initialize_from_config) on every rank "
                    "first")
            mesh.coordinate()                  # raises off the mesh
            self._engine_lane, self._trainer_lane = (
                dispatch.Lane(name, mesh, self.device,
                              on_stop=self._signal_stop,
                              on_error=self._lane_failed)
                for name in ("engine", "trainer"))
            mesh = self._engine_lane.mesh
        self.leader = self._engine_lane is None or self._engine_lane.leader
        # deterministic fault injection (core/chaos.py): a FaultPlan makes
        # this run execute a scheduled fault sequence — tests drive
        # recovery behavior through it (on the leader: followers run no
        # loop)
        if chaos is not None and not isinstance(chaos, ChaosInjector):
            chaos = ChaosInjector(chaos, monitor=self.monitor)
        self.chaos: Optional[ChaosInjector] = chaos if self.leader else None

        # fused committee training: one CommitteeTrainer loop instead of
        # ml_process per-member trainer threads (loss_fn needs the stacked
        # committee params, hence the CommitteeSpec requirement)
        if loss_fn is not None and committee is None:
            raise ValueError(
                "loss_fn= enables the fused committee trainer, which needs "
                "committee=CommitteeSpec(apply_fn, cparams) for the stacked "
                "member params; pass one or use per-member make_model "
                "trainers")
        fused_training = loss_fn is not None

        # --- kernel instances (paper: one object per MPI process) ----------
        # fleet_walkers > 0: the gene_process host generators are replaced
        # by ONE device-resident WalkerFleet (built below, after the
        # engine) — host generator instances are only touched to derive
        # the fleet's trusted initial states when no fleet_init= is given
        use_fleet = getattr(run_cfg, "fleet_walkers", 0) > 0
        # followers build no host kernel: generators, per-member models
        # and oracles run on the leader
        self.generators = [] if use_fleet or not self.leader else \
            [make_generator(i, rd) for i in range(run_cfg.gene_process)]
        # per-member prediction models exist only for the legacy backend
        # without a predict_all_override; fused engines score the stacked
        # committee directly (and an override supplies raw predictions
        # itself), so pred_process full model instances would be dead weight
        need_models = (predict_all_override is None
                       and acq.wants_legacy(run_cfg, committee))
        if (need_models or not fused_training) and make_model is None:
            raise ValueError(
                "make_model= is required unless a CommitteeSpec supplies "
                "prediction (fused engine) and a loss_fn supplies training "
                "(fused committee trainer)")
        self.predictors = [make_model(i, rd, i, "predict")
                           for i in range(run_cfg.pred_process)] \
            if need_models and self.leader else []
        self.trainers = [] if fused_training or not self.leader else \
            [make_model(i, rd, i, "train")
             for i in range(run_cfg.ml_process)]
        self._make_oracle = make_oracle
        self._oracle_instances: Dict[str, Any] = {}

        # --- controller state ----------------------------------------------
        # fused training: the store is demoted to the checkpoint wire format
        # / legacy-backend pull path, sized by committee members (K) rather
        # than trainer processes; the Manager broadcasts released blocks to
        # ONE trainer channel
        n_train_lanes = 1 if fused_training else run_cfg.ml_process
        n_store = acq.committee_size(committee.cparams) \
            if fused_training else run_cfg.ml_process
        self.store = WeightStore(n_store)
        self.oracle_buffer = OracleInputBuffer()
        self.train_buffer = TrainingDataBuffer(run_cfg.retrain_size)
        self.trainer_channels = [Channel(f"manager->trainer{i}")
                                 for i in range(n_train_lanes)]

        self.prediction_pool = PredictionPool(
            self.predictors, self.store, self.monitor,
            predict_all_override=predict_all_override)
        # ONE acquisition engine from config — exchange hot loop and
        # dynamic_oracle_list both consume its UQResult (a user
        # predict_all_override controls the raw predictions, so it forces
        # the legacy backend)
        self.engine = acq.make_engine(
            run_cfg, committee=committee, rules=rules,
            predict_all=self.prediction_pool.predict_all,
            force_legacy=predict_all_override is not None,
            mesh=mesh, sharding_rules=sharding_rules, device=self.device)
        self.prediction_pool.engine = self.engine
        # every rank runs the engine's, fleet's and trainer's mesh calls (a
        # legacy engine ignores the mesh: then only the leader works)
        spmd = (self._engine_lane is not None
                and getattr(self.engine, "mesh", None) is not None)

        # --- fused committee trainer (training/committee_trainer.py) -------
        # trains the SAME stacked layout the engine scores, on PAL's device:
        # the trainer reuses the engine's resolved mesh (on several ranks
        # its twin on the trainer lane: collective groups of its own)
        self.committee_trainer = None
        if fused_training:
            from repro_torch.optim.memory_policy import MemoryPolicy
            from repro_torch.training.committee_trainer import (
                CommitteeTrainer,
            )

            policy = dataclasses.replace(
                MemoryPolicy.named(
                    getattr(run_cfg, "train_memory_policy", "fp32")),
                replay_dtype=getattr(run_cfg, "train_replay_dtype",
                                     "float32"))
            self.committee_trainer = CommitteeTrainer(
                loss_fn, committee.cparams,
                steps=run_cfg.train_steps,
                batch=run_cfg.train_batch,
                lr=run_cfg.train_lr,
                bootstrap=run_cfg.train_bootstrap,
                replay_capacity=run_cfg.train_replay_capacity,
                mesh=(self._trainer_lane.mesh if spmd
                      else getattr(self.engine, "mesh", None)),
                sharding_rules=sharding_rules,
                seed=run_cfg.seed,
                monitor=self.monitor,
                memory_policy=policy,
                device=self.device)
        # --- device-resident exploration fleet (exploration/fleet.py) ------
        # one stacked walker state on the engine's device, advanced +
        # scored + selected in a single fused program per exchange
        # iteration; trusted initial states come from fleet_init= or the
        # first proposal of each make_generator(rank)
        self.fleet = None
        if use_fleet:
            from repro_torch.exploration.fleet import FleetConfig, WalkerFleet

            if not hasattr(self.engine, "score_after"):
                raise ValueError(
                    "fleet_walkers > 0 needs a fused acquisition engine — "
                    "pass committee=CommitteeSpec(apply_fn, cparams) (the "
                    "legacy per-member backend cannot fuse the walker "
                    "advance with scoring)")
            x0 = None
            if fleet_init is not None:
                x0 = np.asarray(fleet_init, np.float32)
            elif self.leader:
                x0 = np.stack([
                    np.asarray(make_generator(i, rd).generate_new_data(
                        None)[1], np.float32).reshape(-1)
                    for i in range(run_cfg.fleet_walkers)])
            if spmd:                # the leader's states, never drawn per rank
                x0 = self._engine_lane.share(x0)
            self.fleet = WalkerFleet(
                self.engine, x0,
                FleetConfig(
                    dt=run_cfg.fleet_dt,
                    clip=run_cfg.fleet_clip,
                    noise=run_cfg.fleet_noise,
                    friction=run_cfg.fleet_friction,
                    sampler=run_cfg.fleet_sampler,
                    patience=(run_cfg.fleet_patience
                              or run_cfg.patience),
                    max_steps=run_cfg.fleet_max_steps,
                    seed=run_cfg.seed,
                ),
                monitor=self.monitor, chaos=None if spmd else self.chaos)
        self.exchange = Exchange(
            self.generators, self.prediction_pool, self.oracle_buffer,
            ExchangeConfig(
                std_threshold=run_cfg.std_threshold,
                patience=run_cfg.patience,
                weight_pull_every=run_cfg.weight_sync_every,
                progress_save_interval=run_cfg.progress_save_interval,
                min_interval=run_cfg.exchange_min_interval,
            ),
            self.monitor,
            fleet=self.fleet,
        )

        def fresh_score(items):
            # own timer: buffer re-scoring (incl. first-time captures of
            # buffer-sized shape buckets) must not pollute the exchange
            # hot-path metric.  advance=False: re-scoring the waiting
            # buffer is a read-only query — it must not advance the
            # cross-round budget controller / re-weighting state, or every
            # retrain completion would charge a phantom exchange round
            # against the oracle budget
            with self.monitor.timer("manager.fresh_score"):
                return self.engine.score([np.asarray(x) for x in items],
                                         advance=False)

        self.manager = Manager(
            self.oracle_buffer, self.train_buffer, self.trainer_channels,
            ManagerConfig(
                retrain_size=run_cfg.retrain_size,
                dynamic_oracle_list=run_cfg.dynamic_oracle_list,
                oracle_timeout=run_cfg.oracle_timeout,
                max_oracle_retries=run_cfg.max_oracle_retries,
                std_threshold=run_cfg.std_threshold,
            ),
            self.monitor,
            adjust_fn=adjust_input_for_oracle,
            fresh_score=fresh_score,
        )

        # --- serving: batch-level UQ for served ensembles --------------------
        # the SAME engine serves online requests: served batches get a
        # UQResult and high-uncertainty requests feed the oracle buffer
        # through the same budget controller as the exchange loop (on the
        # leader: its microbatches reach the followers as engine-lane calls)
        self.server = None
        self.serve_queue = None
        if getattr(run_cfg, "serve_uq", False) and self.leader:
            from repro_torch.serving.engine import CommitteeServer

            self.server = CommitteeServer(
                self.engine, self.oracle_buffer, monitor=self.monitor,
                device=getattr(self.engine, "device", self.device))
            # queue-batched serving tier: many small requests -> one fused
            # dispatch (serving/queue.py), multi-tenant fairness + rate
            # limits + adaptive deadline + LSH answer cache
            if getattr(run_cfg, "serve_max_batch", 0) > 0:
                from repro_torch.serving.queue import (
                    QueueConfig, ServingQueue,
                )

                cache = None
                if int(getattr(run_cfg, "serve_cache_buckets", 0)) > 0:
                    from repro_torch.serving.cache import LSHAnswerCache

                    cache = LSHAnswerCache(
                        int(run_cfg.serve_cache_buckets),
                        std_max=float(
                            getattr(run_cfg, "serve_cache_std_max", 0.0)
                            or run_cfg.std_threshold),
                        tol=float(getattr(run_cfg, "serve_cache_tol", 0.0)),
                        seed=int(run_cfg.seed))
                self.serve_queue = ServingQueue(
                    self.server,
                    QueueConfig(
                        max_batch=int(run_cfg.serve_max_batch),
                        max_wait_ms=float(getattr(
                            run_cfg, "serve_max_wait_ms", 2.0)),
                        shed_pending=int(getattr(
                            run_cfg, "serve_shed_pending", 0)),
                        breaker_failures=int(getattr(
                            run_cfg, "serve_breaker_failures", 0)),
                        breaker_reset_s=float(getattr(
                            run_cfg, "serve_breaker_reset_s", 5.0)),
                        rate_limit=float(getattr(
                            run_cfg, "serve_rate_limit", 0.0)),
                        rate_burst=float(getattr(
                            run_cfg, "serve_rate_burst", 0.0)),
                        latency_target_ms=float(getattr(
                            run_cfg, "serve_latency_target_ms", 0.0)),
                        wait_min_ms=float(getattr(
                            run_cfg, "serve_wait_min_ms", 0.05)),
                        wait_max_ms=float(getattr(
                            run_cfg, "serve_wait_max_ms", 50.0)),
                        latency_window=int(getattr(
                            run_cfg, "serve_latency_window", 64))),
                    monitor=self.monitor,
                    cache=cache)

        # --- runtime machinery ----------------------------------------------
        self._threads: List[threading.Thread] = []
        # supervised execution (core/supervisor.py): kernel loops restart
        # with backoff on crash; escalation to StopToken only after a loop
        # burns through its FailurePolicy crash budget.  supervise=False
        # maps to max_crashes=1 — fail-stop through the same path
        self.supervisor = Supervisor(
            self.monitor,
            lambda name, reason: self._signal_stop(StopToken(name, reason)),
            self.stop_event,
            policies=policies_from_config(run_cfg),
            seed=run_cfg.seed)
        # the serving tier reports through the supervisor too: one
        # snapshot() is the whole degradation surface
        if self.serve_queue is not None:
            self.supervisor.register_health(
                "serve_queue", self.serve_queue.health)
        # trainer crash recovery: the parked trainer-channel irecv and the
        # trained-round dirty flag live OUTSIDE the loop body, so a
        # supervised restart resumes the round (replay ring + TrainState are
        # device-resident and survive) instead of replaying or losing blocks
        self._trainer_pending: Dict[int, Any] = {}
        self._trainer_dirty: Dict[int, bool] = {}
        self._last_ckpt_iter = 0
        # retrain-completion counter: incremented by EVERY trainer thread on
        # the legacy path — the read-modify-write must be lock-guarded or
        # concurrent completions are lost and dynamic_oracle_list re-scoring
        # silently skips rounds
        self._retrain_completions = 0
        self._retrain_lock = threading.Lock()
        # manager wake: set whenever new work lands (oracle-buffer put,
        # oracle result, retrain completion) so the manager loop blocks on
        # an event-or-timeout wait instead of a fixed 2 ms sleep
        self._manager_wake = threading.Event()
        self.oracle_buffer.on_put = self._manager_wake.set
        self._sync_policies = [WeightSyncPolicy(run_cfg.weight_sync_every)
                               for _ in range(n_train_lanes)]
        self.checkpointer = ALCheckpointer(rd, run_cfg.checkpoint_every)
        self.oracle_pool = ElasticPool("oracle", self._oracle_worker)
        self._handoff: Optional[_Handoff] = None
        self._last_fleet_stats: Optional[Dict[str, Any]] = None
        if resume:
            self._restore()                    # every rank, the same file
        if self._engine_lane is not None:
            self._on_lanes(spmd)

    # ----------------------------------------------------------------- lanes
    def _on_lanes(self, spmd: bool):
        """Put the mesh objects on the lanes, and start the leader's (it
        may step the loop by hand at once; a follower's start in
        ``start()``).  On the leader the controllers' engine, fleet and
        trainer become the lanes' proxies; a legacy engine's run is the
        leader's alone."""
        el, tl = self._engine_lane, self._trainer_lane
        if spmd:
            el.register("engine", self.engine)
            if self.fleet is not None:
                el.register("fleet", self.fleet)
                el.register("pal", self)        # _keep_fleet_stats
            if self.committee_trainer is not None:
                self._handoff = _Handoff(self.committee_trainer, self.engine)
                tl.register("trainer", self.committee_trainer)
                tl.register("round", _Round(self.committee_trainer, tl))
                tl.register("handoff", self._handoff)
                el.register("handoff", self._handoff)
            if self.leader:
                self.engine = _EngineOnLane(el, self.engine)
                self.prediction_pool.engine = self.engine
                if self.server is not None:
                    self.server.engine = self.engine
                if self.fleet is not None:
                    self.fleet = _FleetOnLane(el, self.fleet, self.chaos)
                    self.exchange.fleet = self.fleet
                if self.committee_trainer is not None:
                    self.committee_trainer = _TrainerOnLane(
                        tl, self.committee_trainer)
        if self.leader:
            self._start_lanes()

    def _start_lanes(self):
        for lane in (self._engine_lane, self._trainer_lane):
            lane.start()

    def _lane_failed(self, err: BaseException):
        """A lane broke on this rank: the run ends, and ``run()`` raises
        ``err`` (the failing rank's traceback)."""
        if self.lane_error is None:
            self.lane_error = err
        log.error("%s", err)
        self._signal_stop(StopToken("lane", str(err).splitlines()[0]))

    def _keep_fleet_stats(self) -> Dict[str, Any]:
        """``fleet.stats()`` (a collective on a mesh), kept on every rank:
        an engine-lane call, so that ``report()`` on a follower or after
        the lanes closed reads the last one."""
        self._last_fleet_stats = dispatch.local(self.fleet).stats()
        return self._last_fleet_stats

    # ------------------------------------------------------------------ stop
    def _signal_stop(self, token: StopToken):
        if not self.stop_event.is_set():
            self.stop_token = token
            self.stop_event.set()

    # ------------------------------------------------------------ oracle pool
    def _oracle_worker(self, rank: str, stop: threading.Event):
        """ElasticPool entry point: the worker loop runs SUPERVISED — a
        crash requeues the rank's in-flight ledger work and restarts the
        loop in this same thread (fresh oracle instance + endpoint), only
        escalating to a StopToken past the FailurePolicy crash budget."""
        self.supervisor.run(
            rank, "oracle", self._oracle_worker_inner, rank, stop,
            on_crash=lambda e: self.manager.requeue_crashed_worker(rank),
            should_stop=lambda: (stop.is_set()
                                 or self.oracle_pool.stop_all.is_set()))

    def _oracle_worker_inner(self, rank: str, stop: threading.Event):
        oracle = self._make_oracle(len(self._oracle_instances),
                                   self.cfg.result_dir)
        self._oracle_instances[rank] = oracle
        ep = self.manager.register_oracle(rank)
        try:
            while not (stop.is_set() or self.stop_event.is_set()
                       or self.oracle_pool.stop_all.is_set()):
                self.manager.heartbeat.beat(rank)
                if self.chaos is not None:
                    self.chaos.check("oracle.loop", rank=rank)
                try:
                    tid, payload = ep.jobs.recv(timeout=0.1)
                except TimeoutError:
                    continue
                ep.results.isend(
                    self._run_oracle_task(oracle, rank, tid, payload, stop))
                self._manager_wake.set()
        finally:
            oracle.stop_run()

    def _run_oracle_task(self, oracle, rank: str, tid: int, payload,
                         stop: threading.Event):
        """One labeling task with in-place retries (FailurePolicy.
        task_retries, exponential backoff + jitter).  Exhausted retries
        return an ``OracleTaskFailure`` sentinel — the task fails, the
        worker lives.  An injected ``ChaosCrash`` is NOT a task failure:
        it propagates to kill the loop so the supervisor's restart path is
        what gets exercised."""
        pol = self.supervisor.policy("oracle")
        attempt = 0
        while True:
            try:
                with self.monitor.timer("oracle.run_calc"):
                    if self.chaos is not None:
                        self.chaos.check("oracle.task", rank=rank)
                    inp, label = oracle.run_calc(np.asarray(payload))
                if self.chaos is not None:
                    label = self.chaos.corrupt_label(label, rank=rank)
                return (tid, inp, label)
            except ChaosCrash:
                raise
            except Exception as e:  # noqa: BLE001 — per-task boundary
                self.monitor.incr("oracle.task_failures")
                if (attempt >= pol.task_retries or stop.is_set()
                        or self.stop_event.is_set()):
                    log.warning("oracle %s task %d failed after %d "
                                "attempt(s): %r", rank, tid, attempt + 1, e)
                    return (tid, np.asarray(payload),
                            OracleTaskFailure(repr(e)))
                self.monitor.incr("oracle.task_retries")
                self.stop_event.wait(
                    self.supervisor.backoff_delay(pol, attempt))
                attempt += 1

    def add_oracles(self, n: int) -> List[str]:
        """Elastic scale-up of the oracle pool."""
        return self.oracle_pool.add(n)

    def remove_oracle(self, rank: str):
        """Elastic scale-down; in-flight work is requeued."""
        self.oracle_pool.remove(rank)
        self.manager.unregister_oracle(rank)

    # ------------------------------------------------------------- trainers
    def _recv_block(self, pending, timeout: float = 0.1):
        """Block on a posted trainer-channel receive — the Request wraps a
        condition-variable wait (``Channel.recv(timeout=)`` semantics on
        the already-posted irecv that doubled as the retrain interrupt), so
        an idle trainer thread sleeps until data actually arrives instead
        of poll-sleeping.  Returns the payload or None."""
        try:
            return pending.wait(timeout)
        except TimeoutError:
            return None

    def _note_retrain_completion(self):
        with self._retrain_lock:
            self._retrain_completions += 1
        self.monitor.incr("train.retrains")
        self._manager_wake.set()

    def _trainer_irecv(self, idx: int):
        """Post (or reuse) the parked trainer-channel receive for lane
        ``idx``.  The handle is stored on the runtime, not the loop frame:
        a supervised trainer restart must reuse the surviving request —
        re-posting would leak a parked irecv that silently swallows the
        next released block."""
        pending = self._trainer_pending.get(idx)
        if pending is None:
            pending = self.trainer_channels[idx].irecv()
            self._trainer_pending[idx] = pending
        return pending

    def _trainer_ingest(self, idx: int, add: Callable[[Any], None]) -> bool:
        """Wait for one released block on lane ``idx`` and absorb it (plus
        anything queued behind it).  Returns True when new data landed and
        a train round is owed — the dirty flag persists across a trainer
        crash so the restarted loop trains from the (device-resident)
        ingested data instead of waiting for the NEXT release."""
        block = self._recv_block(self._trainer_irecv(idx))
        if block is None:
            return False
        self._trainer_pending[idx] = None       # consumed — never replay it
        add(block)
        chan = self.trainer_channels[idx]
        while chan.poll():
            add(chan.recv())
        self._trainer_irecv(idx)                # re-post the interrupt handle
        self._trainer_dirty[idx] = True
        return True

    def _trainer_drain(self, idx: int, add: Callable[[Any], None]):
        """Shutdown path: a block delivered into the parked irecv between
        the last wait and shutdown bypasses the channel queue (transport
        completes parked requests directly) — absorb it and anything still
        queued, or post-run consolidation silently loses up to retrain_size
        labels."""
        pending = self._trainer_pending.get(idx)
        if pending is not None and pending.test():
            add(pending.value)
            self._trainer_pending[idx] = None
        chan = self.trainer_channels[idx]
        while chan.poll():
            add(chan.recv())

    def _trainer_loop(self, idx: int, stop: threading.Event):
        """Legacy path: one thread per user ``make_model(..., 'train')``."""
        trainer = self.trainers[idx]
        while not (stop.is_set() or self.stop_event.is_set()):
            if not self._trainer_dirty.get(idx):
                if not self._trainer_ingest(idx, trainer.add_trainingset):
                    continue
            if self.chaos is not None:
                self.chaos.check("trainer.loop")
            with self.monitor.timer("train.retrain"):
                stop_run = trainer.retrain(self._trainer_pending[idx])
            # publish BEFORE noting completion: the completion wakes the
            # manager, whose dynamic_oracle_list re-score must see the
            # freshly retrained weights, not the previous round's
            if self._sync_policies[idx].should_publish():
                self.store.publish_packed(idx, trainer.get_weight())
            self._trainer_dirty[idx] = False
            self._note_retrain_completion()
            trainer.save_progress()
            if stop_run:
                self._signal_stop(StopToken(f"trainer{idx}",
                                            "trainer stop criterion"))
        self._trainer_drain(idx, trainer.add_trainingset)

    def _committee_trainer_loop(self, stop: threading.Event):
        """Fused path: ONE loop advances all K members per step.  The
        pending irecv doubles as the interrupt handle — training yields
        the moment the Manager releases the next labeled block (or the run
        stops, so shutdown never waits out a whole round).  A crash
        anywhere in the round leaves the dirty flag set, so the supervised
        restart resumes training immediately from the device-resident
        replay ring + last stacked TrainState."""
        trainer = self.committee_trainer
        while not (stop.is_set() or self.stop_event.is_set()):
            if not self._trainer_dirty.get(0):
                if not self._trainer_ingest(0, trainer.add_blocks):
                    continue
            if self.chaos is not None:
                self.chaos.check("trainer.loop")
                ev = self.chaos.take("trainer.nan_member")
                if ev is not None:
                    trainer.poison_member(int(ev.arg))
            with self.monitor.timer("train.retrain"):
                trainer.train(interrupt=_RoundInterrupt(
                    self._trainer_pending[0], self.stop_event))
            # publish BEFORE noting completion (see _trainer_loop): the
            # woken manager's re-score must run on the refreshed weights
            if self._sync_policies[0].should_publish():
                self._publish_committee()
            self._trainer_dirty[0] = False
            self._note_retrain_completion()
        self._trainer_drain(0, trainer.add_blocks)

    def _publish_committee(self):
        """Trainer -> engine weight handoff.  The fused engine takes the
        stacked tree device-to-device into its own buffers (zero packed
        host bytes); the legacy per-member backend still pulls packed 1-D
        arrays through the WeightStore (its models own their params).  On
        a mesh the trainer lane takes the snapshot after the round and the
        engine lane takes it up by id, on every rank."""
        trainer = self.committee_trainer
        if self._handoff is not None:
            sid = self._handoff.next_id()
            self._trainer_lane.call("handoff", "take", sid)
            self._engine_lane.call("handoff", "give", sid)
            self.monitor.incr("prediction.weight_refreshes")
        elif hasattr(self.engine, "refresh_from_device"):
            self.engine.refresh_from_device(trainer.snapshot_cparams())
            self.monitor.incr("prediction.weight_refreshes")
        else:
            cparams = trainer.cparams
            for i in range(trainer.size):
                self.store.publish_packed(
                    i % self.store.n_members,
                    cmte.get_weight(cmte.member(cparams, i)))

    # ------------------------------------------------------------- threads
    def _exchange_loop(self, stop: threading.Event):
        while not (stop.is_set() or self.stop_event.is_set()):
            if self.chaos is not None:
                self.chaos.check("exchange.loop")
            token = self.exchange.step()
            if token is not None:
                self._signal_stop(token)

    def _autosave_due(self) -> bool:
        every = int(getattr(self.cfg, "checkpoint_every_iters", 0))
        if every <= 0:
            return False
        return (self.exchange.iteration - self._last_ckpt_iter) >= every

    def _manager_loop(self, stop: threading.Event):
        while not (stop.is_set() or self.stop_event.is_set()):
            self.manager.step(self._retrain_completions)
            # periodic autosave: wall-clock (checkpoint_every) OR exchange
            # progress (checkpoint_every_iters), whichever is configured
            if self.checkpointer.due() or self._autosave_due():
                self.checkpoint()
            # event-or-timeout: woken immediately by new work (oracle-buffer
            # put / oracle result / retrain completion), with a bounded
            # fallback so ledger timeouts and heartbeats are still serviced
            if self._manager_wake.wait(timeout=0.05):
                self._manager_wake.clear()

    # ------------------------------------------------------------------ run
    def start(self):
        if not self.leader:       # its lanes make the leader's calls
            self._start_lanes()
            return
        if self.chaos is not None:
            transport.install_chaos(self.chaos)
        self.oracle_pool.add(self.cfg.orcl_process)
        if self.committee_trainer is not None:
            self._threads.append(self.supervisor.spawn(
                "committee_trainer", "trainer",
                self._committee_trainer_loop, self.stop_event))
        for i in range(len(self.trainers)):
            self._threads.append(self.supervisor.spawn(
                f"trainer{i}", "trainer",
                self._trainer_loop, i, self.stop_event))
        self._threads.append(self.supervisor.spawn(
            "exchange", "exchange", self._exchange_loop, self.stop_event))
        self._threads.append(self.supervisor.spawn(
            "manager", "manager", self._manager_loop, self.stop_event))

    def run(self, timeout: Optional[float] = None) -> Optional[StopToken]:
        """Start and block until a kernel signals stop (or timeout).  On a
        follower of a mesh: until the leader's stop token arrives (the
        timeout is the leader's).  Raises the error of a broken lane."""
        try:
            self.start()
            self.stop_event.wait(timeout if self.leader else None)
            if not self.stop_event.is_set():
                self._signal_stop(StopToken("runtime", "timeout"))
        finally:
            self.shutdown()
        if self.lane_error is not None:
            raise self.lane_error
        return self.stop_token

    def shutdown(self):
        self.stop_event.set()
        try:
            self._stop_threads()
        finally:
            self._close_lanes()
        # the loops' CUDA work (graph replays on the engine's and the
        # trainer's streams) finishes before anyone frees the graphs
        for owner in (self.engine, self.committee_trainer):
            if hasattr(owner, "synchronize"):
                owner.synchronize()

    def _close_lanes(self):
        """Leader: a last fleet snapshot for ``report()``, then the stop
        token as each lane's last message.  Every rank then joins its
        lanes (a follower's end at the leader's token) and destroys their
        groups; a lane whose thread outlived the join keeps them
        (``runtime.unreleased_lanes``)."""
        el, tl = self._engine_lane, self._trainer_lane
        if el is None:
            return
        if self.leader and el.open and isinstance(self.fleet,
                                                  dispatch.Proxy):
            try:
                el.call("pal", "_keep_fleet_stats")
            except dispatch.LaneError:
                pass                        # the lane's error is the run's
        token = self.stop_token or StopToken("runtime", "shutdown")
        for lane in (el, tl):
            if not lane.close(token):
                self.monitor.incr("runtime.unreleased_lanes")

    def _stop_threads(self):
        if self.serve_queue is not None:
            # flush pending served requests — bounded like every other
            # join here, so a wedged dispatch can't hang shutdown
            try:
                self.serve_queue.close(timeout=10.0)
            except Exception as e:  # noqa: BLE001 — shutdown must continue
                log.warning("serve queue close failed: %r", e)
        self.oracle_pool.shutdown()
        unjoined = []
        for th in self._threads:
            th.join(timeout=10.0)
            if th.is_alive():
                unjoined.append(th.name)
        if unjoined:
            # never silently leak threads: surface which loops failed to
            # exit (a wedged oracle call, a hung chaos delay) — the process
            # still shuts down because every loop thread is a daemon
            self.monitor.incr("runtime.unjoined_threads", len(unjoined))
            log.warning("threads not joined within timeout: %s", unjoined)
        if self.chaos is not None:
            transport.uninstall_chaos()
        # paper: every process's stop_run is called before quitting — one
        # kernel's failing stop_run must not rob the others of theirs
        for obj in (*self.generators, *self.predictors, *self.trainers):
            try:
                obj.stop_run()
            except Exception as e:  # noqa: BLE001
                log.warning("stop_run failed for %r: %r", obj, e)

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self) -> str:
        if not self.leader:
            raise RuntimeError("on a mesh the leader (its first rank) "
                               "writes the checkpoints")
        # in-flight oracle tasks (dispatched, not yet labeled) are requeued
        # into the snapshot: a restore re-dispatches them instead of
        # silently losing selected inputs whose labels never arrived
        state = {
            "weights": {i: w for i, w in
                        [(i, self.store.pull_packed(i)) for i in
                         range(self.store.n_members)] if w is not None},
            "oracle_buffer": (self.oracle_buffer.snapshot()
                              + self.manager.ledger.inflight_payloads()),
            "train_buffer": self.train_buffer.snapshot(),
            "patience": self.exchange.patience.state_dict(),
            "iteration": self.exchange.iteration,
            "labeled_total": self.train_buffer.total_labeled,
            # cross-round acquisition state (budget controller threshold/
            # integral, rolling re-weight bucket scores) — without it a
            # restored run would re-converge from scratch and overshoot
            # the oracle budget for a whole horizon
            "engine_state": self.engine.state_dict(),
        }
        if self.committee_trainer is not None:
            # FULL TrainState (params + Adam moments + per-member step) +
            # step counter + replay ring, as host numpy: a resumed run
            # continues mid-schedule instead of resetting its optimizer
            state["train_state"] = self.committee_trainer.state_dict()
        if self.fleet is not None:
            # full walker carry incl. the per-walker noise counters and the
            # step counter: a restored fleet replays the exact trajectory
            # (bit-identical resume, tested)
            state["fleet"] = self.fleet.state_dict()
        self._last_ckpt_iter = self.exchange.iteration
        return self.checkpointer.save(self.exchange.iteration, state)

    def _restore(self):
        state = self.checkpointer.latest()
        if state is None:
            return
        for i, packed in state.get("weights", {}).items():
            arr, _ = packed
            self.store.publish_packed(int(i), arr)
        self.oracle_buffer.restore(state.get("oracle_buffer", []))
        self.train_buffer.restore(state.get("train_buffer", []))
        if "patience" in state:
            self.exchange.patience.load_state_dict(state["patience"])
        if state.get("engine_state"):
            self.engine.load_state_dict(state["engine_state"])
        if state.get("fleet") is not None and self.fleet is not None:
            self.fleet.load_state_dict(state["fleet"])
        if (state.get("train_state") is not None
                and self.committee_trainer is not None):
            self.committee_trainer.load_state_dict(
                _trainer_snapshot(state["train_state"]))
            # prediction must resume on the restored weights too
            self._publish_committee()
        self.exchange.iteration = int(state.get("iteration", 0))
        self.monitor.incr("runtime.restores")

    # ------------------------------------------------------------- reports
    def _fleet_stats(self) -> Optional[Dict[str, Any]]:
        """On a mesh a collective: an engine-lane call while the leader's
        lanes are open, else the last snapshot taken (a follower's, or
        after ``shutdown``)."""
        if self._engine_lane is None:
            return self.fleet.stats()
        if self.leader and self._engine_lane.open:
            return self._engine_lane.call("pal", "_keep_fleet_stats")
        return self._last_fleet_stats

    def report(self) -> Dict[str, Any]:
        r = self.monitor.report()
        r["oracle_pool_size"] = self.oracle_pool.size()
        r["oracle_buffer"] = len(self.oracle_buffer)
        r["train_buffer"] = len(self.train_buffer)
        r["labeled_total"] = self.train_buffer.total_labeled
        r["weight_publishes"] = self.store.publishes
        # fused-trainer path: weights reach the engine device-to-device,
        # so store publishes stay 0 — the refresh counters tell the story
        r["device_weight_refreshes"] = getattr(
            self.engine, "device_refreshes", 0)
        if self.committee_trainer is not None:
            r["train_fused_steps"] = self.committee_trainer.steps_done
            r["train_replay_rows"] = len(self.committee_trainer.replay)
        if self.fleet is not None:
            # fleet health: one device->host snapshot, off the hot path
            r["fleet"] = self._fleet_stats()
        for lane in (self._engine_lane, self._trainer_lane):
            if lane is not None:
                r.setdefault("lanes", {})[lane.name] = {
                    "calls": lane.calls, "send_s": lane.send_s,
                    "first_send_s": lane.first_send_s,
                    "decides": lane.decides, "decide_s": lane.decide_s}
        # realized oracle rate: queued / scored over the whole run, the
        # quantity the budget controller steers toward oracle_budget.
        # Serving traffic counts too — with serve_uq the server shares the
        # controller (advance=True), so the metered demand is exchange
        # selections PLUS uncertain served requests routed to the buffer
        c = r["counters"]
        ex_scored = c.get("exchange.proposals", 0)
        ex_queued = c.get("exchange.queued_to_oracle", 0)
        sv_scored = c.get("serve.requests", 0)
        sv_queued = c.get("serve.routed_to_oracle", 0)
        scored = ex_scored + sv_scored
        queued = ex_queued + sv_queued
        r["oracle_rate"] = queued / scored if scored else None
        # per-stream breakout: the controller is joint, but each stream's
        # realized rate is observable against its own target
        r["oracle_rate_exchange"] = (ex_queued / ex_scored if ex_scored
                                     else None)
        r["oracle_rate_serve"] = sv_queued / sv_scored if sv_scored else None
        if self.serve_queue is not None:
            # ONE health() snapshot (taken under the queue's lock) feeds
            # every serve_queue_* key — dispatch counts can never be torn
            # against the breaker state / per-client counters they explain
            qh = self.serve_queue.health()
            r["serve_queue_dispatches"] = qh["dispatches"]
            r["serve_queue_batched_requests"] = qh["batched_requests"]
            r["serve_queue_health"] = qh
        # fault-tolerance observability: last crash + restart tally from
        # the supervisor, committee quarantine floor from the engine (min
        # finite members seen in any scored round), chaos events fired so
        # far when a FaultPlan is installed
        sup = self.supervisor.snapshot()
        r["last_fault"] = sup["last_fault"]
        r["supervisor"] = sup       # incl. registered component health
        r["thread_restarts"] = self.supervisor.total_restarts()
        r["uq_finite_members_min"] = getattr(
            self.engine, "last_finite_min", None)
        r["uq_quarantine_rounds"] = getattr(
            self.engine, "quarantine_rounds", 0)
        if self.chaos is not None:
            r["chaos_fired"] = self.chaos.summary()
        r["stop"] = repr(self.stop_token)
        return r


class _RoundInterrupt:
    """The committee trainer's interrupt: the parked receive of the next
    released block, or the run's stop."""

    def __init__(self, pending, stop: threading.Event):
        self.pending, self.stop = pending, stop

    def test(self) -> bool:
        return self.pending.test() or self.stop.is_set()


def _trainer_snapshot(state: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's trainer snapshot in this package's format: a JAX
    reference trainer's snapshot (a checkpoint its ``PAL`` wrote) is
    converted by ``state_dict_from_reference``; the port's own passes
    through."""
    from repro_torch.training.committee_trainer import (
        state_dict_from_reference,
    )
    from repro_torch.training.train_step import TrainState

    if isinstance(state.get("cstate"), TrainState):
        return state
    return state_dict_from_reference(state)


# ---------------------------------------------------------------------------
# PAL's objects on the lanes of a mesh of several processes
# ---------------------------------------------------------------------------

_ENGINE_CALLS = ("score", "state_dict", "load_state_dict")
_FLEET_CALLS = ("stats", "state_dict", "load_state_dict", "poison_walker",
                "positions")
_TRAINER_CALLS = ("add_blocks", "poison_member", "state_dict",
                  "load_state_dict")


class _StoreCopy:
    """The leader's ``WeightStore`` as of now (its version and every
    member's packed weights), sent with a ``refresh_from`` call."""

    def __init__(self, store: WeightStore):
        self.n_members = store.n_members
        self._version = store.version()
        self.packs = [store.pull_packed(i) for i in range(store.n_members)]

    def version(self) -> int:
        return self._version

    def pull_packed(self, member: int):
        return self.packs[member]


class _EngineOnLane(dispatch.Proxy):
    """The leader's engine: scoring and its state on the engine lane."""

    def __init__(self, lane: dispatch.Lane, engine):
        super().__init__(lane, "engine", engine, _ENGINE_CALLS)

    def refresh_from(self, store: WeightStore) -> int:
        """Per-member trainers publish on the leader: their weights travel
        with the call, which is made only when the engine would take them
        (every member published, a newer version)."""
        snap = _StoreCopy(store)
        if snap.version() <= self.target.version or any(
                p is None for p in snap.packs):
            return 0
        return self._lane.call("engine", "refresh_from", snap)


class _FleetOnLane(dispatch.Proxy):
    """The leader's fleet: its steps and snapshots on the engine lane; the
    chaos site ``fleet.step`` fires here, and a poisoned walker reaches
    the rank that holds it as a lane call."""

    def __init__(self, lane: dispatch.Lane, fleet, chaos):
        super().__init__(lane, "fleet", fleet, _FLEET_CALLS)
        self._chaos = chaos

    def step(self):
        ev = self._chaos.take("fleet.step") if self._chaos else None
        if ev is not None:
            if ev.kind == "nan_walker":
                self._lane.call("fleet", "poison_walker", int(ev.arg))
            else:
                self._chaos.execute(ev)
        return self._lane.call("fleet", "step")


class _TrainerOnLane(dispatch.Proxy):
    """The leader's trainer: blocks, rounds, chaos and snapshots on the
    trainer lane; a round's ``interrupt`` stays on the leader."""

    def __init__(self, lane: dispatch.Lane, trainer):
        super().__init__(lane, "trainer", trainer, _TRAINER_CALLS)

    def train(self, interrupt=None, steps: Optional[int] = None):
        return self._lane.call("round", "train", steps=steps,
                               _local={"interrupt": interrupt})


class _Round:
    """A trainer round on every rank: after each step every rank stops or
    goes on as the leader's interrupt says (one decision a step on the
    trainer lane), so every rank ends the round at the same step."""

    def __init__(self, trainer, lane: dispatch.Lane):
        self.trainer, self.lane = trainer, lane

    def train(self, steps: Optional[int] = None, interrupt=None):
        return self.trainer.train(
            interrupt=_LeaderDecides(self.lane, interrupt), steps=steps)


class _LeaderDecides:
    def __init__(self, lane: dispatch.Lane, interrupt):
        self.lane, self.interrupt = lane, interrupt

    def test(self) -> bool:
        return self.lane.decide(self.interrupt is not None
                                and self.interrupt.test())


class _Handoff:
    """The trainer -> engine handoff on a mesh.  ``take`` (trainer lane,
    after the round) snapshots the rank's members on the device; ``give``
    (engine lane) refreshes the engine from the snapshot of that id,
    waiting for this rank's trainer lane to have taken it.  So every rank's
    engine takes the weights of the same trainer step, device to device."""

    def __init__(self, trainer, engine):
        self.trainer, self.engine = trainer, engine
        self._snaps: Dict[int, Any] = {}
        self._cv = threading.Condition()
        self._ids = 0

    def next_id(self) -> int:
        self._ids += 1
        return self._ids

    def take(self, sid: int) -> None:
        snap = self.trainer.snapshot_cparams()
        with self._cv:
            self._snaps[sid] = snap
            self._cv.notify_all()

    def give(self, sid: int) -> int:
        with self._cv:
            if not self._cv.wait_for(lambda: sid in self._snaps,
                                     dispatch.TIMEOUT_S):
                raise TimeoutError(f"handoff {sid}: the trainer lane took "
                                   f"no snapshot in {dispatch.TIMEOUT_S} s")
            snap = self._snaps.pop(sid)
        return self.engine.refresh_from_device(snap)
