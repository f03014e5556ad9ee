"""pal-potential — the paper's own scenario: a committee of MLP potentials.

A copy of the reference's pure dataclasses (``repro/configs/pal_potential.py``):
a query-by-committee ensemble of fully-connected potentials on radial-basis
descriptors (paper §3.1/§3.2), energies + forces by autograd.  Fields the
port does not use yet (mesh, fleet, trainer, launch knobs) are kept so one
config file drives both packages.
"""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class PotentialConfig:
    name: str = "pal-potential"      # scenario tag (result paths, logs)
    n_atoms: int = 8                 # atoms per configuration
    committee_size: int = 4          # paper §3.1 uses 4 NNs
    hidden: Tuple[int, ...] = (128, 128)  # MLP hidden-layer widths
    n_rbf: int = 32                  # radial basis features per pair
    r_cut: float = 6.0               # descriptor cutoff radius (Å)
    dtype: str = "float32"           # parameter/descriptor dtype


@dataclass(frozen=True)
class PALRunConfig:
    """Mirrors the paper's AL_SETTING block (SI S3)."""

    result_dir: str = "results/pal_run"  # checkpoints / progress output dir
    pred_process: int = 1            # committee is one vmapped SPMD program
    orcl_process: int = 4            # oracle worker threads (ab initio ranks)
    gene_process: int = 8            # host generator threads (ignored when
                                     # fleet_walkers > 0)
    ml_process: int = 1              # per-member trainer threads (legacy
                                     # path; the fused trainer is one loop)
    retrain_size: int = 20           # batch size of increment retraining set
    dynamic_oracle_list: bool = True  # oracles register/deregister at
                                     # runtime (elastic pool)
    fixed_size_data: bool = True     # pad labeled blocks to fixed shapes
                                     # (stable jit signatures)
    progress_save_interval: float = 60.0  # seconds between progress dumps
    std_threshold: float = 0.05      # prediction_check uncertainty threshold
    patience: int = 5                # generator steps allowed in high-uncertainty
    weight_sync_every: int = 1       # publish weights every N retrain rounds
    exchange_min_interval: float = 0.005  # floor for one exchange iteration
                                     # (on few-core hosts a free-spinning
                                     # exchange loop starves oracle/training
                                     # threads; the paper's 51.5 ms committee
                                     # inference is an implicit throttle)
    rolling_buffer_size: int = 0     # >0 enables rolling training set (Use Case 2)
    oracle_timeout: float = 30.0     # fault tolerance: requeue after timeout
    max_oracle_retries: int = 2      # redispatches before a task FAILS
    checkpoint_every: float = 0.0    # seconds; 0 disables
    checkpoint_every_iters: int = 0  # autosave every N exchange iterations
                                     # (progress-based twin of
                                     # checkpoint_every; 0 disables)
    seed: int = 0                    # base RNG seed (committee init, LSH
                                     # projections, jitter)
    # --- supervised fault tolerance (core/supervisor.py) ------------------
    supervise: bool = True           # False: first loop crash escalates to
                                     # a StopToken (the seed's fail-stop),
                                     # via FailurePolicy.max_crashes=1
    oracle_task_retries: int = 2     # in-place retries per oracle task
                                     # before the worker reports an
                                     # OracleTaskFailure (task != worker)
    oracle_task_backoff_s: float = 0.05  # first retry delay; doubles per
                                     # attempt, jittered, capped at 2 s
    loop_max_crashes: int = 3        # crashes of one loop within the window
                                     # before the supervisor stops
                                     # restarting and escalates
    loop_crash_window_s: float = 30.0  # sliding crash-count window
    loop_restart_backoff_s: float = 0.1  # first restart delay (same growth)
    # --- degradation-aware serving (serving/queue.py) ---------------------
    serve_shed_pending: int = 0      # >0: submit() raises QueueOverloaded
                                     # once this many rows are pending
                                     # (bounded-queue load shedding);
                                     # 0 keeps pure blocking backpressure
    serve_breaker_failures: int = 0  # >0: circuit breaker opens after this
                                     # many CONSECUTIVE dispatch failures
                                     # (CircuitOpen until the reset probe);
                                     # 0 disables the breaker
    serve_breaker_reset_s: float = 5.0  # open->half-open cooldown before
                                     # one probe batch is admitted
    # --- acquisition engine (core/acquisition.make_engine) ---------------
    uq_impl: str = "auto"            # 'auto' | 'xla' | 'pallas' |
                                     # 'pallas_interpret' | 'legacy':
                                     # fused backends need committee=
                                     # CommitteeSpec(...) passed to PAL;
                                     # 'auto' picks fused-xla when one is
                                     # given, per-member legacy otherwise
    uq_block_n: int = 128            # Pallas kernel row-block size
    uq_bucket: int = 8               # min power-of-two n_gen jit bucket
    uq_mesh: str = ""                # '' (single device) | 'host'
                                     # (degenerate 1x1 mesh, CI parity) |
                                     # 'scaleout' (all visible devices on
                                     # 'data') | 'DxM' (e.g. '4x2' explicit
                                     # data x model grid) | 'production'
                                     # (16x16 data x model): mesh-parallel
                                     # fused dispatch — committee over
                                     # 'model' via the COMMITTEE sharding
                                     # rules, request batch over 'data'
    # --- cross-round budgeted acquisition (core/budget.py) ---------------
    oracle_budget: float = 0.0       # >0: target oracle-selected fraction
                                     # per exchange round — installs the
                                     # BudgetRule PI controller (seeded at
                                     # std_threshold) instead of the static
                                     # threshold rule; 0 disables
    budget_horizon: int = 16         # controller window (rounds): integral
                                     # leak + realized-rate EMA
    reweight_buckets: int = 0        # >0: RollingReweightRule region
                                     # buckets (SI Use Case 2 analog);
                                     # 0 disables
    reweight_decay: float = 0.9      # per-round bucket-score decay
    reweight_boost: float = 1.0      # max relative acquisition-score boost
    oracle_budget_exchange: float = 0.0  # per-stream target for exchange
                                     # rounds; 0 falls back to the shared
                                     # oracle_budget
    oracle_budget_serve: float = 0.0     # per-stream target for served
                                     # (STREAM_SERVE) rounds; 0 falls back
                                     # to the shared oracle_budget.  Both
                                     # streams steer ONE effective
                                     # threshold (joint control), each
                                     # against its own target;
                                     # PAL.report() breaks out the
                                     # per-stream realized rates
    serve_uq: bool = False           # serving: build a CommitteeServer on
                                     # the SAME engine (batch-level UQResult
                                     # per request; uncertain requests route
                                     # to the oracle buffer through the
                                     # same budget controller)
    # --- queue-batched serving (serving/queue.py) -------------------------
    serve_max_batch: int = 0         # >0 (with serve_uq): build
                                     # PAL.serve_queue — a ServingQueue
                                     # that fuses many small requests into
                                     # one microbatched engine dispatch;
                                     # best as a power of two matching the
                                     # engine's shape buckets (no new
                                     # traces).  0 disables
    serve_max_wait_ms: float = 2.0   # queue deadline: a pending request is
                                     # dispatched at the latest this many
                                     # ms after it was enqueued, even if
                                     # the microbatch is not full (the
                                     # INITIAL deadline when the latency
                                     # controller is on)
    # --- multi-tenant serving tier ----------------------------------------
    serve_rate_limit: float = 0.0    # >0: per-client token-bucket rate
                                     # limit (rows/second); a client over
                                     # its bucket gets a typed RateLimited
                                     # rejection instead of queue space.
                                     # 0 disables rate limiting
    serve_rate_burst: float = 0.0    # token-bucket capacity (rows); 0
                                     # defaults to one second of burst
                                     # (max(serve_rate_limit, 1))
    serve_latency_target_ms: float = 0.0  # >0: adaptive deadline — a
                                     # latency PI controller (the oracle
                                     # budget controller re-aimed at p99)
                                     # steers the effective queue deadline
                                     # toward this served-p99 target.
                                     # 0 keeps the static serve_max_wait_ms
    serve_wait_min_ms: float = 0.05  # adaptive-deadline lower authority
                                     # bound (ms)
    serve_wait_max_ms: float = 50.0  # adaptive-deadline upper authority
                                     # bound (ms)
    serve_latency_window: int = 64   # served requests per p99 measurement
                                     # / controller update
    serve_cache_buckets: int = 0     # >0: LSH answer cache — confident
                                     # repeat requests short-circuit before
                                     # the device (hash-space size; entries
                                     # bounded by 4 per bucket).  The cache
                                     # invalidates wholesale on every
                                     # weight refresh.  0 disables
    serve_cache_std_max: float = 0.0  # only answers with scalar_std <=
                                     # this (and not rule-selected) are
                                     # cached; 0 falls back to
                                     # std_threshold
    serve_cache_tol: float = 0.0     # L-inf match radius around the cached
                                     # key row; 0 = bit-identical rows only
                                     # (cache hit == fresh dispatch,
                                     # exactly)
    # --- fused committee training (training/committee_trainer.py) ---------
    # Active when BOTH committee=CommitteeSpec(...) AND loss_fn= are passed
    # to PAL: the per-member ml_process trainer threads collapse into ONE
    # committee-trainer loop advancing all K members in a single vmapped
    # dispatch per step, fed from a device-resident replay ring, with
    # weights handed to the acquisition engine device-to-device.  Without a
    # loss_fn the per-member make_model(..., 'train') factories remain the
    # legacy path.
    train_steps: int = 200           # fused steps per retrain round (yields
                                     # early when a new labeled block lands)
    train_batch: int = 32            # per-member minibatch rows
    train_lr: float = 1e-3           # AdamW learning rate (constant sched)
    train_bootstrap: bool = True     # per-member bootstrap minibatches
                                     # (decorrelated members); False gives
                                     # every member the same data order
    train_replay_capacity: int = 2048  # device replay-ring rows
    train_memory_policy: str = "fp32"  # stacked-TrainState storage preset:
                                     # fp32 | bf16 | int8 (QTensor moments)
                                     # — optim/memory_policy.MemoryPolicy;
                                     # the K=64 memory-diet knob
    train_replay_dtype: str = "float32"  # replay-ring row storage (bfloat16
                                     # halves the ring + append bytes;
                                     # gathers are fp32 either way)
    # --- device-resident exploration fleet (exploration/fleet.py) ---------
    # fleet_walkers > 0 replaces the gene_process host generators with ONE
    # stacked WalkerFleet: N walkers advanced, scored, and selected in a
    # single fused dispatch per exchange iteration (requires a fused
    # engine, i.e. committee=CommitteeSpec(...)).  Trusted initial states
    # come from the first proposal of each make_generator(rank) — or an
    # explicit fleet_init=(N, dim) array passed to PAL.
    fleet_walkers: int = 0           # 0 keeps the host-generator path
    fleet_sampler: str = "euler"     # 'euler' | 'langevin'
    fleet_patience: int = 0          # consecutive-uncertain steps before a
                                     # device restart; 0 falls back to
                                     # `patience`
    fleet_dt: float = 0.002          # sampler time step
    fleet_noise: float = 0.01        # thermal-noise scale (0 = deterministic)
    fleet_clip: float = 20.0         # per-component force clip
    fleet_friction: float = 0.1      # 'langevin' velocity damping
    fleet_max_steps: int = 0         # stop the exchange after N fleet steps
                                     # (0 = run until another stop source)
    # --- platform / multi-process launch (launch/platform.py,
    # launch/distributed.py) ----------------------------------------------
    # Process-level runtime knobs: launch scripts call
    # `platform.configure(...)` / `distributed.initialize_from_config(cfg)`
    # BEFORE building engines, so one config describes the whole launch.
    platform: str = ""               # '' (auto) | 'cpu' | 'gpu' | 'tpu' —
                                     # pinned before backend init
    host_devices: int = 0            # >0: emulated host devices
                                     # (--xla_force_host_platform_device_
                                     # count=N, set before jax import) —
                                     # how CI runs a real 8-device mesh
                                     # on one CPU host
    enable_x64: bool = False         # double-precision jax (oracle-side
                                     # reference computations)
    gpu_autotune: bool = False       # append the XLA GPU autotune flag set
    dist_coordinator: str = ""       # 'host:port' of process 0 enables the
                                     # jax.distributed multi-process launch
                                     # (one jit program spanning hosts)
    dist_processes: int = 0          # total process count in the launch
    dist_process_id: int = -1        # this process's id (0-based); -1 reads
                                     # JAX_PROCESS_ID / PAL_PROCESS_ID env
    dist_cpu_collectives: str = "gloo"  # CPU cross-process collectives
                                     # backend ('gloo' | 'mpi'); ignored
                                     # off-CPU


DEFAULT = PotentialConfig()
DEFAULT_RUN = PALRunConfig()
