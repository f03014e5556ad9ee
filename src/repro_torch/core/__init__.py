"""PAL — the paper's primary contribution: a parallel, asynchronous,
modular active-learning workflow (five kernels + two sub-controllers), on
PyTorch and the CUDA card.

Public surface:
  transport     — MPI-shaped non-blocking channels (isend/irecv/Test)
  api           — UserModel / UserGene / UserOracle kernel interfaces (S4–S7)
  buffers       — oracle input buffer, retrain_size training buffer, rolling
  committee     — stacked committee trees, ``torch.func.vmap`` apply, the
                  paper's 1-D weight packing, shape bucketing and
                  ``params_from_numpy`` (weights carried across from the
                  reference)
  acquisition   — the ONE UQ path: ``FusedEngine`` (committee forward +
                  ``committee_uq`` kernel + selection rules, one captured
                  CUDA graph per shape bucket on the card), ``LegacyEngine``
                  (per-member ``UserModel.predict``, float64 host
                  statistics), composable rules and ``make_engine``
  budget        — cross-round budgeted acquisition: ``BudgetRule`` (PI
                  control of the threshold toward a target oracle rate) and
                  ``RollingReweightRule``, with state on the device
  selection     — prediction_check (paper port) / selection_from_uq /
                  adjust_input_for_oracle(_uq) / patience
  weight_sync   — versioned training->prediction weight publication with
                  preallocated ping-pong pack buffers; on the fused-training
                  path weights hand off device-to-device instead
  controller    — Exchange + Manager sub-controllers; one engine call per
                  exchange iteration, dynamic_oracle_list on the same engine
  supervisor    — per-loop-class FailurePolicy: task retries with backoff +
                  jitter, crashed-loop restart in place, escalation to
                  StopToken only past the crash budget
  chaos         — deterministic seeded fault injection (FaultPlan /
                  ChaosInjector): scheduled raises, crashes, delays, NaN
                  labels, poisoned committee members
  runtime       — PAL: threads, fault tolerance, elastic pools, checkpoints;
                  pass loss_fn= with a CommitteeSpec and the per-member
                  trainer threads collapse into the fused CommitteeTrainer
                  loop (training/committee_trainer.py)
  speedup       — the SI S2 analytic speedup model
  monitor       — timers and counters
"""
from repro_torch.core.acquisition import (  # noqa: F401
    CommitteeSpec, DiversityRule, FusedEngine, LegacyEngine, SelectionRule,
    ThresholdRule, TopFractionRule, UQEngine, UQResult, make_engine,
)
from repro_torch.core.api import UserGene, UserModel, UserOracle  # noqa: F401
from repro_torch.core.budget import (  # noqa: F401
    BudgetRule, OracleBudgetController, RollingReweightRule,
    rules_from_config,
)
from repro_torch.core.chaos import (  # noqa: F401
    ChaosCrash, ChaosFault, ChaosInjector, FaultEvent, FaultPlan,
)
from repro_torch.core.runtime import PAL  # noqa: F401
from repro_torch.core.supervisor import FailurePolicy, Supervisor  # noqa: F401
from repro_torch.core.speedup import WorkloadParams  # noqa: F401
# NOTE: the speedup() function is NOT re-exported here -- it would shadow the
# `repro_torch.core.speedup` submodule attribute.  Use
# repro_torch.core.speedup.speedup.
