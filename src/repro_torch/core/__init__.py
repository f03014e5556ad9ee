"""PAL's controller-side core, ported so far for the serving path:

  committee   — stacked committee trees, ``torch.func.vmap`` apply, the
                paper's 1-D weight packing, shape bucketing and
                ``params_from_numpy`` (weights carried across from the
                reference)
  acquisition — the ONE UQ path: ``FusedEngine`` (committee forward +
                ``committee_uq`` kernel + selection rules, one program per
                shape bucket), composable rules and ``make_engine``
  budget      — cross-round budgeted acquisition: ``BudgetRule`` (PI
                control of the threshold toward a target oracle rate) and
                ``RollingReweightRule``, with state on the device
  buffers     — oracle input buffer, training buffers (host copies)
  monitor     — timers and counters (host copy)
"""
from repro_torch.core.acquisition import (  # noqa: F401
    CommitteeSpec, DiversityRule, FusedEngine, SelectionRule, ThresholdRule,
    TopFractionRule, UQEngine, UQResult, make_engine,
)
from repro_torch.core.budget import (  # noqa: F401
    BudgetRule, OracleBudgetController, RollingReweightRule,
    rules_from_config,
)
