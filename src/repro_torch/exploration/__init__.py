"""Device-resident exploration: stacked walker fleets advanced, scored,
and selected in one fused program per step (``exploration.fleet.WalkerFleet``)."""

from repro_torch.exploration.fleet import (  # noqa: F401
    FleetConfig, PatienceRestart, WalkerFleet, make_sampler,
)
