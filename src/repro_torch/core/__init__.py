"""DynMo core, ported from ``repro.core``: profiling, the two load
balancers, layer migration and the synchronous controller."""
from repro_torch.core.balancer import (BalanceResult, balance,
                                       diffusion_balance, imbalance,
                                       partition_balance, stage_loads)
from repro_torch.core.controller import (ControllerConfig, ControllerEvent,
                                         DynMoController)
from repro_torch.core.migration import (MigrationPlan, apply_plan,
                                        build_plan, migrate)

__all__ = [
    "BalanceResult", "balance", "diffusion_balance", "imbalance",
    "partition_balance", "stage_loads", "ControllerConfig",
    "ControllerEvent", "DynMoController", "MigrationPlan", "apply_plan",
    "build_plan", "migrate",
]
