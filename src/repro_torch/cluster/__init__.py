from repro_torch.cluster.service import (ControlPlane, DecisionPlan,
                                         StatsSnapshot)

__all__ = ["ControlPlane", "DecisionPlan", "StatsSnapshot"]
