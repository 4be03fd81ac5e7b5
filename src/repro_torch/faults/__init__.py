"""Deterministic chaos engineering for the elastic runtime, ported from
``repro.faults``.

``FaultSpec`` (on the RunSpec) -> ``resolve_plan`` -> ``FaultPlan`` ->
``ChaosInjector`` firing scheduled faults into a live ``Session``; the
``ChaosFileJobManager`` transport adds seeded RPC loss/dup/delay.
"""
from repro_torch.faults.injector import (ChaosFileJobManager,
                                         ChaosInjector, FaultRecord)
from repro_torch.faults.plan import FaultEvent, FaultPlan, resolve_plan

__all__ = ["ChaosFileJobManager", "ChaosInjector", "FaultRecord",
           "FaultEvent", "FaultPlan", "resolve_plan"]
