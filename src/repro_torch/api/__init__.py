"""The typed front door of the port: ``RunSpec`` describes a run,
``Session`` runs it.

    from repro_torch.api import RunSpec, Session, scenario

    with Session(scenario("early_exit"), device="cpu") as s:
        report = s.train()

The port's copy of ``repro.api``: the same schema, scenarios and CLI
surface; ``Session`` takes the device as a keyword.
"""
from repro_torch.api.scenarios import SCENARIOS, scenario, scenario_names
from repro_torch.api.session import Session, SessionEvent
from repro_torch.api.specs import (SCHEMA_VERSION, ClusterSpec,
                                   ControllerSpec, DynamicsSpec, ModelSpec,
                                   ParallelSpec, RepackSpec, RunSpec,
                                   ServeSpec, SpecError)

__all__ = [
    "SCHEMA_VERSION", "ClusterSpec", "ControllerSpec", "DynamicsSpec",
    "ModelSpec", "ParallelSpec", "RepackSpec", "RunSpec", "ServeSpec",
    "SpecError", "Session", "SessionEvent", "SCENARIOS", "scenario",
    "scenario_names",
]
