"""Continuous-batching serving on one fixed execution world.

  requests   — ``Request`` + ``RequestQueue`` and the bursty arrival-trace
               generator;
  slots      — KV lane manager for the fixed [num_micro, mb_global] batch;
  scheduler  — continuous batching: admissions, per-lane decode, defrag;
  server     — ``ElasticServer`` binding the scheduler to ``ElasticEngine``.
"""
from repro_torch.serve.requests import Request, RequestQueue, make_trace
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.server import ElasticServer
from repro_torch.serve.slots import SlotManager

__all__ = ["Request", "RequestQueue", "make_trace", "Scheduler",
           "SlotManager", "ElasticServer"]
