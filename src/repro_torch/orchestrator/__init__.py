"""repro_torch.orchestrator — tuning sessions, journals, workers and campaigns.

The port of ``repro.orchestrator``: the same session stepper, journal,
store, job queue, broker, campaign scheduler, chaos plane and CLI, with
the port's arch ids and problems, and a worker pool that measures on the
card in spawned processes, one per device (:mod:`.workers`).

The scale-out layer over the shared problem/tuner interface: sessions
(problem × tuner × arch × budget × seed) run batched ask/tell over a
fault-tolerant worker pool, journal every evaluation for exact resume, and
compose into campaigns — the paper's full study grid as one restartable
unit, in-process or on a multi-host broker-served worker fleet.  See
``docs/architecture.md`` for the layer map and the stable contracts
(stepper/EvalRequest protocol, rng-stream contract, journal formats,
broker lease protocol).
"""

from .broker import Broker, MemoryBroker, SQLiteBroker
from .campaign import Campaign, run_campaign
from .chaos import FaultPlan, FaultRule
from .doctor import diagnose
from .queue import Job, JobQueue
from .registry import make_problem, problem_names
from .runner import (EvalRequest, resume_session, run_session,
                     session_stepper)
from .session import SessionSpec
from .store import SessionStore
from .supervisor import FleetSupervisor
from .workers import BrokerWorker, WorkerPool

__all__ = [
    "Broker", "BrokerWorker", "Campaign", "EvalRequest", "FaultPlan",
    "FaultRule", "FleetSupervisor", "Job", "JobQueue", "MemoryBroker",
    "SQLiteBroker", "SessionSpec", "SessionStore", "WorkerPool",
    "diagnose", "make_problem", "problem_names", "resume_session",
    "run_campaign", "run_session", "session_stepper",
]
