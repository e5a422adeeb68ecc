"""Tuning sessions — the orchestrator's unit of work.

A :class:`SessionSpec` names one tuning run: problem × tuner × arch ×
budget × seed (plus tuner kwargs and the evaluation-parallelism settings
that make the run reproducible).  The spec is pure data — JSON-serializable,
content-addressed (``session_id``) — so a campaign can be submitted, killed
and resumed across processes and machines.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

from ..core.problem import DEFAULT_ARCH

#: lifecycle states persisted in the session store
CREATED, RUNNING, INTERRUPTED, DONE, FAILED = (
    "created", "running", "interrupted", "done", "failed")

#: per-tuner kwargs a campaign grid applies beneath explicit settings.
#: SurrogateBO defaults to batched qLCB acquisition in campaigns: width-8
#: batches keep the evaluation sweeps in the columnar regime (and a fleet
#: of broker workers busy) where the study default of width 1 would
#: serialize every evaluation behind a GBDT refit.  A batch width is a
#: *tuner* setting — it changes the trajectory by design and is part of
#: the spec identity — which is why the default lives here, applied when
#: specs are built, never silently at run time.
CAMPAIGN_TUNER_DEFAULTS: dict[str, dict[str, Any]] = {
    "surrogate_bo": {"batch_width": 8},
}


@dataclass
class SessionSpec:
    """One tuning run, fully described by data.

    ``workers`` is the session's stored evaluation parallelism (the CLI can
    override it at resume time).  It never affects the trajectory: batch
    width is set by the tuner alone, so any worker count replays the same
    ask stream, budget accounting, and journal.
    """

    problem: str
    tuner: str
    arch: str = DEFAULT_ARCH
    budget: int = 100
    seed: int = 0
    workers: int = 4
    unique: bool = True
    tuner_kwargs: dict[str, Any] = field(default_factory=dict)
    problem_kwargs: dict[str, Any] = field(default_factory=dict)
    #: surrogate warm start: predicted-top rows proposed before the tuner's
    #: own ask stream.  Part of the spec identity (it changes the
    #: trajectory by design), stored as the resolved row list — not a model
    #: reference — so resuming replays the exact same warm queue even if
    #: the model store has since been retrained.  ``None`` == cold start,
    #: and is omitted from the canonical form so every pre-existing
    #: session id (and journal directory) is unchanged.
    warm_start: list[int] | None = None

    # -- identity --------------------------------------------------------- #
    def canonical(self) -> dict:
        c = {
            "problem": self.problem, "tuner": self.tuner, "arch": self.arch,
            "budget": int(self.budget), "seed": int(self.seed),
            "workers": int(self.workers), "unique": bool(self.unique),
            "tuner_kwargs": dict(sorted(self.tuner_kwargs.items())),
            "problem_kwargs": dict(sorted(self.problem_kwargs.items())),
        }
        if self.warm_start is not None:
            c["warm_start"] = [int(r) for r in self.warm_start]
        return c

    @property
    def share_key(self) -> tuple:
        """The problem identity (name + kwargs).  An objective is a pure
        function of (problem, row, arch), so sessions agreeing on this key
        — any mix of tuners, seeds, budgets and architectures — may be
        served from one arch-shared evaluation cache: each deduped row is
        evaluated once and every architecture reads the shared value
        columns."""
        c = self.canonical()
        return (c["problem"], json.dumps(c["problem_kwargs"], sort_keys=True))

    @property
    def session_id(self) -> str:
        """Content-addressed id: stable across processes, unique per spec."""
        blob = json.dumps(self.canonical(), sort_keys=True).encode()
        h = hashlib.sha1(blob).hexdigest()[:8]
        return (f"{self.problem}-{self.tuner}-{self.arch}"
                f"-b{self.budget}-s{self.seed}-{h}")

    # -- (de)serialization ------------------------------------------------ #
    def to_json(self) -> dict:
        return self.canonical()

    @staticmethod
    def from_json(d: dict) -> "SessionSpec":
        return SessionSpec(
            problem=d["problem"], tuner=d["tuner"],
            arch=d.get("arch", DEFAULT_ARCH),
            budget=int(d.get("budget", 100)), seed=int(d.get("seed", 0)),
            workers=int(d.get("workers", 4)),
            unique=bool(d.get("unique", True)),
            tuner_kwargs=dict(d.get("tuner_kwargs", {})),
            problem_kwargs=dict(d.get("problem_kwargs", {})),
            warm_start=(None if d.get("warm_start") is None
                        else [int(r) for r in d["warm_start"]]))
