"""Static contract checker + search-space auditor
(``python -m repro_torch.orchestrator lint``).

Distinct from :mod:`repro_torch.core.analysis` (paper analytics over measured
data): this package checks *code* and *space definitions* before anything
runs.  Two halves:

* :mod:`~repro_torch.staticcheck.engine` + :mod:`~repro_torch.staticcheck.rules` —
  an AST rule engine enforcing the repo's documented contracts
  (determinism seams, chaos-site registry, telemetry naming, journal
  grammar, never-raise serving, broker transaction discipline, shared
  retry policy).  See "Checked contracts" in ``docs/architecture.md``.
* :mod:`~repro_torch.staticcheck.spaceaudit` — audits a kernel's
  ``SearchSpace`` without measuring anything: unsatisfiable constraint
  sets, dead parameter values, redundant constraints, and Hamming-1
  connectivity of the valid region.
"""

from .engine import (Engine, FileContext, Finding, Rule, apply_baseline,
                     load_baseline, write_baseline)
from .rules import default_rules
from .spaceaudit import SpaceAuditReport, SpaceFinding, audit_space

__all__ = ["Engine", "FileContext", "Finding", "Rule", "default_rules",
           "load_baseline", "write_baseline", "apply_baseline",
           "SpaceAuditReport", "SpaceFinding", "audit_space"]
