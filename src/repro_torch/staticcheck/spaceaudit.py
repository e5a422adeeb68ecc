"""Static audit of a kernel's search space: ``lint --spaces``.

A tuner can only be as good as the space it searches — and space bugs
are silent: an over-tight constraint shrinks the space without failing
anything, a dead parameter value wastes every sample that tries it, and
a disconnected valid region strands local-search tuners in whichever
component they start in.  This module finds all of those from the
:class:`~repro_torch.core.spacetable.CompiledSpace` alone, no measurement:

* **unsatisfiable** — the constraint set admits zero configs.
* **dead-value** — a parameter value appearing in *no* valid config;
  either the value list or a constraint is wrong.
* **redundant-constraint** — removing the constraint changes nothing
  (its predicate is implied by the others); harmless but a maintenance
  trap, since editing it silently does nothing.
* **disconnected** — the Hamming-1 neighbor graph over valid configs has
  multiple components, so greedy/local tuners cannot reach every region.

Severity: ``error`` breaks tuning (unsatisfiable), ``warning`` degrades
it (dead values, disconnection), ``info`` is hygiene (redundancy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.space import SearchSpace
from ..core.spacetable import CompiledSpace

__all__ = ["SpaceFinding", "SpaceAuditReport", "audit_space"]

#: above this cross-product size, skip the O(n_constraints * n) mask
#: rebuilds of the redundancy check (the other checks stay on)
DEFAULT_REDUNDANCY_LIMIT = 1 << 20


@dataclass(frozen=True)
class SpaceFinding:
    """One space-level defect."""

    check: str      # unsatisfiable | dead-value | redundant-constraint | disconnected
    severity: str   # error | warning | info
    message: str

    def render(self) -> str:
        return f"[{self.severity}] {self.check}: {self.message}"

    def to_json(self) -> dict:
        return {"check": self.check, "severity": self.severity,
                "message": self.message}


@dataclass
class SpaceAuditReport:
    """All findings for one space, plus the headline numbers."""

    space: str
    n_total: int
    n_valid: int
    n_components: int
    findings: list[SpaceFinding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        """No errors or warnings (info-level findings don't fail)."""
        return not any(f.severity in ("error", "warning")
                       for f in self.findings)

    def to_json(self) -> dict:
        return {"space": self.space, "n_total": self.n_total,
                "n_valid": self.n_valid, "n_components": self.n_components,
                "ok": self.ok,
                "findings": [f.to_json() for f in self.findings]}

    def render(self) -> str:
        head = (f"{self.space}: {self.n_valid}/{self.n_total} valid, "
                f"{self.n_components} component(s)")
        if not self.findings:
            return head + " — ok"
        return "\n".join([head] + [f"  {f.render()}" for f in self.findings])


def _component_count(cs: CompiledSpace) -> int:
    """Connected components of the Hamming-1 graph over valid configs."""
    n = len(cs.valid_rows)
    if n == 0:
        return 0
    indptr, indices = cs.csr_neighbors()
    seen = np.zeros(n, dtype=bool)
    components = 0
    for start in range(n):
        if seen[start]:
            continue
        components += 1
        stack = [start]
        seen[start] = True
        while stack:
            pos = stack.pop()
            for nbr in indices[indptr[pos]:indptr[pos + 1]]:
                if not seen[nbr]:
                    seen[nbr] = True
                    stack.append(int(nbr))
    return components


def _dead_values(space: SearchSpace, cs: CompiledSpace) -> list[SpaceFinding]:
    out = []
    codes = CompiledSpace.codes_for(space, cs.valid_rows)
    for col, p in enumerate(space.params):
        live = np.unique(codes[:, col])
        if len(live) == p.cardinality:
            continue
        dead = sorted(set(range(p.cardinality)) - set(int(i) for i in live))
        vals = [p.values[i] for i in dead]
        out.append(SpaceFinding(
            "dead-value", "warning",
            f"parameter {p.name!r}: value(s) {vals!r} appear in no valid "
            f"config ({len(dead)}/{p.cardinality} dead); tighten the value "
            "list or loosen the constraints"))
    return out


def _redundant_constraints(space: SearchSpace,
                           cs: CompiledSpace) -> list[SpaceFinding]:
    out = []
    for skip in space.constraints:
        rest = [c for c in space.constraints if c is not skip]
        clone = SearchSpace(space.params, rest,
                            name=f"{space.name}~{skip.name}")
        if np.array_equal(CompiledSpace._compute_mask(clone), cs.mask):
            out.append(SpaceFinding(
                "redundant-constraint", "info",
                f"constraint {skip.name!r} excludes nothing the other "
                f"{len(rest)} constraint(s) don't already exclude"))
    return out


def audit_space(space: SearchSpace, *,
                compiled: CompiledSpace | None = None,
                redundancy_limit: int = DEFAULT_REDUNDANCY_LIMIT
                ) -> SpaceAuditReport:
    """Audit ``space``; pure function of the space definition.

    ``compiled`` reuses an existing table (else one is built without
    touching the on-disk cache).  ``redundancy_limit`` bounds the
    cross-product size for the O(constraints) mask-rebuild redundancy
    check; pass ``0`` to disable it entirely.
    """
    cs = compiled
    if cs is None:
        cs = space.compiled(build=False)
    if cs is None:
        cs = CompiledSpace(space, CompiledSpace._compute_mask(space))
    findings: list[SpaceFinding] = []
    n_valid = len(cs.valid_rows)

    if n_valid == 0:
        findings.append(SpaceFinding(
            "unsatisfiable", "error",
            f"constraint set admits zero of {cs.n_total} configs"))
        return SpaceAuditReport(space.name, cs.n_total, 0, 0, findings)

    findings.extend(_dead_values(space, cs))

    if space.constraints and 0 < cs.n_total <= redundancy_limit:
        findings.extend(_redundant_constraints(space, cs))

    n_components = _component_count(cs)
    if n_components > 1:
        findings.append(SpaceFinding(
            "disconnected", "warning",
            f"valid region splits into {n_components} Hamming-1 "
            "components; local-search tuners cannot cross between them "
            "(restarts or a connectivity-aware neighborhood needed)"))

    return SpaceAuditReport(space.name, cs.n_total, n_valid,
                            n_components, findings)
