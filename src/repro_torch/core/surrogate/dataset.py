"""Harvest surrogate training rows from journals and ResultsDB tables.

Feature schema (the "surrogate contract", see docs/architecture.md):

* one integer column per space parameter — the parameter's *value index*
  (mixed-radix code), exactly the encoding the Fig-6 PFI analysis and
  SurrogateBO already train on; histogram-GBDT bins are value indices, so
  no further featurization is needed,
* one trailing ``arch`` column — the ordinal of the architecture in the
  model's recorded vocabulary (:data:`DEFAULT_ARCHS` unless the caller
  names one: the measured card's ``h100``, then the cost model's
  ``ARCH_NAMES``), so one model spans the card and the model's ids and
  transfers to a held-out one,
* target: ``log(seconds)`` of valid measurements only.

Leakage guards: model-estimated trials (screening provenance
``info["estimated"]``) are never harvested — a surrogate must not train on
its own predictions — and non-finite objectives are dropped.  ``(row,
arch)`` pairs are deduplicated keeping the first occurrence, so a session
trace republished as a ResultsDB table does not double-weight its rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..costmodel import ARCH_NAMES
from ..problem import DEFAULT_ARCH
from ..space import SearchSpace
from ..spacetable import CompiledSpace, mixed_radix_strides

#: the default arch vocabulary: the measured card's id (the arch of every
#: measured row) first, then the cost model's ids.  A model records the
#: vocabulary it was fitted with, so its ordinals stay stable.
DEFAULT_ARCHS: tuple[str, ...] = (DEFAULT_ARCH, *ARCH_NAMES)

@dataclass
class TrainingSet:
    """Harvested feature matrix for one kernel."""

    problem: str
    param_names: tuple[str, ...]
    archs: tuple[str, ...]            # arch-ordinal vocabulary
    X: np.ndarray                     # (n, P+1) int64: codes + arch ordinal
    y: np.ndarray                     # (n,) float64: log seconds
    rows: np.ndarray                  # (n,) int64: source flat rows
    n_sources: int = 0                # journals/tables contributing rows

    def __len__(self) -> int:
        return len(self.y)

    def split_arch(self, arch: str) -> tuple["TrainingSet", "TrainingSet"]:
        """(rest, held_out) — the held-out-architecture evaluation split."""
        ordinal = self.archs.index(arch)
        mask = self.X[:, -1] == ordinal
        rest = TrainingSet(self.problem, self.param_names, self.archs,
                           self.X[~mask], self.y[~mask], self.rows[~mask],
                           self.n_sources)
        held = TrainingSet(self.problem, self.param_names, self.archs,
                           self.X[mask], self.y[mask], self.rows[mask],
                           self.n_sources)
        return rest, held


class Harvest:
    """Incremental training-set builder over heterogeneous sources."""

    def __init__(self, problem: str, space: SearchSpace,
                 archs: tuple[str, ...] = DEFAULT_ARCHS,
                 exclude_archs: tuple[str, ...] = ()):
        self.problem = problem
        self.space = space
        self.archs = tuple(archs)
        self.exclude = frozenset(exclude_archs)
        self._rows: list[int] = []
        self._ords: list[int] = []
        self._objs: list[float] = []
        self._seen: set[tuple[int, int]] = set()
        self.n_sources = 0
        self.n_skipped_estimated = 0

    # -- low-level ---------------------------------------------------------- #
    def add_rows(self, rows, arch: str, objectives) -> int:
        """Add measured ``(row, objective-seconds)`` pairs for one arch;
        returns how many were genuinely new."""
        if arch in self.exclude or arch not in self.archs:
            return 0
        ordinal = self.archs.index(arch)
        added = 0
        for row, obj in zip(rows, objectives):
            obj = float(obj)
            if not (math.isfinite(obj) and obj > 0):
                continue
            key = (int(row), ordinal)
            if key in self._seen:
                continue
            self._seen.add(key)
            self._rows.append(int(row))
            self._ords.append(ordinal)
            self._objs.append(obj)
            added += 1
        return added

    # -- sources ------------------------------------------------------------ #
    def add_table(self, table) -> int:
        """One :class:`~repro_torch.core.results.ResultTable` (configs are the
        mixed-radix codes, so rows come from one strides dot-product)."""
        if table.problem != self.problem or not len(table):
            return 0
        strides = mixed_radix_strides(
            [p.cardinality for p in self.space.params])
        codes = np.asarray(table.configs, dtype=np.int64)
        rows = codes @ strides
        added = self.add_rows(rows.tolist(), table.arch, table.objectives)
        if added:
            self.n_sources += 1
        return added

    def add_db(self, db) -> int:
        """Every table of this problem in a :class:`ResultsDB`."""
        added = 0
        for prob, arch, protocol in db.list_tables():
            if prob != self.problem:
                continue
            added += self.add_table(db.get(prob, arch, protocol))
        return added

    def add_store(self, store) -> int:
        """Every journaled session of this problem in a
        :class:`~repro_torch.orchestrator.store.SessionStore` (plus its published
        tables).  Screened (model-estimated) journal records are skipped —
        the leakage guard."""
        added = 0
        for sid in store.list_sessions():
            try:
                spec = store.load_spec(sid)
            except (KeyError, ValueError, OSError):
                continue               # stray directory, not a session
            if spec.problem != self.problem:
                continue
            rows, objs = [], []
            for key, t in store.load_journal(sid, self.space, spec.arch):
                if t.info.get("estimated"):
                    self.n_skipped_estimated += 1
                    continue
                if t.ok:
                    rows.append(key)
                    objs.append(t.objective)
            n = self.add_rows(rows, spec.arch, objs)
            if n:
                self.n_sources += 1
            added += n
        added += self.add_db(store.tables)
        return added

    # -- output -------------------------------------------------------------- #
    def build(self) -> TrainingSet:
        rows = np.asarray(self._rows, dtype=np.int64)
        codes = (CompiledSpace.codes_for(self.space, rows)
                 if len(rows) else
                 np.empty((0, len(self.space.params)), dtype=np.int64))
        X = np.concatenate(
            [codes, np.asarray(self._ords, dtype=np.int64).reshape(-1, 1)],
            axis=1)
        y = np.log(np.asarray(self._objs, dtype=np.float64)) \
            if len(rows) else np.empty(0)
        return TrainingSet(self.problem, self.space.param_names, self.archs,
                           X, y, rows, self.n_sources)
