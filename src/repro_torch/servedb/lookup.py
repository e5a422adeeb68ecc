"""The never-raise lookup chain: exact → nearest → heuristic → default.

:class:`ServeDB` is the serving-side face of the find-DB.  Its one public
question — :meth:`ServeDB.lookup` — answers *"best config for (kernel,
shape, arch) right now"* and is contractually total: it returns a
:class:`LookupResult` for every input, under every disk state (no
snapshot, torn snapshot, stale snapshot, unknown kernel), and never
raises.  Degradation is explicit, not silent: the result records which
tier answered, and per-tier telemetry counters let a fleet dashboard see
a serving path quietly living on defaults.

The chain, in order (first tier that can answer wins):

``exact``
    A snapshot entry for this (kernel, arch) whose shape key matches
    byte-for-byte.
``nearest``
    The same-arch entry nearest in log2 shape space
    (:func:`~.snapshot.shape_distance`), ties broken by shape key — the
    chain is deterministic, so repeated lookups (and lookups across a
    hot-reload of an unchanged snapshot) are bit-identical.
``heuristic``
    Best-effort, in sub-order: the distilled per-(kernel, arch)
    heuristic config; then a *cross-arch* entry for the same kernel
    (nearest shape, archs in sorted order) — the paper's portability
    result (58.5–99.9% of optimal) makes a transferred config a better
    floor than a static default; then a pure cost-model pick (only if
    the kernel stack imports, never required).
``default``
    :data:`~.defaults.STATIC_DEFAULTS`, or ``{}`` for unknown kernels.

Staleness: a snapshot past its TTL stops answering from its tables (the
paper's portability numbers say a wrong cached config is a real failure
mode, not a hypothetical) — the chain skips straight to heuristic/
default and flags the result ``stale`` so callers can distinguish
"degraded because old" from "degraded because absent".  Pass
``serve_stale=True`` to keep serving flagged-stale table hits instead.

Hot reload: lookups re-stat the snapshot at most every
``reload_every_s`` and atomically swap in a changed file; a corrupt
replacement is quarantined while the in-memory snapshot keeps serving.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from pathlib import Path

from ..core.costmodel import ARCH_NAMES
from ..core.costmodel import DEFAULT_ARCH as MODEL_ARCH
from ..core.problem import DEFAULT_ARCH
from ..telemetry import metrics as _metrics
from . import snapshot as snap_mod
from .defaults import default_config
from .snapshot import SNAPSHOT_NAME, Snapshot, shape_distance, shape_key

__all__ = ["TIERS", "LookupResult", "ServeDB"]

#: degradation order, best first — the contract tests assert this ordering
TIERS = ("exact", "nearest", "heuristic", "default")


@dataclass
class LookupResult:
    """One answered lookup, with its provenance.

    ``tier`` says how degraded the answer is (see :data:`TIERS`);
    ``detail`` narrows it (``heuristic:cross-arch``, ``default:static``);
    ``matched_shape``/``distance`` identify the donor entry for
    nearest/cross-arch answers; ``stale`` marks answers produced while
    the snapshot was past its TTL; ``generation`` is the snapshot that
    answered (0 = no snapshot).
    """

    kernel: str
    arch: str
    shape: dict
    config: dict
    tier: str
    detail: str = ""
    objective: float | None = None
    matched_shape: dict | None = None
    distance: float = 0.0
    stale: bool = False
    generation: int = 0

    def degraded(self) -> bool:
        return self.tier != "exact"


def _best_entry(entries: list[dict], shape: dict) -> tuple[dict, float] | None:
    """The entry nearest to ``shape`` — deterministic: distance, then
    shape key, orders the candidates totally."""
    if not entries:
        return None
    scored = sorted(
        (shape_distance(shape, e.get("shape") or {}),
         shape_key(e.get("shape")), i)
        for i, e in enumerate(entries))
    d, _, i = scored[0]
    return entries[i], d


class ServeDB:
    """Hot-reloading, never-raising view over one find-DB directory."""

    def __init__(self, root: str | Path, *, ttl_s: float | None = None,
                 serve_stale: bool = False, reload_every_s: float = 1.0,
                 use_cost_model: bool = True):
        self.root = Path(root)
        self.ttl_s = ttl_s              # None: honor the snapshot's own TTL
        self.serve_stale = serve_stale
        self.reload_every_s = reload_every_s
        self.use_cost_model = use_cost_model
        self._lock = threading.Lock()
        self._snapshot: Snapshot | None = None
        self._stat: tuple[int, int] | None = None   # (mtime_ns, size)
        #: the live name is empty because a corrupt replacement was
        #: quarantined — keep serving the in-memory snapshot until a
        #: valid successor lands (missing != deleted in that window)
        self._quarantine_hold = False
        self._next_stat = 0.0           # monotonic deadline for re-stat
        self._tier_counts: dict[str, int] = {t: 0 for t in TIERS}
        self._problems: list[str] = []
        #: kernel -> cost-model pick (or None when the stack is absent)
        self._cm_cache: dict[str, dict | None] = {}
        self.reload(force=True)

    # ------------------------------------------------------------------ #
    # snapshot lifecycle
    # ------------------------------------------------------------------ #
    def _stat_snapshot(self) -> tuple[int, int] | None:
        try:
            st = (self.root / SNAPSHOT_NAME).stat()
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def reload(self, force: bool = False) -> bool:
        """Re-stat the live snapshot and swap it in if it changed.

        Returns True when a new snapshot was loaded.  A corrupt
        replacement is quarantined and the previous in-memory snapshot
        keeps serving — readers only ever move forward to a *valid*
        snapshot.  Never raises.
        """
        try:
            with self._lock:
                now = time.monotonic()
                if not force and now < self._next_stat:
                    return False
                self._next_stat = now + self.reload_every_s
                st = self._stat_snapshot()
                if not force and st == self._stat:
                    return False
                snap, problems = snap_mod.load(self.root)
                self._problems = problems
                self._stat = st
                if snap is not None:
                    changed = (self._snapshot is None
                               or snap.generation != self._snapshot.generation
                               or snap.created_at != self._snapshot.created_at)
                    self._snapshot = snap
                    self._quarantine_hold = False
                    if changed:
                        _metrics.counter("servedb.reload").inc()
                    return changed
                if problems:
                    self._quarantine_hold = True
                elif st is None and not self._quarantine_hold:
                    # genuinely gone (not corrupt-and-quarantined): a
                    # deleted DB must stop serving its old tables
                    self._snapshot = None
                return False
        except Exception as e:          # pragma: no cover - belt and braces
            self._problems = [f"reload failed: {e}"]
            return False

    @property
    def snapshot(self) -> Snapshot | None:
        return self._snapshot

    def problems(self) -> list[str]:
        """Load-side problems from the most recent (re)load — corrupt
        snapshot quarantined, binary checksum failures, and so on."""
        return list(self._problems)

    def tier_counts(self) -> dict[str, int]:
        """Lookups answered per tier since construction (the hit-rate
        numbers BENCH_servedb.json records)."""
        with self._lock:
            return dict(self._tier_counts)

    # ------------------------------------------------------------------ #
    # the chain
    # ------------------------------------------------------------------ #
    def lookup(self, kernel: str, shape: dict | None = None,
               arch: str = DEFAULT_ARCH) -> LookupResult:
        """Answer (kernel, shape, arch).  **Never raises.**"""
        try:
            return self._lookup(kernel, dict(shape or {}), arch)
        except Exception as e:
            # the last-ditch floor: even a bug in the chain itself must
            # not take the serving path down
            res = LookupResult(kernel=kernel, arch=arch,
                               shape=dict(shape or {}),
                               config=default_config(kernel),
                               tier="default",
                               detail=f"default:chain-error:{type(e).__name__}")
            self._record(res)
            return res

    def _lookup(self, kernel: str, shape: dict, arch: str) -> LookupResult:
        self.reload()
        snap = self._snapshot
        stale = snap is not None and snap.stale(self.ttl_s)
        gen = snap.generation if snap is not None else 0

        def result(**kw) -> LookupResult:
            res = LookupResult(kernel=kernel, arch=arch, shape=shape,
                               stale=stale, generation=gen, **kw)
            self._record(res)
            return res

        tables_usable = snap is not None and (self.serve_stale or not stale)
        if tables_usable:
            group = snap.group(kernel, arch)
            entries = group.get("entries", []) if group else []
            # -- exact ------------------------------------------------- #
            want = shape_key(shape)
            for e in entries:
                if shape_key(e.get("shape")) == want:
                    return result(config=dict(e["config"]), tier="exact",
                                  detail=e.get("protocol", ""),
                                  objective=e.get("objective"),
                                  matched_shape=e.get("shape"))
            # -- nearest ----------------------------------------------- #
            hit = _best_entry(entries, shape)
            if hit is not None:
                e, d = hit
                return result(config=dict(e["config"]), tier="nearest",
                              detail=e.get("protocol", ""),
                              objective=e.get("objective"),
                              matched_shape=e.get("shape"), distance=d)
            # -- heuristic: distilled per-group pick -------------------- #
            if group and group.get("heuristic"):
                return result(config=dict(group["heuristic"]),
                              tier="heuristic", detail="heuristic:distilled")
            # -- heuristic: cross-arch transfer ------------------------- #
            for other in sorted(snap.tables.get(kernel, {})):
                if other == arch:
                    continue
                og = snap.tables[kernel][other]
                hit = _best_entry(og.get("entries", []), shape)
                if hit is not None:
                    e, d = hit
                    return result(config=dict(e["config"]), tier="heuristic",
                                  detail=f"heuristic:cross-arch:{other}",
                                  objective=e.get("objective"),
                                  matched_shape=e.get("shape"), distance=d)
        # -- heuristic: cost model (optional, cached, never required) --- #
        cm = self._cost_model_pick(kernel, shape, arch)
        if cm is not None:
            return result(config=dict(cm), tier="heuristic",
                          detail="heuristic:cost-model")
        # -- default ---------------------------------------------------- #
        return result(config=default_config(kernel), tier="default",
                      detail="default:static")

    def _cost_model_pick(self, kernel: str, shape: dict,
                         arch: str) -> dict | None:
        """Analytic-cost-model best over a small deterministic sample of
        the kernel's space.  Cached per (kernel, shape, arch); quietly
        ``None`` whenever the kernel stack (torch, the kernel packages) is
        not importable in the serving process.

        The problem is built on the CPU and asked under a cost-model id:
        the query's own, or ``costmodel.DEFAULT_ARCH`` for the measured
        card's ``h100``; any other arch of a kernel has no pick.  So a
        lookup never measures (on the card, 256 configs) and never
        initialises CUDA.  The toys are host arithmetic under any arch."""
        if not self.use_cost_model:
            return None
        key = f"{kernel}|{shape_key(shape)}|{arch}"
        if key in self._cm_cache:
            return self._cm_cache[key]
        pick: dict | None = None
        try:
            from ..orchestrator.registry import PROBLEM_PATHS, host_problem
            from .distill import REGISTRY_NAME
            reg = REGISTRY_NAME.get(kernel)
            model_arch = arch
            if reg in PROBLEM_PATHS and arch not in ARCH_NAMES:
                model_arch = MODEL_ARCH if arch == DEFAULT_ARCH else None
            if reg is not None and model_arch is not None:
                problem = host_problem(reg, shape=shape) if shape \
                    else host_problem(reg)
                trials = [t for t in problem.sampled(256, 0, model_arch)
                          if t.valid]
                if trials:
                    best = min(trials, key=lambda t: t.objective)
                    pick = dict(best.config)
        except Exception:
            pick = None
        self._cm_cache[key] = pick
        return pick

    def _record(self, res: LookupResult) -> None:
        with self._lock:
            self._tier_counts[res.tier] = \
                self._tier_counts.get(res.tier, 0) + 1
        _metrics.counter("servedb.lookup", kernel=res.kernel,
                         tier=res.tier).inc()
        if res.stale:
            _metrics.counter("servedb.lookup_stale", kernel=res.kernel).inc()
