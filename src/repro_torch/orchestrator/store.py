"""Session persistence: crash-safe journals + finished traces in ResultsDB.

Layout (one directory per session under the store root)::

    <root>/<session_id>/meta.json      # spec + status + progress counters
    <root>/<session_id>/trials.jsonl   # append-only evaluation journal
    <root>/tables/                     # ResultsDB: finished session traces

The journal is the resume mechanism: one line per *budget-consuming*
evaluation, appended (and flushed) as batches complete.  A killed session
loses at most the in-flight batch; on resume the runner replays the journal
through the tuner — journaled configs are answered from the journal instead
of being re-evaluated, which reconstructs the tuner's RNG state and the
trial trace exactly, then continues with fresh evaluations.

Finished sessions additionally publish their full trace as a
:class:`ResultTable` through :class:`ResultsDB` (protocol
``session_<id>``), so campaign analyses read tuning traces through the same
cache layer as the paper's exhaustive/sampled tables.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Iterable

from ..core.problem import DEFAULT_ARCH, Trial, TunableProblem
from ..core.results import ResultsDB, ResultTable
from ..core.space import SearchSpace
from ..core.tuners.base import TuneResult
from ..telemetry import metrics as _metrics
from ..telemetry.trace import span
from . import chaos
from .session import CREATED, SessionSpec

_log = logging.getLogger("repro_torch.orchestrator.store")


#: info value types the journal persists as-is
_JSON_SCALARS = (str, bool, int, float, type(None))


def _json_safe_value(v):
    """``v`` if it round-trips through JSON unchanged, else ``None`` marker.

    Returns ``(ok, value)`` so legitimate ``None`` values survive."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return True, v
    if isinstance(v, int):
        return True, int(v)
    if isinstance(v, float):
        return math.isfinite(v), v     # inf/nan are not JSON
    if isinstance(v, (list, tuple)):
        parts = [_json_safe_value(x) for x in v]
        return all(ok for ok, _ in parts), [x for _, x in parts]
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            return False, None
        parts = {k: _json_safe_value(x) for k, x in v.items()}
        return (all(ok for ok, _ in parts.values()),
                {k: x for k, (_, x) in parts.items()})
    return False, None


def _json_safe_info(info: dict) -> dict:
    """The JSON-round-trippable subset of a trial's ``info``.

    Fault markers (``error``/``poison``/``attempts``), constraint-violation
    lists and any other plain-data entries persist; derived object payloads
    (``features``: a :class:`KernelFeatures`) are recomputable from the row
    and are dropped rather than serialized lossily."""
    out = {}
    for k, v in info.items():
        ok, safe = _json_safe_value(v)
        if ok:
            out[k] = safe
    return out


class SessionStore:
    """Directory-backed session state with atomic metadata updates.

    ``clock`` is the single time source for the ``created_at``/
    ``updated_at`` metadata stamps — injectable so tests (and the
    staticcheck wall-clock rule) can hold the journal path to a
    deterministic clock; the default is wall time because the stamps
    are operator-facing ages, shared across processes.
    """

    def __init__(self, root: str | Path, *, clock=time.time):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.tables = ResultsDB(self.root / "tables")
        self._clock = clock

    # -- paths ------------------------------------------------------------ #
    def _dir(self, sid: str) -> Path:
        return self.root / sid

    def _meta_path(self, sid: str) -> Path:
        return self._dir(sid) / "meta.json"

    def _journal_path(self, sid: str) -> Path:
        return self._dir(sid) / "trials.jsonl"

    def exists(self, sid: str) -> bool:
        return self._meta_path(sid).exists()

    def list_sessions(self) -> list[str]:
        return sorted(p.parent.name for p in self.root.glob("*/meta.json"))

    # -- lifecycle -------------------------------------------------------- #
    def create(self, spec: SessionSpec) -> str:
        """Register a session (idempotent): returns its id."""
        sid = spec.session_id
        d = self._dir(sid)
        d.mkdir(parents=True, exist_ok=True)
        if not self._meta_path(sid).exists():
            self._write_meta(sid, {
                "spec": spec.to_json(), "status": CREATED,
                "evaluated": 0, "best": None,
                "created_at": self._clock(), "updated_at": self._clock()})
        return sid

    def load_spec(self, sid: str) -> SessionSpec:
        return SessionSpec.from_json(self.meta(sid)["spec"])

    def meta(self, sid: str) -> dict:
        return json.loads(self._meta_path(sid).read_text())

    def _write_meta(self, sid: str, meta: dict) -> None:
        p = self._meta_path(sid)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(meta, indent=1, sort_keys=True))
        os.replace(tmp, p)            # atomic: readers never see a torn file

    def update_meta(self, sid: str, **fields) -> dict:
        meta = self.meta(sid)
        meta.update(fields)
        meta["updated_at"] = self._clock()
        self._write_meta(sid, meta)
        return meta

    # -- journal ---------------------------------------------------------- #
    def append_trials(self, sid: str, space: SearchSpace,
                      trials: Iterable[tuple[int, Trial]]) -> None:
        """Append (key, trial) records and fsync — the crash-safety point.

        Journal v2: the key *is* the row (``key == space.flat_index(config)``
        by the runner's dedup contract), so records are row-native —
        ``{"k": row, "o": seconds|null, "v": valid, "i": info}`` — with no
        redundant encoded-config column.  ``"i"`` persists the JSON-safe
        subset of ``Trial.info`` (fault markers like ``poison``/``attempts``/
        ``error`` included; derived payloads like ``KernelFeatures`` are
        recomputable and excluded), so a resumed trace replays
        ``info``-identical to the uninterrupted run.  v1 records (with the
        ``"c"`` column) are still read by :meth:`load_journal`.
        """
        lines = []
        for key, t in trials:
            rec = {"k": int(key),
                   "o": None if not math.isfinite(t.objective) else t.objective,
                   "v": bool(t.valid)}
            info = _json_safe_info(t.info)
            if info:
                rec["i"] = info
            lines.append(json.dumps(rec, separators=(",", ":")))
        if not lines:
            return
        torn = chaos.fire(chaos.JOURNAL_APPEND_TORN)
        with span("journal.append", cat="store", n=len(lines)), \
                open(self._journal_path(sid), "ab+") as f:
            # a crash mid-append can leave a torn final line; never glue new
            # records onto it — the torn line must stay its own (skippable) line
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
            if torn is not None:
                # injected crash mid-write: every line lands whole except
                # the last, which is cut mid-record with no newline — the
                # exact artifact a power loss during this write leaves
                last = lines[-1].encode()
                cut = max(1, min(len(last) - 1,
                                 int(len(last) * float(torn.get("frac", 0.5)))))
                f.write(b"".join(ln.encode() + b"\n" for ln in lines[:-1]))
                f.write(last[:cut])
                f.flush()
                os.fsync(f.fileno())
            else:
                f.write(("\n".join(lines) + "\n").encode())
                f.flush()
                os.fsync(f.fileno())
        if torn is not None:
            chaos.die(chaos.JOURNAL_APPEND_TORN, torn)

    def journal_version(self, sid: str) -> int | None:
        """Sniff a session's journal format: ``2`` (row-native), ``1``
        (config-column records, written by pre-v2 orchestrators), or
        ``None`` when no journal records exist yet.  Broker campaigns use
        this to refuse v1 stores loudly instead of failing downstream."""
        p = self._journal_path(sid)
        if not p.exists():
            return None
        with open(p) as f:             # first parseable line decides —
            for line in f:             # never slurp a multi-MB journal
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue           # torn line from a crash mid-append
                return 1 if "c" in rec else 2
        return None

    def load_journal(self, sid: str, space: SearchSpace,
                     arch: str = DEFAULT_ARCH) -> list[tuple[int, Trial]]:
        """Journaled evaluations in original ask order.

        A crash mid-append can tear one line (append_trials guarantees the
        tear never merges with later records); torn lines are skipped — the
        one lost evaluation is simply redone — but never silently: each
        skip is logged and counted (telemetry counter
        ``journal.torn_lines``).  The file is streamed line-by-line, never
        slurped — resume cost stays flat in journal size.
        """
        p = self._journal_path(sid)
        if not p.exists():
            return []
        out: list[tuple[int, Trial]] = []
        torn = 0
        with open(p) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    torn += 1          # torn line from a crash mid-append
                    continue
                obj = math.inf if rec["o"] is None else float(rec["o"])
                key = int(rec["k"])
                if "c" in rec:         # v1 record: explicit encoded config
                    cfg = space.decode(rec["c"])
                    info = dict(rec.get("i", {}))
                    if "e" in rec:
                        info["error"] = rec["e"]
                    t = Trial(cfg, obj, arch, valid=bool(rec["v"]), info=info)
                else:                  # v2: row-only — decode lazily, if ever
                    t = Trial(None, obj, arch, valid=bool(rec["v"]),
                              info=dict(rec.get("i", {})), row=key,
                              space=space)
                out.append((key, t))
        if torn:
            _log.warning(
                "journal %s: skipped %d torn line(s) (crash mid-append); "
                "the lost evaluation(s) will be redone on resume", sid, torn)
            _metrics.counter("journal.torn_lines", session=sid).inc(torn)
        return out

    # -- finished traces --------------------------------------------------- #
    def publish_trace(self, sid: str, problem: TunableProblem,
                      result: TuneResult) -> Path:
        """Write the completed trace as a ResultTable through ResultsDB.

        Model-estimated trials (surrogate screening provenance) are not
        published: a ResultTable is a table of *measurements* — servedb
        golden configs and surrogate harvests both distill from it, and a
        model must never serve or retrain on its own predictions.  The
        screened count is recorded in the table meta instead.
        """
        measured = [t for t in result.trials if not t.info.get("estimated")]
        with span("journal.publish", cat="store", n=len(measured)):
            table = ResultTable.from_trials(problem, result.arch,
                                            measured,
                                            protocol=f"session_{sid}")
            table.meta = {"tuner": result.tuner, "seed": result.seed,
                          "session": sid}
            screened = len(result.trials) - len(measured)
            if screened:
                table.meta["screened"] = screened
            return self.tables.put(table)
