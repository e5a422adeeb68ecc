"""Offline integrity check for a session store and its broker queue.

``python -m repro_torch.orchestrator doctor`` answers the on-call question "is this campaign's state
healthy, and if not, what exactly is wrong?" without running anything:
it only reads.  Checks:

* **Journals** — stream every session's journal, counting torn lines
  (crash mid-append) and v1/v2 record mix (a v1 journal continued by a
  v2 orchestrator or vice versa — replay works, but it flags a version
  skew worth knowing about).
* **Status vs reality** — sessions marked ``running`` with no live
  broker lease carrying them (driver presumed dead: resumable, but
  nobody is working on them); sessions marked ``done`` without their
  published ResultTable.
* **Broker** — orphaned/stale leases (expired but unreaped: every
  ``lease``/``collect`` reaps, so a persistently stale lease means no
  driver or worker is touching the queue), failed jobs, and
  metrics-table sanity (finite values, known kinds).
* **Find-DB** (``--servedb``) — servedb snapshot triage: checksum
  verification of the live snapshot (and its binary export), stale-TTL
  flags, quarantine listing, leftover publish temp files; one verdict
  per snapshot artifact.
* **Contracts** (``--lint``) — run the :mod:`repro_torch.staticcheck` rule
  engine over the installed ``repro_torch`` package and fold any findings
  into the problem list, so an on-call triage also surfaces contract drift
  in the deployed code (see "Checked contracts" in docs/architecture.md).

Everything lands in one report dict (``--json``); exit status 1 when
problems were found, 0 when clean.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

from .broker import Broker
from .session import DONE, RUNNING
from .store import SessionStore

__all__ = ["diagnose", "render_report"]

#: metric kinds aggregate_samples understands
_METRIC_KINDS = ("counter", "gauge")


def _scan_journal(path: Path) -> dict:
    """Stream one journal: record/torn counts and the version mix."""
    out = {"records": 0, "torn_lines": 0, "v1_records": 0, "v2_records": 0}
    if not path.exists():
        return out
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                out["torn_lines"] += 1
                continue
            out["records"] += 1
            out["v1_records" if "c" in rec else "v2_records"] += 1
    return out


def diagnose(store: SessionStore, broker: Broker | None = None,
             servedb: str | Path | None = None,
             lint: bool = False) -> dict:
    """Inspect ``store`` (and optionally ``broker`` and a find-DB dir);
    returns the report: ``{"sessions": [...], "broker": {...}|None,
    "servedb": {...}|None, "lint": {...}|None, "problems": [...],
    "ok": bool}``.  Read-only — never reaps, pops, quarantines, or
    mutates.  ``lint=True`` additionally runs the staticcheck contract
    rules over the installed ``repro_torch`` package."""
    problems: list[str] = []

    # sessions whose batches are in flight on the fleet right now
    leased_sids: set[str] = set()
    in_flight: list[dict] = []
    if broker is not None:
        in_flight = broker.in_flight()
        for j in in_flight:
            leased_sids.update(j.get("sessions", []))

    # published traces are keyed by the problem's *kernel* name, which
    # can differ from the registry name (attention -> flash_attention) —
    # match on the session-unique protocol tag instead of guessing the key
    published_tags = {prot for _, _, prot in store.tables.list_tables()}

    sessions = []
    for sid in store.list_sessions():
        meta = store.meta(sid)
        spec = meta.get("spec", {})
        scan = _scan_journal(store._journal_path(sid))
        entry = {"session": sid, "status": meta.get("status"),
                 "evaluated": meta.get("evaluated", 0),
                 "budget": spec.get("budget"), **scan}
        if scan["v1_records"] and scan["v2_records"]:
            entry["journal_version"] = "mixed"
        elif scan["v1_records"]:
            entry["journal_version"] = "v1"
        elif scan["v2_records"]:
            entry["journal_version"] = "v2"
        else:
            entry["journal_version"] = None
        entry["published"] = f"session_{sid}" in published_tags

        if scan["torn_lines"]:
            problems.append(
                f"session {sid}: {scan['torn_lines']} torn journal line(s) "
                f"(crash mid-append; the lost evaluations redo on resume)")
        if entry["journal_version"] == "mixed":
            problems.append(
                f"session {sid}: journal mixes v1 and v2 records "
                f"(written by different orchestrator versions)")
        if entry["status"] == RUNNING:
            if broker is None:
                entry["leased"] = None
            else:
                entry["leased"] = sid in leased_sids
                if not entry["leased"]:
                    problems.append(
                        f"session {sid}: marked running but no live lease "
                        f"carries it (driver presumed dead; resume it)")
        if entry["status"] == DONE and not entry["published"]:
            problems.append(
                f"session {sid}: marked done but its ResultTable "
                f"session_{sid} was never published")
        sessions.append(entry)

    broker_report = None
    if broker is not None:
        counts = broker.counts()
        stale = [j for j in in_flight if j.get("stale")]
        for j in stale:
            problems.append(
                f"job {j['job']}: lease expired "
                f"{-j['lease_remaining']:.1f}s ago and nothing has reaped "
                f"it (worker {j['worker']!r} presumed dead, queue idle)")
        if counts.get("failed", 0):
            problems.append(
                f"broker: {counts['failed']} failed job(s) awaiting "
                f"collect (attempts cap exhausted)")
        bad_samples = 0
        workers = set()
        for s in broker.read_metrics():
            workers.add(s["worker"])
            if s["kind"] not in _METRIC_KINDS \
                    or not math.isfinite(s["value"]):
                bad_samples += 1
        if bad_samples:
            problems.append(
                f"broker: {bad_samples} malformed metric sample(s) "
                f"(non-finite value or unknown kind)")
        broker_report = {"counts": counts, "in_flight": len(in_flight),
                         "stale_leases": len(stale),
                         "metric_workers": len(workers),
                         "bad_metric_samples": bad_samples}

    servedb_report = None
    if servedb is not None:
        from ..servedb.snapshot import verify_dir
        servedb_report = verify_dir(servedb)
        problems.extend(f"servedb: {p}" for p in servedb_report["problems"])

    lint_report = None
    if lint:
        from ..staticcheck import Engine, default_rules
        pkg = _package_dir()
        findings = Engine(default_rules(), root=pkg.parent).lint_paths([pkg])
        lint_report = {"findings": [f.to_json() for f in findings]}
        problems.extend(f"lint: {f.render()}" for f in findings)

    return {"store": str(store.root), "generated_at": time.time(),
            "sessions": sessions, "broker": broker_report,
            "servedb": servedb_report, "lint": lint_report,
            "problems": problems, "ok": not problems}


def _package_dir() -> Path:
    """The installed ``repro_torch`` package's directory: what ``lint``
    and ``doctor --lint`` scan by default."""
    import repro_torch
    return Path(next(iter(repro_torch.__path__)))


def render_report(report: dict) -> str:
    """Human rendering of a :func:`diagnose` report."""
    lines = [f"doctor: {report['store']}"]
    for s in report["sessions"]:
        flags = []
        if s["torn_lines"]:
            flags.append(f"torn x{s['torn_lines']}")
        if s["journal_version"] == "mixed":
            flags.append("v1/v2 mix")
        if s.get("leased") is False and s["status"] == "running":
            flags.append("no lease")
        if s["status"] == "done" and not s["published"]:
            flags.append("unpublished")
        lines.append(
            f"  {s['session']:58s} {s['status']:12s} "
            f"{s['records']:>6d} rec "
            f"{s['journal_version'] or '-':>5s}"
            + (f"  [{', '.join(flags)}]" if flags else ""))
    if report["broker"] is not None:
        b = report["broker"]
        c = b["counts"]
        lines.append(
            f"  broker: pending {c.get('pending', 0)} "
            f"leased {c.get('leased', 0)} done {c.get('done', 0)} "
            f"failed {c.get('failed', 0)}; stale leases "
            f"{b['stale_leases']}; {b['metric_workers']} metric worker(s)")
    if report.get("servedb") is not None:
        sv = report["servedb"]
        for s in sv["snapshots"]:
            if s["status"] == "corrupt":
                lines.append(f"  servedb: {s['file']:24s} CORRUPT  "
                             f"{s['error']}")
            else:
                lines.append(
                    f"  servedb: {s['file']:24s} {s['status'].upper():8s} "
                    f"gen {s['generation']} {s['entries']} entr"
                    f"{'y' if s['entries'] == 1 else 'ies'}"
                    + (f"  binary {'ok' if s['binary_ok'] else 'BAD'}"
                       if "binary_ok" in s else ""))
        if not sv["snapshots"]:
            lines.append(f"  servedb: {sv['root']} — no snapshot")
        if sv["quarantined"]:
            lines.append(f"  servedb: {len(sv['quarantined'])} "
                         f"quarantined artifact(s)")
    if report.get("lint") is not None:
        n = len(report["lint"]["findings"])
        lines.append(f"  lint: {n} contract finding(s)"
                     + ("" if n else " — clean"))
    if report["problems"]:
        lines.append(f"problems ({len(report['problems'])}):")
        lines.extend(f"  - {p}" for p in report["problems"])
    else:
        lines.append("no problems found")
    return "\n".join(lines)
