"""Deterministic fault injection: the chaos plane behind ``--chaos``.

Long campaigns are exactly where worker crashes, hung measurements, torn
journal writes and lock storms stop being rare — so the fleet's fault
tolerance must be a *tested contract*, not an accident.  This module
plants named injection points ("sites") at the broker/worker/store seams
and fires faults at them on a deterministic, seeded schedule, so tests,
CI and ``benchmarks/chaos_bench.py`` can replay the exact same fault
sequence and assert the survivor invariant: published results
bit-identical to the fault-free run.

Activation (all equivalent)::

    REPRO_CHAOS=plan.json python -m repro_torch.orchestrator worker ...
    REPRO_CHAOS='{"seed":7,"faults":[...]}' ...      # inline JSON
    python -m repro_torch.orchestrator worker ... --chaos plan.json
    chaos.install(FaultPlan(seed=7, rules=[FaultRule("eval.hang", p=0.1)]))

A plan file::

    {"seed": 7,
     "faults": [
       {"site": "worker.crash.before_complete", "p": 0.15,
        "max_fires": 4, "exit": true},
       {"site": "eval.hang", "p": 0.1, "hang_s": 3.0},
       {"site": "worker.heartbeat.stall", "p": 0.05, "stall_s": 8.0}]}

Rule keys ``site``/``p``/``after``/``max_fires`` schedule the fault;
every other key is a site parameter (see :data:`SITES`).

**Determinism.**  Whether the n-th hit of a site fires is a pure
function of ``(seed, salt, site, n)`` — a blake2b hash compared against
``p`` — so a replay with the same plan sees the same faults at the same
points, regardless of thread timing.  The salt (``REPRO_CHAOS_SALT``,
default ``""``) decorrelates processes that would otherwise share a
schedule: the fleet supervisor sets it to ``s<slot>g<generation>`` per
spawn, which is itself deterministic across reruns of the same
scenario, so every worker gets a distinct *but still replayable*
stream.  Site hit counters are per-process (a freshly restarted worker
starts counting from 0).

When no plan is installed every hook is a no-op costing one global
load — chaos follows the telemetry contract: free when off.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["SITES", "FaultRule", "FaultPlan", "ChaosCrash",
           "install", "uninstall", "active", "current_plan",
           "fire", "sleep", "skew", "die", "crash", "stats",
           "WORKER_CRASH_BEFORE_COMPLETE", "JOURNAL_APPEND_TORN",
           "WORKER_HEARTBEAT_STALL", "EVAL_HANG", "BROKER_BUSY",
           "BROKER_CLOCK_SKEW", "SERVEDB_PUBLISH_CRASH",
           "SERVEDB_SNAPSHOT_CORRUPT"]


# Site names as importable constants: call sites (and fault plans built
# in code) reference these instead of re-typing the string — a typo'd
# site then fails at import/lint time, not by silently never firing.
# `repro lint` (staticcheck rule chaos-site) enforces that any literal
# site string appearing in src/ is a member of SITES.
WORKER_CRASH_BEFORE_COMPLETE = "worker.crash.before_complete"
JOURNAL_APPEND_TORN = "journal.append.torn"
WORKER_HEARTBEAT_STALL = "worker.heartbeat.stall"
EVAL_HANG = "eval.hang"
BROKER_BUSY = "broker.busy"
BROKER_CLOCK_SKEW = "broker.clock.skew"
SERVEDB_PUBLISH_CRASH = "servedb.publish.crash"
SERVEDB_SNAPSHOT_CORRUPT = "servedb.snapshot.corrupt"

#: every injection point, with its seam and the rule params it honors
SITES = {
    WORKER_CRASH_BEFORE_COMPLETE:
        "BrokerWorker.serve_one — die after evaluating, before complete "
        "(params: exit=bool for os._exit, exit_code=int)",
    JOURNAL_APPEND_TORN:
        "SessionStore.append_trials — crash mid-write, leaving a "
        "genuinely torn final line (params: frac=float cut point, "
        "exit/exit_code)",
    WORKER_HEARTBEAT_STALL:
        "BrokerWorker heartbeat loop — skip lease renewals for stall_s "
        "seconds (params: stall_s=float)",
    EVAL_HANG:
        "WorkerPool chunk/retry evaluation — sleep hang_s before "
        "evaluating (params: hang_s=float)",
    BROKER_BUSY:
        "SQLiteBroker transaction entry — raise OperationalError "
        "'database is locked' (no params)",
    BROKER_CLOCK_SKEW:
        "broker _now() — offset this one clock reading by skew_s "
        "seconds (params: skew_s=float)",
    SERVEDB_PUBLISH_CRASH:
        "servedb snapshot publish — die after the temp file is written "
        "and fsynced but before the rename commits it, leaving only the "
        "temp artifact (params: exit=bool for os._exit, exit_code=int)",
    SERVEDB_SNAPSHOT_CORRUPT:
        "servedb snapshot publish — corrupt the just-published snapshot "
        "bytes in place, as a torn or bit-rotted sector would (params: "
        "mode='truncate'|'bitflip', frac=float cut/flip point)",
}

#: rule keys that schedule the fault; everything else is a site param
_RULE_KEYS = ("site", "p", "after", "max_fires")


class ChaosCrash(BaseException):
    """An injected crash.  Deliberately a BaseException: worker loops
    catch ``Exception`` to fail-and-requeue jobs, but an injected crash
    must behave like a process death — propagate, kill the loop, and
    let the lease expire."""

    def __init__(self, site: str):
        super().__init__(f"chaos: injected crash at {site}")
        self.site = site


@dataclass(frozen=True)
class FaultRule:
    """Schedule one fault at one site.

    The n-th hit of ``site`` (counting from 0, per process) fires iff
    ``n >= after``, fewer than ``max_fires`` fires have happened, and
    the deterministic per-(seed, salt, site, n) draw lands under ``p``.
    """

    site: str
    p: float = 1.0
    after: int = 0
    max_fires: int | None = None
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.site not in SITES:
            known = ", ".join(sorted(SITES))
            raise ValueError(f"unknown chaos site {self.site!r}; "
                             f"known sites: {known}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"rule {self.site}: p={self.p} not in [0, 1]")

    def to_json(self) -> dict:
        out = {"site": self.site, "p": self.p}
        if self.after:
            out["after"] = self.after
        if self.max_fires is not None:
            out["max_fires"] = self.max_fires
        out.update(self.params)
        return out

    @classmethod
    def from_json(cls, rec: dict) -> "FaultRule":
        params = {k: v for k, v in rec.items() if k not in _RULE_KEYS}
        return cls(site=rec["site"], p=float(rec.get("p", 1.0)),
                   after=int(rec.get("after", 0)),
                   max_fires=(None if rec.get("max_fires") is None
                              else int(rec["max_fires"])),
                   params=params)


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable fault schedule: one rule per attacked site."""

    seed: int = 0
    rules: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        seen = set()
        for r in self.rules:
            if r.site in seen:
                raise ValueError(f"duplicate rule for site {r.site!r}")
            seen.add(r.site)

    def rule(self, site: str) -> FaultRule | None:
        for r in self.rules:
            if r.site == site:
                return r
        return None

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [r.to_json() for r in self.rules]}

    @classmethod
    def from_json(cls, rec: dict) -> "FaultPlan":
        return cls(seed=int(rec.get("seed", 0)),
                   rules=tuple(FaultRule.from_json(f)
                               for f in rec.get("faults", [])))

    @classmethod
    def load(cls, source: str | Path) -> "FaultPlan":
        """A plan from a JSON file path or an inline JSON string."""
        text = str(source)
        if not text.lstrip().startswith("{"):
            text = Path(source).read_text()
        return cls.from_json(json.loads(text))


# --------------------------------------------------------------------- #
# the installed plan (process-global, like the telemetry enable flag)
# --------------------------------------------------------------------- #
_plan: FaultPlan | None = None
_salt: str = ""
_lock = threading.Lock()
_hits: dict[str, int] = {}
_fires: dict[str, int] = {}
#: set by uninstall() so injected hangs/stalls wake up at test teardown
_abort = threading.Event()


def install(plan: FaultPlan, salt: str | None = None) -> None:
    """Arm ``plan`` process-wide; resets hit/fire counters.

    ``salt`` decorrelates this process's schedule from siblings running
    the same plan (default: ``REPRO_CHAOS_SALT`` or ``""``).
    """
    global _plan, _salt, _abort
    with _lock:
        _plan = plan
        _salt = (os.environ.get("REPRO_CHAOS_SALT", "")
                 if salt is None else salt)
        _hits.clear()
        _fires.clear()
        _abort = threading.Event()


def uninstall() -> None:
    """Disarm chaos and wake any thread sleeping in an injected hang."""
    global _plan
    with _lock:
        _plan = None
        _abort.set()


def active() -> bool:
    return _plan is not None


def current_plan() -> FaultPlan | None:
    return _plan


def stats() -> dict[str, dict[str, int]]:
    """Per-site ``{"hits", "fires"}`` counts since install."""
    with _lock:
        return {site: {"hits": n, "fires": _fires.get(site, 0)}
                for site, n in _hits.items()}


def _draw(seed: int, salt: str, site: str, n: int) -> float:
    """Deterministic uniform draw in [0, 1) for the n-th hit of a site."""
    h = hashlib.blake2b(f"{seed}|{salt}|{site}|{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def fire(site: str) -> dict | None:
    """Should the fault at ``site`` fire right now?

    Returns the rule's params dict (possibly empty) when it fires, None
    otherwise.  The decision is deterministic in the per-process hit
    index; when no plan is installed this is a single global load.
    """
    plan = _plan
    if plan is None:
        return None
    rule = plan.rule(site)
    if rule is None:
        return None
    with _lock:
        n = _hits.get(site, 0)
        _hits[site] = n + 1
        if n < rule.after:
            return None
        if rule.max_fires is not None and _fires.get(site, 0) >= rule.max_fires:
            return None
        if _draw(plan.seed, _salt, site, n) >= rule.p:
            return None
        _fires[site] = _fires.get(site, 0) + 1
        return dict(rule.params)


def sleep(site: str, default_s: float = 1.0) -> bool:
    """Fire-and-sleep for hang sites.  Returns True if it slept.  The
    sleep is interruptible by :func:`uninstall` (test teardown)."""
    params = fire(site)
    if params is None:
        return False
    _abort.wait(float(params.get("hang_s", params.get("stall_s", default_s))))
    return True


def skew(site: str = BROKER_CLOCK_SKEW) -> float:
    """Clock offset for this one reading (0.0 when the site is quiet)."""
    params = fire(site)
    if params is None:
        return 0.0
    return float(params.get("skew_s", 5.0))


def die(site: str, params: dict) -> None:
    """Kill this worker the way the rule asks: ``exit: true`` is a hard
    ``os._exit`` (no cleanup — a real crash, for subprocess workers);
    otherwise raise :class:`ChaosCrash` (kills a thread worker's loop)."""
    if params.get("exit"):
        os._exit(int(params.get("exit_code", 137)))
    raise ChaosCrash(site)


def crash(site: str) -> None:
    """Fire-and-die for crash sites; no-op when the site stays quiet."""
    params = fire(site)
    if params is not None:
        die(site, params)


# REPRO_CHAOS arms the plane at import time (mirrors REPRO_TRACE), so
# detached workers and supervisor-spawned subprocesses opt in via env
# without any CLI plumbing.
_env_plan = os.environ.get("REPRO_CHAOS", "")
if _env_plan:
    install(FaultPlan.load(_env_plan))
