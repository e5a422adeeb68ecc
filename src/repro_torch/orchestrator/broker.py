"""Durable job-queue backends: the multi-host seam behind the campaign.

The in-process :class:`~repro_torch.orchestrator.queue.JobQueue` is the seam the
ROADMAP names: the campaign scheduler only ever needs something that
accepts :class:`~repro_torch.orchestrator.runner.EvalRequest` batches and hands
back results.  This module provides that something as a *durable* queue —
MITuna-style detached workers leasing jobs out of shared storage — so the
same campaign spec that runs in-process for tests runs on a worker fleet
for real sweeps, with one code path for journaling and resume.

Two interchangeable backends (the conformance suite in
``tests/test_broker.py`` runs every property against both):

* :class:`MemoryBroker` — dict + lock; workers are threads in this
  process.  The test/reference implementation of the protocol.
* :class:`SQLiteBroker` — a WAL-mode SQLite file (stdlib ``sqlite3``).
  N detached ``python -m repro_torch.orchestrator worker --broker <db>``
  processes on any hosts sharing a filesystem serve one campaign.
  (WAL requires a filesystem with working POSIX locks + shared mmap —
  local disks and modern cluster filesystems are fine; classic NFS is
  not a safe home for the queue file.  The ``Broker`` protocol is the
  seam for a networked backend if that matters to you.)

The lease protocol (identical for both)::

    driver                               worker
    ------                               ------
    submit(payload) -> job id
                                         lease(worker, lease_s)
                                           -> (job id, payload) | None
                                         heartbeat(job, worker, lease_s)
                                           ... while evaluating ...
                                         complete(job, worker, result)
                                           (or fail(job, worker, error))
    collect() -> {job id: result}, [failures]

* **Leases expire.**  A worker that stops heartbeating (killed, hung,
  unplugged) loses its lease; :meth:`Broker.reap` — run inside every
  ``lease`` and ``collect`` — requeues the job for the next worker.
* **Attempts are counted at lease time** and capped (``max_attempts``):
  a job that keeps killing its workers terminates as *failed* rather than
  cycling forever — the queue-level analogue of the per-config poison cap
  in :class:`~repro_torch.orchestrator.queue.JobQueue`.
* **Completion requires the lease.**  ``complete``/``fail`` from a worker
  whose lease was reaped (it was presumed dead, the job re-leased) are
  rejected, so two workers racing on a requeued job can never both
  publish a result — concurrent-worker dedup.

Payloads and results are JSON.  A job payload is one merged evaluation
batch::

    {"problem": <registry name>, "pk": {problem kwargs},
     "archs": [arch, ...],
     "rows": [flat row, ...]  |  "configs": [[mixed-radix codes], ...],
     "sessions": [session id, ...]}        # requesters, for `status`

and its result maps each architecture to one ``[objective|null, valid,
info]`` triple per row/config (the journal-v2 convention: ``null``
objective means +inf, ``info`` is the JSON-safe subset — which is exactly
what the driver-side journal would have persisted anyway, so broker-served
trials journal and publish bit-identically to in-process ones).
"""

from __future__ import annotations

import functools
import json
import os
import sqlite3
import threading
import time
import uuid
from pathlib import Path

from ..core.retry import retry_call
from . import chaos
from .queue import DONE, FAILED, LEASED, PENDING

__all__ = ["Broker", "MemoryBroker", "SQLiteBroker",
           "encode_trial", "decode_trials"]




# --------------------------------------------------------------------- #
# trial (de)serialization — the journal-v2 convention
# --------------------------------------------------------------------- #
def encode_trial(trial) -> list:
    """``Trial`` -> ``[objective|null, valid, info]`` (JSON-safe).

    Same lossiness as the resume journal: non-finite objectives become
    ``null``, ``info`` keeps only its JSON-round-trippable subset (fault
    markers included, derived payloads dropped) — so a trial that crossed
    the broker equals one replayed from the journal, and both journal and
    publish identically to the in-process original.
    """
    import math

    from .store import _json_safe_info
    o = None if not math.isfinite(trial.objective) else trial.objective
    return [o, bool(trial.valid), _json_safe_info(trial.info)]


def decode_trials(records, arch: str, space=None, rows=None, configs=None):
    """Rebuild driver-side ``Trial`` lists from a job result.

    Row jobs come back as lazy row-backed trials (config decoded on first
    access, exactly like a journal-v2 replay); config jobs reattach the
    driver's original config dicts.
    """
    import math

    from ..core.problem import Trial
    out = []
    for i, (o, valid, info) in enumerate(records):
        obj = math.inf if o is None else float(o)
        if rows is not None:
            out.append(Trial(None, obj, arch, valid=bool(valid),
                             info=dict(info), row=int(rows[i]), space=space))
        else:
            out.append(Trial(configs[i], obj, arch, valid=bool(valid),
                             info=dict(info)))
    return out


class Broker:
    """Abstract durable job queue; see the module docstring for the
    protocol.  Subclasses implement the storage primitives."""

    max_attempts: int = 3
    #: lease-arithmetic time source.  Wall clock by default because
    #: lease deadlines are persisted epochs shared across processes (a
    #: monotonic clock has no cross-process meaning); injectable so
    #: tests drive expiry deterministically instead of sleeping it out.
    clock = staticmethod(time.time)

    def _now(self) -> float:
        # the chaos plane can skew one reading (site broker.clock.skew)
        # to attack the lease arithmetic; 0.0 whenever chaos is off
        return self.clock() + chaos.skew()

    # -- driver side ------------------------------------------------------ #
    def submit(self, payload: dict) -> int:
        raise NotImplementedError

    def collect(self) -> tuple[dict[int, dict], list[dict]]:
        """Harvest finished work: ``({job id: result}, [failed job dicts])``.

        Pops every DONE job's result and every FAILED job (attempts
        exhausted) exactly once; also reaps expired leases so a fleet
        that died entirely still makes progress once any worker returns.
        """
        raise NotImplementedError

    # -- worker side ------------------------------------------------------ #
    def lease(self, worker: str, lease_s: float) -> tuple[int, dict] | None:
        raise NotImplementedError

    def heartbeat(self, job_id: int, worker: str, lease_s: float) -> bool:
        raise NotImplementedError

    def complete(self, job_id: int, worker: str, result: dict) -> bool:
        raise NotImplementedError

    def fail(self, job_id: int, worker: str, error: str) -> bool:
        raise NotImplementedError

    def attach_sessions(self, job_id: int, sids) -> bool:
        """Add requester session ids to an already-submitted job's
        payload (driver-side metadata only — workers never read it).

        Keeps ``status --broker`` attribution honest when a session
        starts waiting on a pair another session's job already carries.
        Returns False when the job is gone (completed and collected);
        that is not an error.
        """
        raise NotImplementedError

    # -- telemetry ---------------------------------------------------------- #
    def record_metrics(self, worker: str, samples, ts: float | None = None
                       ) -> None:
        """Append worker-emitted metric samples to the broker's durable
        ``metrics`` stream.

        ``samples`` is an iterable of ``{"name", "value", "kind"}`` dicts
        (``kind`` is ``"counter"`` — summed on aggregation — or
        ``"gauge"`` — last-write-wins; see
        :func:`repro_torch.telemetry.metrics.aggregate_samples`).  Samples are
        *never* deleted by :meth:`collect` or lease reaping: a SIGKILLed
        worker's counters survive its jobs being requeued, so fleet
        totals stay honest across worker churn.
        """
        raise NotImplementedError

    def read_metrics(self, worker: str | None = None,
                     name: str | None = None) -> list[dict]:
        """Recorded samples (oldest first), optionally filtered:
        ``{"ts", "worker", "name", "value", "kind"}`` per sample."""
        raise NotImplementedError

    # -- introspection ----------------------------------------------------- #
    def counts(self) -> dict[str, int]:
        raise NotImplementedError

    def in_flight(self) -> list[dict]:
        """Currently-leased jobs: ``{job, worker, heartbeat_age,
        lease_remaining, stale, sessions, attempts}`` — what
        ``status --broker`` reports.  ``stale`` means the lease deadline
        has passed but no ``lease``/``collect`` call has reaped the job
        yet: the worker is presumed dead.  This is a read — it never
        reaps."""
        raise NotImplementedError

    def reap(self) -> int:
        """Requeue (or fail, past the attempts cap) expired leases;
        returns how many jobs changed state."""
        raise NotImplementedError

    def close(self) -> None:
        pass


# --------------------------------------------------------------------- #
# in-memory backend (threads in one process)
# --------------------------------------------------------------------- #
class MemoryBroker(Broker):
    """Reference implementation: a dict under a lock.

    Workers must live in this process (threads); everything else —
    leases, heartbeats, attempts cap, completion-requires-lease — behaves
    exactly like :class:`SQLiteBroker`, which is what makes the
    conformance suite meaningful.
    """

    def __init__(self, max_attempts: int = 3,
                 metrics_sink: str | Path | None = None,
                 clock=None):
        self.max_attempts = max_attempts
        self.metrics_sink = Path(metrics_sink) if metrics_sink else None
        if clock is not None:
            self.clock = clock
        self._lock = threading.Lock()
        self._jobs: dict[int, dict] = {}
        self._metrics: list[dict] = []
        self._next = 1

    def submit(self, payload: dict) -> int:
        with self._lock:
            jid = self._next
            self._next += 1
            self._jobs[jid] = {
                "id": jid, "payload": payload, "state": PENDING,
                "attempts": 0, "worker": None, "lease_expires": None,
                "heartbeat": None, "result": None, "error": None,
                "created": self._now()}
            return jid

    def _reap_locked(self) -> int:
        now, n = self._now(), 0
        for j in self._jobs.values():
            if j["state"] == LEASED and j["lease_expires"] < now:
                n += 1
                if j["attempts"] >= self.max_attempts:
                    j["state"] = FAILED
                    j["error"] = (f"lease expired after attempt "
                                  f"{j['attempts']} (worker {j['worker']!r} "
                                  f"presumed dead)")
                else:
                    j["state"] = PENDING
                j["worker"] = None
        return n

    def reap(self) -> int:
        with self._lock:
            return self._reap_locked()

    def lease(self, worker: str, lease_s: float) -> tuple[int, dict] | None:
        with self._lock:
            self._reap_locked()
            for j in sorted(self._jobs.values(), key=lambda j: j["id"]):
                if j["state"] == PENDING:
                    j["state"] = LEASED
                    j["worker"] = worker
                    j["attempts"] += 1
                    j["lease_expires"] = self._now() + lease_s
                    j["heartbeat"] = self._now()
                    return j["id"], j["payload"]
            return None

    def _owned(self, job_id: int, worker: str):
        j = self._jobs.get(job_id)
        if j is None or j["state"] != LEASED or j["worker"] != worker:
            return None
        return j

    def heartbeat(self, job_id: int, worker: str, lease_s: float) -> bool:
        with self._lock:
            j = self._owned(job_id, worker)
            if j is None:
                return False
            j["lease_expires"] = self._now() + lease_s
            j["heartbeat"] = self._now()
            return True

    def complete(self, job_id: int, worker: str, result: dict) -> bool:
        with self._lock:
            j = self._owned(job_id, worker)
            if j is None:
                return False
            j["state"], j["result"], j["worker"] = DONE, result, None
            return True

    def fail(self, job_id: int, worker: str, error: str) -> bool:
        with self._lock:
            j = self._owned(job_id, worker)
            if j is None:
                return False
            j["error"], j["worker"] = error, None
            j["state"] = FAILED if j["attempts"] >= self.max_attempts \
                else PENDING
            return True

    def attach_sessions(self, job_id: int, sids) -> bool:
        with self._lock:
            j = self._jobs.get(job_id)
            if j is None:
                return False
            j["payload"]["sessions"] = sorted(
                {*j["payload"].get("sessions", []), *sids})
            return True

    def collect(self) -> tuple[dict[int, dict], list[dict]]:
        with self._lock:
            self._reap_locked()
            done: dict[int, dict] = {}
            failed: list[dict] = []
            for jid in [j["id"] for j in self._jobs.values()
                        if j["state"] in (DONE, FAILED)]:
                j = self._jobs.pop(jid)
                if j["state"] == DONE:
                    done[jid] = j["result"]
                else:
                    failed.append({"id": jid, "payload": j["payload"],
                                   "error": j["error"],
                                   "attempts": j["attempts"]})
            return done, failed

    def counts(self) -> dict[str, int]:
        with self._lock:
            out = {PENDING: 0, LEASED: 0, DONE: 0, FAILED: 0}
            for j in self._jobs.values():
                out[j["state"]] += 1
            return out

    def in_flight(self) -> list[dict]:
        with self._lock:
            now = self._now()
            return [{"job": j["id"], "worker": j["worker"],
                     "heartbeat_age": now - j["heartbeat"],
                     "lease_remaining": j["lease_expires"] - now,
                     "stale": j["lease_expires"] < now,
                     "attempts": j["attempts"],
                     "sessions": list(j["payload"].get("sessions", []))}
                    for j in self._jobs.values() if j["state"] == LEASED]

    def record_metrics(self, worker: str, samples, ts: float | None = None
                       ) -> None:
        ts = self._now() if ts is None else ts
        recs = [{"ts": ts, "worker": worker, "name": s["name"],
                 "value": float(s["value"]),
                 "kind": s.get("kind", "counter")} for s in samples]
        if not recs:
            return
        with self._lock:
            self._metrics.extend(recs)
            if self.metrics_sink is not None:
                self.metrics_sink.parent.mkdir(parents=True, exist_ok=True)
                with open(self.metrics_sink, "a") as f:
                    for r in recs:
                        f.write(json.dumps(r, separators=(",", ":")) + "\n")

    def read_metrics(self, worker: str | None = None,
                     name: str | None = None) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._metrics
                    if (worker is None or r["worker"] == worker)
                    and (name is None or r["name"] == name)]


# --------------------------------------------------------------------- #
# SQLite backend (detached worker processes, shared filesystem)
# --------------------------------------------------------------------- #
class _Tx:
    """One IMMEDIATE transaction: commit on clean exit, rollback on error."""

    def __init__(self, conn: sqlite3.Connection):
        self.conn = conn

    def __enter__(self) -> sqlite3.Cursor:
        busy = chaos.fire(chaos.BROKER_BUSY)
        if busy is not None:
            # what sqlite raises when busy_timeout expires under a storm
            raise sqlite3.OperationalError("database is locked (chaos)")
        self.conn.execute("BEGIN IMMEDIATE")
        return self.conn.cursor()

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.conn.execute("COMMIT")
        else:
            self.conn.execute("ROLLBACK")


def _is_busy(e: BaseException) -> bool:
    """Is this the transient SQLITE_BUSY/locked OperationalError?"""
    if not isinstance(e, sqlite3.OperationalError):
        return False
    msg = str(e).lower()
    return "locked" in msg or "busy" in msg


def _busy_retry(fn):
    """Re-run a whole broker transaction on SQLITE_BUSY.

    WAL + ``busy_timeout`` absorb ordinary contention, but when the
    timeout itself expires (a lock storm, a worker wedged mid-COMMIT on
    a sick filesystem) sqlite raises OperationalError — which without
    this wrapper would crash a worker loop over a *transient* condition.
    Retries are bounded (``busy_retries``) with exponential backoff and
    deterministic jitter through the shared policy in
    :mod:`repro_torch.core.retry` (the same code path the servedb snapshot
    publish lock retries through, so the ``broker.busy`` chaos site
    exercises one implementation, not per-caller copies).  Safe because
    every broker mutation is a single self-contained IMMEDIATE
    transaction: nothing is committed yet when BEGIN/COMMIT fails.
    """
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        return retry_call(
            lambda: fn(self, *args, **kwargs),
            retries=getattr(self, "busy_retries", 0),
            retry_on=_is_busy, base_s=0.01, max_s=0.2,
            salt=f"{type(self).__name__}.{fn.__name__}")
    return wrapper


_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    id            INTEGER PRIMARY KEY AUTOINCREMENT,
    payload       TEXT    NOT NULL,
    state         TEXT    NOT NULL DEFAULT 'pending',
    attempts      INTEGER NOT NULL DEFAULT 0,
    worker        TEXT,
    lease_expires REAL,
    heartbeat     REAL,
    result        TEXT,
    error         TEXT,
    created       REAL    NOT NULL
);
CREATE INDEX IF NOT EXISTS jobs_state ON jobs (state, id);
CREATE TABLE IF NOT EXISTS metrics (
    id     INTEGER PRIMARY KEY AUTOINCREMENT,
    ts     REAL    NOT NULL,
    worker TEXT    NOT NULL,
    name   TEXT    NOT NULL,
    value  REAL    NOT NULL,
    kind   TEXT    NOT NULL DEFAULT 'counter'
);
CREATE INDEX IF NOT EXISTS metrics_worker ON metrics (worker, name, id);
"""


class SQLiteBroker(Broker):
    """WAL-mode SQLite job queue for detached multi-process worker fleets.

    Every mutation is a single short IMMEDIATE transaction, so N workers
    and one driver can share the file without an external lock service;
    WAL keeps readers (``status --broker``) off the writers' path.
    Connections are per-thread (``sqlite3`` objects must not cross
    threads), created lazily — a :class:`SQLiteBroker` instance may be
    shared freely.
    """

    def __init__(self, path: str | Path, max_attempts: int = 3,
                 timeout_s: float = 30.0, busy_retries: int = 5,
                 clock=None):
        self.path = Path(path)
        self.max_attempts = max_attempts
        if clock is not None:
            self.clock = clock
        self.timeout_s = timeout_s
        # SQLITE_BUSY past the busy_timeout is transient, not fatal: each
        # mutation (one self-contained IMMEDIATE tx) re-runs up to this
        # many times with backoff before the error propagates
        self.busy_retries = busy_retries
        self._local = threading.local()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._conn().executescript(_SCHEMA)        # idempotent

    # -- connection management -------------------------------------------- #
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=self.timeout_s,
                                   isolation_level=None)  # autocommit; we BEGIN
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute(f"PRAGMA busy_timeout={int(self.timeout_s * 1000)}")
            self._local.conn = conn
        return conn

    def _tx(self) -> "_Tx":
        """``with broker._tx() as cur:`` — one IMMEDIATE transaction."""
        return _Tx(self._conn())

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    # -- protocol ---------------------------------------------------------- #
    @_busy_retry
    def submit(self, payload: dict) -> int:
        with self._tx() as cur:
            cur.execute(
                "INSERT INTO jobs (payload, state, created) VALUES (?,?,?)",
                (json.dumps(payload, separators=(",", ":")), PENDING, self._now()))
            return cur.lastrowid

    def _reap_cur(self, cur: sqlite3.Cursor) -> int:
        now = self._now()
        cur.execute(
            "UPDATE jobs SET "
            " state=CASE WHEN attempts >= ? THEN ? ELSE ? END,"
            " error=CASE WHEN attempts >= ? THEN"
            "  'lease expired after attempt ' || attempts ||"
            "  ' (worker ' || COALESCE(worker,'?') || ' presumed dead)'"
            "  ELSE error END,"
            " worker=NULL "
            "WHERE state = ? AND lease_expires < ?",
            (self.max_attempts, FAILED, PENDING, self.max_attempts,
             LEASED, now))
        return cur.rowcount

    @_busy_retry
    def reap(self) -> int:
        with self._tx() as cur:
            return self._reap_cur(cur)

    @_busy_retry
    def lease(self, worker: str, lease_s: float) -> tuple[int, dict] | None:
        with self._tx() as cur:
            self._reap_cur(cur)
            row = cur.execute(
                "SELECT id, payload FROM jobs WHERE state = ? "
                "ORDER BY id LIMIT 1", (PENDING,)).fetchone()
            if row is None:
                return None
            now = self._now()
            cur.execute(
                "UPDATE jobs SET state=?, worker=?, attempts=attempts+1,"
                " lease_expires=?, heartbeat=? WHERE id=?",
                (LEASED, worker, now + lease_s, now, row["id"]))
            return row["id"], json.loads(row["payload"])

    @_busy_retry
    def heartbeat(self, job_id: int, worker: str, lease_s: float) -> bool:
        with self._tx() as cur:
            now = self._now()
            cur.execute(
                "UPDATE jobs SET lease_expires=?, heartbeat=? "
                "WHERE id=? AND state=? AND worker=?",
                (now + lease_s, now, job_id, LEASED, worker))
            return cur.rowcount == 1

    @_busy_retry
    def complete(self, job_id: int, worker: str, result: dict) -> bool:
        with self._tx() as cur:
            cur.execute(
                "UPDATE jobs SET state=?, result=?, worker=NULL "
                "WHERE id=? AND state=? AND worker=?",
                (DONE, json.dumps(result, separators=(",", ":")),
                 job_id, LEASED, worker))
            return cur.rowcount == 1

    @_busy_retry
    def fail(self, job_id: int, worker: str, error: str) -> bool:
        with self._tx() as cur:
            cur.execute(
                "UPDATE jobs SET "
                " state=CASE WHEN attempts >= ? THEN ? ELSE ? END,"
                " error=?, worker=NULL "
                "WHERE id=? AND state=? AND worker=?",
                (self.max_attempts, FAILED, PENDING, str(error)[:2000],
                 job_id, LEASED, worker))
            return cur.rowcount == 1

    @_busy_retry
    def attach_sessions(self, job_id: int, sids) -> bool:
        with self._tx() as cur:
            row = cur.execute("SELECT payload FROM jobs WHERE id=?",
                              (job_id,)).fetchone()
            if row is None:
                return False
            payload = json.loads(row["payload"])
            payload["sessions"] = sorted(
                {*payload.get("sessions", []), *sids})
            cur.execute("UPDATE jobs SET payload=? WHERE id=?",
                        (json.dumps(payload, separators=(",", ":")),
                         job_id))
            return True

    @_busy_retry
    def collect(self) -> tuple[dict[int, dict], list[dict]]:
        with self._tx() as cur:
            self._reap_cur(cur)
            done: dict[int, dict] = {}
            failed: list[dict] = []
            for row in cur.execute(
                    "SELECT id, payload, state, result, error, attempts "
                    "FROM jobs WHERE state IN (?, ?)", (DONE, FAILED)):
                if row["state"] == DONE:
                    done[row["id"]] = json.loads(row["result"])
                else:
                    failed.append({"id": row["id"],
                                   "payload": json.loads(row["payload"]),
                                   "error": row["error"],
                                   "attempts": row["attempts"]})
            if done or failed:
                ids = [*done, *(f["id"] for f in failed)]
                cur.execute("DELETE FROM jobs WHERE id IN (%s)" %
                            ",".join("?" * len(ids)), ids)
            return done, failed

    def counts(self) -> dict[str, int]:
        out = {PENDING: 0, LEASED: 0, DONE: 0, FAILED: 0}
        for row in self._conn().execute(
                "SELECT state, COUNT(*) AS n FROM jobs GROUP BY state"):
            out[row["state"]] = row["n"]
        return out

    def in_flight(self) -> list[dict]:
        now = self._now()
        return [{"job": row["id"], "worker": row["worker"],
                 "heartbeat_age": now - row["heartbeat"],
                 "lease_remaining": row["lease_expires"] - now,
                 "stale": row["lease_expires"] < now,
                 "attempts": row["attempts"],
                 "sessions": list(json.loads(row["payload"])
                                  .get("sessions", []))}
                for row in self._conn().execute(
                    "SELECT id, worker, heartbeat, lease_expires, attempts,"
                    " payload FROM jobs WHERE state = ?", (LEASED,))]

    @_busy_retry
    def record_metrics(self, worker: str, samples, ts: float | None = None
                       ) -> None:
        ts = self._now() if ts is None else ts
        rows = [(ts, worker, s["name"], float(s["value"]),
                 s.get("kind", "counter")) for s in samples]
        if not rows:
            return
        with self._tx() as cur:
            cur.executemany(
                "INSERT INTO metrics (ts, worker, name, value, kind) "
                "VALUES (?,?,?,?,?)", rows)

    def read_metrics(self, worker: str | None = None,
                     name: str | None = None) -> list[dict]:
        sql = "SELECT ts, worker, name, value, kind FROM metrics"
        clauses, params = [], []
        if worker is not None:
            clauses.append("worker = ?")
            params.append(worker)
        if name is not None:
            clauses.append("name = ?")
            params.append(name)
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY id"
        return [dict(row) for row in self._conn().execute(sql, params)]


def default_worker_id() -> str:
    """``host:pid:suffix`` — unique per worker loop, readable in `status`."""
    host = os.uname().nodename if hasattr(os, "uname") else "host"
    return f"{host}:{os.getpid()}:{uuid.uuid4().hex[:6]}"
