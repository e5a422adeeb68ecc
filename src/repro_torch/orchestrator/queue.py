"""Thread-safe job queue with retry accounting and poison detection.

The worker pool pulls :class:`Job` items, evaluates them, and reports
``complete``/``fail``.  A failed job is requeued until its retry cap is
exhausted, at which point it is *poisoned*: the config is marked invalid and
never evaluated again (MITuna's "errored job" state — one bad config must
not wedge a campaign).

This in-process queue is the *seam* for scale-out: the durable
multi-process backends in :mod:`~repro_torch.orchestrator.broker` implement the
same lifecycle (pending → leased → done, with bounded retries terminating
in a dead state) over shared storage, using the state vocabulary defined
here.  ``LEASED``/``FAILED`` are the distributed counterparts of
``RUNNING``/``POISONED``: a lease can expire (the worker is presumed dead
and the job requeued), and a job whose attempts cap is exhausted is
*failed* — the queue-level poison.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional

from ..core.space import Config

#: in-process job lifecycle
PENDING, RUNNING, DONE, POISONED = "pending", "running", "done", "poisoned"
#: broker additions: a durable claim with an expiry, and the terminal
#: state of a job whose attempts cap ran out (see broker.py)
LEASED, FAILED = "leased", "failed"


@dataclass
class Job:
    key: int                      # space.flat_index of the config
    config: Config
    attempts: int = 0
    state: str = PENDING
    error: str | None = None
    result: Any = None
    # True when the *latest* failure was the evaluation watchdog firing
    # (not a raise): a poison caused by timeouts carries a "timeout"
    # marker in its trial info so hangs are distinguishable from crashes
    timed_out: bool = False


class JobQueue:
    """FIFO of evaluation jobs with bounded retries.

    Not a distributed queue — a small, correct, in-process one that the
    worker pool and tests share.  All transitions hold the lock;
    ``take``/``drained`` are non-blocking snapshots (the pool polls
    ``take`` after each future completes, so nothing ever needs to wait).
    """

    def __init__(self, max_retries: int = 2):
        self.max_retries = max_retries
        self._lock = threading.Lock()
        self._pending: list[Job] = []
        self._jobs: dict[int, Job] = {}        # key -> job (dedup at submit)

    # -- producer --------------------------------------------------------- #
    def submit(self, key: int, config: Config) -> Job:
        with self._lock:
            if key in self._jobs:
                return self._jobs[key]
            job = Job(key, config)
            self._jobs[key] = job
            self._pending.append(job)
            return job

    # -- consumer --------------------------------------------------------- #
    def take(self) -> Optional[Job]:
        """Pop the next pending job (non-blocking; None when empty)."""
        with self._lock:
            if not self._pending:
                return None
            job = self._pending.pop(0)
            job.state = RUNNING
            return job

    def complete(self, job: Job, result: Any) -> None:
        with self._lock:
            job.state = DONE
            job.result = result

    def fail(self, job: Job, error: str) -> bool:
        """Record a failure.  Returns True if the job was requeued, False if
        it is now poisoned (retry cap exhausted)."""
        with self._lock:
            job.attempts += 1
            job.error = error
            if job.attempts <= self.max_retries:
                job.state = PENDING
                self._pending.append(job)
                return True
            job.state = POISONED
            return False

    def requeue(self, job: Job, error: str) -> None:
        """Put a failed job back without charging an attempt: its failure
        may not be its own (a worker process that died under several
        in-flight jobs fails them all)."""
        with self._lock:
            job.error = error
            job.state = PENDING
            self._pending.append(job)

    # -- introspection ---------------------------------------------------- #
    def job(self, key: int) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(key)

    def counts(self) -> dict[str, int]:
        with self._lock:
            out = {PENDING: 0, RUNNING: 0, DONE: 0, POISONED: 0}
            for j in self._jobs.values():
                out[j.state] += 1
            return out

    def drained(self) -> bool:
        with self._lock:
            return all(j.state in (DONE, POISONED) for j in self._jobs.values())
