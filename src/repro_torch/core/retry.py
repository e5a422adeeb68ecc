"""Bounded exponential backoff with deterministic jitter — one retry policy.

Transient-contention retries used to be ad hoc: the SQLite broker had its
own inline backoff loop, and every new durable artifact (the servedb
snapshot publish lock, next quarter's network broker) would have grown
another.  One policy object keeps the chaos plane honest too — the
"SQLite busy storm" site and the servedb publish-contention path now
exercise *the same* retry code, so a bug in the backoff arithmetic cannot
hide behind one caller's private copy.

Jitter is deterministic: the k-th delay is a pure function of
``(salt, attempt)`` via the same blake2b construction the chaos plane
uses for its fault draws.  Replaying a seeded chaos schedule therefore
replays the exact retry timing as well — no wall-clock randomness sneaks
into a deterministic fault drill — while distinct salts (one per call
site) still decorrelate concurrent retriers the way classic randomized
jitter would.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Iterator

__all__ = ["backoff_delays", "retry_call", "RetryBudgetExceeded"]


class RetryBudgetExceeded(Exception):
    """Raised by :func:`retry_call` when every attempt failed and the
    caller asked for a summary error instead of the last exception."""

    def __init__(self, what: str, attempts: int, last: BaseException):
        super().__init__(
            f"{what}: still failing after {attempts} attempt(s): {last}")
        self.attempts = attempts
        self.last = last


def _jitter_frac(salt: str, attempt: int) -> float:
    """Deterministic uniform draw in [0, 1) — blake2b of (salt, attempt),
    the chaos plane's construction, so seeded replays reproduce delays."""
    h = hashlib.blake2b(f"retry|{salt}|{attempt}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def backoff_delays(retries: int, *, base_s: float = 0.01,
                   max_s: float = 0.2, jitter: float = 0.5,
                   salt: str = "") -> Iterator[float]:
    """The delay schedule: ``retries`` values, exponentially grown from
    ``base_s`` and capped at ``max_s``, each scaled by a deterministic
    jitter factor in ``[1 - jitter, 1]``.

    ``jitter=0`` reproduces a plain capped-doubling schedule (what the
    broker shipped before this helper existed); ``salt`` decorrelates
    concurrent retriers without introducing wall-clock randomness.
    """
    if not 0.0 <= jitter <= 1.0:
        raise ValueError(f"jitter={jitter} not in [0, 1]")
    delay = base_s
    for attempt in range(retries):
        frac = 1.0 - jitter * _jitter_frac(salt, attempt)
        yield min(delay, max_s) * frac
        delay = min(delay * 2, max_s)


def retry_call(fn: Callable, *, retries: int,
               retry_on: Callable[[BaseException], bool],
               base_s: float = 0.01, max_s: float = 0.2,
               jitter: float = 0.5, salt: str = "",
               what: str | None = None,
               sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` up to ``retries + 1`` times.

    An exception for which ``retry_on`` returns False propagates
    immediately (it is not transient); a transient one sleeps the next
    :func:`backoff_delays` value and retries.  When the budget is
    exhausted the last exception propagates as-is — unless ``what`` is
    given, in which case it is wrapped in :class:`RetryBudgetExceeded`
    so the caller's log names the operation that gave up.
    """
    delays = backoff_delays(retries, base_s=base_s, max_s=max_s,
                            jitter=jitter, salt=salt)
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as e:
            attempt += 1
            if not retry_on(e) or attempt > retries:
                if what is not None and retry_on(e):
                    raise RetryBudgetExceeded(what, attempt, e) from e
                raise
            sleep(next(delays))
