"""Span tracing: nestable, ring-buffered, exportable.

A *span* is a named, timed region of code::

    from repro_torch.telemetry.trace import span

    with span("tuner.ask", cat="tuner", n=64):
        keys = tuner.ask_rows(64)

Spans nest: each thread keeps a depth counter (thread-local), so a
``pool.chunk`` span opened inside ``pool.evaluate`` records ``depth=1``.
Finished spans land in a process-global ring buffer
(:class:`collections.deque` with ``maxlen`` — appends are GIL-atomic, so
worker threads record without locking) and can be exported as JSONL
(one object per line, see docs/architecture.md "Telemetry contracts")
or as Chrome ``chrome://tracing`` complete events.

Cost model — the reason this can stay threaded through hot seams:

* disabled (default): ``span(...)`` is one global load, one attribute
  check and the return of a shared no-op object — low hundreds of
  nanoseconds, measured by ``benchmarks/telemetry_bench.py``;
* enabled: two ``perf_counter_ns`` calls plus one deque append per
  span.  Instrumentation sits at *batch* granularity (an ask/tell, a
  pool chunk, a journal write), never inside per-config loops, so the
  enabled path stays within the benchmarked overhead bound.

Tracing never draws randomness and never reorders work, so enabling it
cannot perturb tuner trajectories (the rng-stream contract in
docs/architecture.md) — ``tests/test_telemetry.py`` asserts journals
are byte-identical with tracing on vs off.

Set ``REPRO_TRACE=1`` in the environment to enable tracing at import
time (handy for subprocess workers).
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Iterable

__all__ = [
    "span", "traced", "tracing", "enable", "disable", "is_enabled",
    "clear", "events", "export_jsonl", "export_chrome", "summarize",
    "drain", "ingest", "DEFAULT_BUFFER",
]

#: default ring-buffer capacity (finished spans kept in memory)
DEFAULT_BUFFER = 65536


class _NullSpan:
    """Shared no-op span: what :func:`span` returns while disabled."""

    __slots__ = ()
    enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """A live (enabled) span.  Use via :func:`span`, not directly."""

    __slots__ = ("name", "cat", "args", "t0", "depth")
    enabled = True

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (e.g. a result count)."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        local = _TRACER.local
        self.depth = getattr(local, "depth", 0)
        local.depth = self.depth + 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tracer = _TRACER
        tracer.local.depth = self.depth
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        # deque.append is atomic under the GIL: no lock on the hot path
        tracer.events.append(
            (self.name, self.cat, self.t0, t1 - self.t0,
             threading.get_ident(), self.depth, self.args))
        return False


class _Tracer:
    """Process-global trace state (ring buffer + enable flag)."""

    def __init__(self):
        self.enabled = False
        self.events: deque = deque(maxlen=DEFAULT_BUFFER)
        self.local = threading.local()
        self.origin_ns = time.perf_counter_ns()
        self.origin_wall = time.time()

    def enable(self, buffer: int | None = None) -> None:
        if buffer is not None and buffer != self.events.maxlen:
            self.events = deque(self.events, maxlen=buffer)
        if not self.enabled:
            self.origin_ns = time.perf_counter_ns()
            self.origin_wall = time.time()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.events.clear()


_TRACER = _Tracer()


def span(name: str, cat: str = "app", **args):
    """Open a span — the single instrumentation entry point.

    Returns a context manager.  When tracing is disabled this is one
    flag check and a shared no-op object; keep it out of per-config
    inner loops all the same (instrument batches, not elements).
    """
    if not _TRACER.enabled:
        return _NULL_SPAN
    return Span(name, cat, args)


def traced(name: str | None = None, cat: str = "app") -> Callable:
    """Decorator form: time every call of the wrapped function."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with Span(label, cat, {}):
                return fn(*a, **kw)
        return wrapper
    return deco


class tracing:
    """``with tracing():`` — enable for a scope, restore prior state after.

    Used by tests and the overhead benchmark; long-running processes
    call :func:`enable` / :func:`disable` directly.
    """

    def __init__(self, buffer: int | None = None, fresh: bool = True):
        self.buffer = buffer
        self.fresh = fresh

    def __enter__(self):
        self.was_enabled = _TRACER.enabled
        if self.fresh:
            _TRACER.clear()
        _TRACER.enable(buffer=self.buffer)
        return _TRACER

    def __exit__(self, *exc):
        _TRACER.enabled = self.was_enabled
        return False


def enable(buffer: int | None = None) -> None:
    _TRACER.enable(buffer=buffer)


def disable() -> None:
    _TRACER.disable()


def is_enabled() -> bool:
    return _TRACER.enabled


def clear() -> None:
    _TRACER.clear()


def drain() -> list[tuple]:
    """Take every finished span out of the ring buffer, as raw records
    (what a spawned worker process hands back to its parent)."""
    out = []
    events = _TRACER.events
    while events:
        out.append(events.popleft())
    return out


def ingest(records: Iterable[tuple], **args) -> None:
    """Append raw records from another process to the ring buffer, each
    with ``args`` added (e.g. the ``pid`` it ran in).  The timestamps are
    ``perf_counter_ns`` readings, one clock for every process of a host."""
    events = _TRACER.events
    for name, cat, t0, dur, tid, depth, a in records:
        events.append((name, cat, t0, dur, tid, depth, {**a, **args}))


# --------------------------------------------------------------------- #
# export
# --------------------------------------------------------------------- #
def events() -> list[dict]:
    """Finished spans, oldest first, as dicts.

    ``ts`` is microseconds since the tracer was (last) enabled; ``dur``
    is microseconds; ``wall`` maps ``ts == 0`` to ``time.time()``.
    """
    origin = _TRACER.origin_ns
    out = []
    for name, cat, t0, dur, tid, depth, args in list(_TRACER.events):
        rec = {"name": name, "cat": cat,
               "ts": (t0 - origin) / 1e3, "dur": dur / 1e3,
               "tid": tid, "depth": depth}
        if args:
            rec["args"] = args
        out.append(rec)
    return out


def export_jsonl(path: str | Path) -> Path:
    """Write the ring buffer as JSONL (grammar in docs/architecture.md)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {"trace": "repro.telemetry", "version": 1,
              "origin_wall": _TRACER.origin_wall, "unit": "us"}
    with open(path, "w") as f:
        f.write(json.dumps(header, separators=(",", ":")) + "\n")
        for rec in events():
            f.write(json.dumps(rec, separators=(",", ":"),
                               default=str) + "\n")
    return path


def export_chrome(path: str | Path) -> Path:
    """Write the ring buffer as Chrome ``chrome://tracing`` JSON.

    Load via chrome://tracing or https://ui.perfetto.dev — spans become
    complete (``"ph": "X"``) events on one process track, one row per
    thread.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    trace_events = [
        {"name": rec["name"], "cat": rec["cat"], "ph": "X",
         "ts": rec["ts"], "dur": rec["dur"],
         "pid": pid, "tid": rec["tid"],
         "args": rec.get("args", {})}
        for rec in events()
    ]
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms",
           "otherData": {"trace": "repro.telemetry",
                         "origin_wall": _TRACER.origin_wall}}
    path.write_text(json.dumps(doc, default=str))
    return path


def summarize(top: int | None = None,
              evts: Iterable[dict] | None = None) -> list[dict]:
    """Aggregate spans by name: count, total/max/mean duration (ms).

    Sorted by total duration descending; ``top`` truncates.  Feed it
    :func:`events` output (default) or parsed JSONL records.
    """
    agg: dict[str, dict] = {}
    for rec in (events() if evts is None else evts):
        if "name" not in rec or "dur" not in rec:
            continue                   # JSONL header line
        a = agg.setdefault(rec["name"],
                           {"name": rec["name"], "cat": rec.get("cat", ""),
                            "count": 0, "total_ms": 0.0, "max_ms": 0.0})
        ms = rec["dur"] / 1e3
        a["count"] += 1
        a["total_ms"] += ms
        a["max_ms"] = max(a["max_ms"], ms)
    rows = sorted(agg.values(), key=lambda a: -a["total_ms"])
    for a in rows:
        a["mean_ms"] = a["total_ms"] / a["count"]
    return rows[:top] if top else rows


if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    enable()
