"""Fleet metrics: in-process counters/gauges/histograms + broker aggregation.

Two halves share one naming scheme (docs/architecture.md, "Telemetry
contracts"):

* **in-process**: a registry of labelled instruments updated by the
  runner / pool / campaign while they execute.  Off by default — every
  instrument lookup first checks the enable flag and returns a shared
  no-op instrument, so the disabled path is a function call and a flag
  test.  Instrument handles are cached by callers outside their loops,
  making the per-batch cost a single no-op method call.
* **fleet**: detached :class:`~repro_torch.orchestrator.workers.BrokerWorker`
  processes record per-job samples into their broker's ``metrics``
  table (SQLite) or sample log + JSONL sink (MemoryBroker);
  :func:`fleet_snapshot` joins those samples with the broker's live
  ``counts()`` / ``in_flight()`` views into one JSON-friendly dict —
  what ``repro_torch.orchestrator metrics`` dumps or tails.

Sample kinds: ``counter`` samples are summed per (worker, name);
``gauge`` samples are last-write-wins per (worker, name).  Samples are
never deleted by ``collect()`` or lease reaping, so a SIGKILLed
worker's counters survive its jobs being requeued to another worker.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from ..orchestrator.broker import Broker

__all__ = [
    "counter", "gauge", "histogram", "registry", "enable", "disable",
    "is_enabled", "reset", "snapshot", "fleet_snapshot",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
]


class _NullInstrument:
    """Shared no-op returned by the registry while metrics are off."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NULL = _NullInstrument()


class Counter:
    """Monotonic float counter (``inc``)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n                # float += is fine under the GIL

    def data(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins value (``set``)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = None

    def set(self, value: float) -> None:
        self.value = value

    def data(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming count/sum/min/max (``observe``) — no buckets, no deps."""

    __slots__ = ("count", "total", "min", "max", "_lock")
    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def data(self) -> dict:
        mean = self.total / self.count if self.count else None
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max, "mean": mean}


class MetricsRegistry:
    """Named, labelled instruments behind one enable flag."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        if not self.enabled:
            return _NULL
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> list[dict]:
        """All instruments as JSON-friendly dicts, sorted by (name, labels)."""
        with self._lock:
            items = sorted(self._instruments.items())
        return [{"name": name, "labels": dict(labels),
                 "kind": inst.kind, **inst.data()}
                for (name, labels), inst in items]

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, **labels):
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels):
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels):
    return _REGISTRY.histogram(name, **labels)


def enable() -> None:
    _REGISTRY.enabled = True


def disable() -> None:
    _REGISTRY.enabled = False


def is_enabled() -> bool:
    return _REGISTRY.enabled


def reset() -> None:
    _REGISTRY.reset()


def snapshot() -> list[dict]:
    return _REGISTRY.snapshot()


# --------------------------------------------------------------------- #
# fleet aggregation (broker-backed)
# --------------------------------------------------------------------- #
def aggregate_samples(samples: list[dict]) -> dict[str, dict[str, float]]:
    """Per-worker aggregates from raw broker samples.

    Counters are summed; gauges take the latest sample (samples arrive
    ordered by record time).  Returns ``{worker: {name: value}}``.
    """
    out: dict[str, dict[str, float]] = {}
    for s in samples:
        w = out.setdefault(s["worker"], {})
        if s.get("kind") == "gauge":
            w[s["name"]] = s["value"]
        else:
            w[s["name"]] = w.get(s["name"], 0.0) + s["value"]
    return out


def fleet_snapshot(broker: "Broker") -> dict:
    """One JSON-friendly view of a fleet: queue depth, lease/heartbeat
    health per worker, and worker-recorded throughput aggregates.

    This is a *read* — it never mutates broker state (no lease reaping),
    so it is safe to poll from a dashboard loop while workers run.
    """
    now = time.time()
    snap = {"ts": now, "queue": broker.counts(), "workers": {}}

    def _w(worker: str) -> dict:
        return snap["workers"].setdefault(worker, {
            "leases": 0, "heartbeat_age": None, "stale": False})

    for job in broker.in_flight():
        w = _w(job["worker"])
        w["leases"] += 1
        age = job.get("heartbeat_age")
        if age is not None and (w["heartbeat_age"] is None
                                or age < w["heartbeat_age"]):
            w["heartbeat_age"] = age
        w["stale"] = w["stale"] or bool(job.get("stale"))

    for worker, agg in aggregate_samples(broker.read_metrics()).items():
        w = _w(worker)
        w.update(agg)
        eval_s = agg.get("eval_s")
        if eval_s and "configs_per_s" not in agg:
            w["configs_per_s"] = agg.get("evals", 0.0) / eval_s
    return snap
