"""Zero-dependency observability for the tuning stack.

Two primitives, both off by default and nanosecond-cheap when off:

* :mod:`repro_torch.telemetry.trace` — nestable spans (context manager or
  decorator) recorded into a bounded in-memory ring buffer, exportable
  as JSONL or Chrome ``chrome://tracing`` JSON.
* :mod:`repro_torch.telemetry.metrics` — counters / gauges / histograms for
  in-process runs, plus fleet aggregation over a broker's ``metrics``
  table (per-worker throughput, leases, heartbeat health, queue depth).

The orchestrator, worker pool, broker, tuner loop and the kernels'
build/measure split are instrumented at batch granularity; enabling
telemetry never touches tuner RNG streams, so trajectories and journals
stay bit-identical with tracing on (asserted by ``tests/test_telemetry.py`` and
``benchmarks/telemetry_bench.py``).
"""

from __future__ import annotations

from . import metrics, trace
from .metrics import counter, fleet_snapshot, gauge, histogram, registry
from .trace import span, traced, tracing

__all__ = [
    "trace", "metrics",
    "span", "traced", "tracing",
    "counter", "gauge", "histogram", "registry", "fleet_snapshot",
    "enable", "disable", "is_enabled",
]


def enable(buffer: int | None = None) -> None:
    """Turn on both span tracing and metrics collection."""
    trace.enable(buffer=buffer)
    metrics.enable()


def disable() -> None:
    """Turn off both layers (recorded events/values are kept until
    :func:`repro_torch.telemetry.trace.clear` / ``metrics.reset()``)."""
    trace.disable()
    metrics.disable()


def is_enabled() -> bool:
    return trace.is_enabled() or metrics.is_enabled()
