"""The shared problem interface: a search space plus an evaluator.

Port of ``repro.core.problem``.  :class:`Trial`, :func:`materialize_configs`,
:class:`TunableProblem` and :class:`FunctionProblem` behave as the JAX
package's do.  The JAX package's analytical path (features fed to the TPU
cost model) has no Hopper counterpart yet, so here every endpoint is
answered through :meth:`TunableProblem.evaluate`.  :class:`MeasuredProblem`
times each config on the card with CUDA events, which is the paper's own
method.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Any, Callable, Sequence

from ..device import arch_id, resolve
from ..telemetry.trace import span
from .space import Config, SearchSpace

#: the port's arch id when none is given (``repro_torch.device.arch_id``
#: names the card a run is on; ids contain no dots)
DEFAULT_ARCH = "h100"

#: bytes written between timed repeats to evict the card's 50 MB L2
L2_FLUSH_BYTES = 256 << 20


class Trial:
    """One evaluated configuration.

    ``config`` may be materialized lazily: row-native producers pass
    ``row=``/``space=`` instead of a config dict, and the mixed-radix decode
    runs on first :attr:`config` access (:func:`materialize_configs`
    batch-decodes a trace).

    Invariant: when both are given, ``row`` MUST be the flat index of
    ``config`` (``row == space.flat_index(config)``).  Row-aware consumers
    (``ResultTable.from_trials``) trust the row without re-encoding the
    dict, so a mismatched pair would publish the row's config.
    """

    __slots__ = ("objective", "arch", "valid", "info",
                 "_config", "_row", "_space")

    def __init__(self, config: Config | None, objective: float,
                 arch: str = DEFAULT_ARCH, valid: bool = True,
                 info: dict | None = None, *,
                 row: int | None = None, space: SearchSpace | None = None):
        if config is None and (row is None or space is None):
            raise ValueError("lazy Trial needs both row= and space=")
        self._config = config
        self._row = None if row is None else int(row)
        self._space = space
        self.objective = objective    # seconds; +inf => invalid on this arch
        self.arch = arch
        self.valid = valid
        self.info: dict = {} if info is None else info

    @property
    def config(self) -> Config:
        if self._config is None:
            self._config = self._space.from_flat_index(self._row)
        return self._config

    @property
    def row(self) -> int | None:
        """The compiled-space flat index, when this trial was produced
        row-natively — ``None`` for config-born trials."""
        return self._row

    @property
    def ok(self) -> bool:
        return self.valid and math.isfinite(self.objective)

    def __repr__(self) -> str:  # pragma: no cover
        cfg = self._config if self._config is not None else f"<row {self._row}>"
        return (f"Trial(config={cfg!r}, objective={self.objective!r}, "
                f"arch={self.arch!r}, valid={self.valid!r}, info={self.info!r})")


def materialize_configs(trials: Sequence[Trial]) -> None:
    """Decode every lazy trial's config in one batched pass per space."""
    pending: dict[int, tuple[SearchSpace, list[Trial]]] = {}
    for t in trials:
        if t._config is None:
            sp = t._space
            pending.setdefault(id(sp), (sp, []))[1].append(t)
    for sp, lazy in pending.values():
        comp = sp.compiled()
        if comp is None:
            for t in lazy:
                t._config = sp.from_flat_index(t._row)
        else:
            for t, cfg in zip(lazy, comp.decode_many([t._row for t in lazy])):
                t._config = cfg


class TunableProblem:
    """Base class: a search space + an objective (:meth:`evaluate`).

    Every batched endpoint answers through :meth:`evaluate`, one config at a
    time: a measured objective cannot be vectorized, and the analytical
    Hopper model that could be has not been written yet.
    """

    name: str = "problem"

    def __init__(self, space: SearchSpace):
        self.space = space

    def evaluate(self, config: Config, arch: str = DEFAULT_ARCH) -> Trial:
        raise NotImplementedError

    def objectives_for_rows(self, rows: Sequence[int],
                            arch: str = DEFAULT_ARCH):
        """Objective seconds for *valid* compiled-space rows, as a float64
        array (``inf`` == invalid on this arch)."""
        import numpy as np
        return np.array([t.objective if t.ok else math.inf
                         for t in self.trials_for_rows(rows, arch)],
                        dtype=np.float64)

    def trials_for_rows(self, rows: Sequence[int],
                        arch: str = DEFAULT_ARCH) -> list[Trial]:
        """Evaluate *valid* compiled-space rows (decoded in one batch)."""
        rows = list(rows)
        if not rows:
            return []
        comp = self.space.compiled()
        if comp is not None:
            cfgs = comp.decode_many(rows)
        else:
            cfgs = [self.space.from_flat_index(int(r)) for r in rows]
        return self.evaluate_many(cfgs, arch)

    def evaluate_many(self, configs: Sequence[Config],
                      arch: str = DEFAULT_ARCH) -> list[Trial]:
        return [self.evaluate(c, arch) for c in configs]

    def exhaustive(self, arch: str = DEFAULT_ARCH,
                   limit: int | None = None) -> list[Trial]:
        """Evaluate the whole constrained space (or its first ``limit``
        valid configs, in enumeration order)."""
        comp = self.space.compiled()
        if limit is None:
            cfgs = self.space.valid_configs()
        elif comp is not None:
            cfgs = comp.decode_many(comp.valid_rows[:limit])
        else:
            import itertools
            cfgs = list(itertools.islice(
                self.space.enumerate(constrained=True), limit))
        return self.evaluate_many(cfgs, arch)

    def sampled(self, n: int, seed: int = 0,
                arch: str = DEFAULT_ARCH) -> list[Trial]:
        """The paper's random-configs protocol."""
        return self.evaluate_many(self.space.sample_distinct(n, seed), arch)


class FunctionProblem(TunableProblem):
    """Wrap a plain ``fn(config, arch) -> float`` as a problem (tests/toys)."""

    def __init__(self, space: SearchSpace,
                 fn: Callable[[Config, str], float], name: str = "fn"):
        super().__init__(space)
        self.fn = fn
        self.name = name

    def evaluate(self, config: Config, arch: str = DEFAULT_ARCH) -> Trial:
        if not self.space.satisfies(config):
            return Trial(config, math.inf, arch, valid=False)
        v = float(self.fn(config, arch))
        return Trial(config, v, arch, valid=math.isfinite(v))


def cuda_event_seconds(fn: Callable[[], Any], repeats: int, warmup: int,
                       flush) -> list[float]:
    """Device seconds of each of ``repeats`` calls of ``fn``, after
    ``warmup`` calls.  Before each timed call ``flush`` (a device tensor of
    at least :data:`L2_FLUSH_BYTES`) is overwritten, outside the event
    window, so every call finds a cold L2."""
    import torch
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) / 1e3 for start, end in events]


def host_seconds(fn: Callable[[], Any], repeats: int,
                 warmup: int) -> list[float]:
    """Host-clock seconds of each of ``repeats`` calls (CPU tensors only)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


class MeasuredProblem(TunableProblem):
    """Each config's objective is its measured median time.

    ``build(config)`` returns a zero-argument callable that runs the config
    once.  ``device`` defaults to ``"cuda"`` and raises on a host with no
    card (:func:`repro_torch.device.resolve`); pass ``device="cpu"`` to time
    the plain versions, as the tests do.  On a CUDA device each repeat is
    timed with a pair of CUDA events around the call, after ``warmup``
    calls and with the L2 flushed before each repeat
    (:func:`cuda_event_seconds`); on the CPU the host clock times the call.
    The objective is the median; ``info`` keeps the median, min, max and
    repeat count.  A config that fails to build or to launch is an invalid
    trial carrying its error (the paper's "Valid" column).

    Trials are recorded under the device's arch id (:attr:`arch`); asking
    for another arch is an error, since a measurement belongs to the device
    it was taken on.
    """

    def __init__(self, space: SearchSpace,
                 build: Callable[[Config], Callable[[], Any]],
                 name: str = "measured", repeats: int = 5, warmup: int = 2,
                 device=None):
        super().__init__(space)
        self.build = build
        self.name = name
        self.repeats = repeats
        self.warmup = warmup
        self.device = resolve(device)
        self.arch = arch_id(self.device)
        self._flush = None

    def _seconds(self, fn: Callable[[], Any]) -> list[float]:
        if self.device.type != "cuda":
            return host_seconds(fn, self.repeats, self.warmup)
        if self._flush is None:
            import torch
            self._flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                      device=self.device)
        return cuda_event_seconds(fn, self.repeats, self.warmup, self._flush)

    def evaluate(self, config: Config, arch: str | None = None) -> Trial:
        if arch is not None and arch != self.arch:
            raise ValueError(f"{self.name} measures on {self.device} "
                             f"(arch {self.arch!r}), not {arch!r}")
        arch = self.arch
        if not self.space.satisfies(config):
            return Trial(config, math.inf, arch, valid=False,
                         info={"violated": self.space.violated(config)})
        # the compile-vs-measure split: one span per phase.  Span overhead
        # sits outside the event windows, so tracing cannot bias the
        # recorded objective.
        try:
            with span("kernel.build", cat="kernel", arch=arch):
                fn = self.build(config)
            with span("kernel.measure", cat="kernel", arch=arch,
                      repeats=self.repeats):
                times = self._seconds(fn)
        except Exception as e:  # fails to build or launch == invalid
            return Trial(config, math.inf, arch, valid=False,
                         info={"error": repr(e)})
        med = statistics.median(times)
        return Trial(config, med, arch, valid=True,
                     info={"median_s": med, "min_s": min(times),
                           "max_s": max(times), "repeats": len(times)})
