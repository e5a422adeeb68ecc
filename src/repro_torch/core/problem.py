"""The shared problem interface: a search space plus an evaluator.

Port of ``repro.core.problem``.  :class:`Trial`, :func:`materialize_configs`,
:class:`TunableProblem` and :class:`FunctionProblem` behave as the JAX
package's do.  A problem has two evaluators, told apart by the arch id:
an id of the Hopper cost model (``core.costmodel.ARCH_NAMES``) is answered
by the analytical path (:meth:`TunableProblem.features` fed to the model,
columnar where the problem has :meth:`TunableProblem.feature_columns`),
and :class:`MeasuredProblem` times each config on the card with CUDA
events, the paper's own method, under the device's id.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Any, Callable, Sequence

from ..telemetry.trace import span
from .costmodel import (ARCH_NAMES, GPU_GENERATIONS, FeatureBatch,
                        KernelFeatures, estimate_seconds,
                        estimate_seconds_batch)
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
    """Base class: a search space + an objective.

    Subclasses implement :meth:`features` (the analytical path, through the
    Hopper cost model) or override :meth:`evaluate` (a measured or function
    problem).  :meth:`_analytical` says which path an arch id takes.
    """

    name: str = "problem"
    #: True when :meth:`features`/:meth:`feature_columns` ignore ``arch``
    #: (the architecture enters only at cost-model-estimate time) — lets
    #: multi-architecture sweeps build the feature columns once.
    arch_independent_features: bool = False

    def __init__(self, space: SearchSpace):
        self.space = space

    def analytical(self, arch: str | None) -> bool:
        """Whether ``arch``'s objectives come from the cost model: here,
        whenever the problem does not override :meth:`evaluate`."""
        return type(self).evaluate is TunableProblem.evaluate

    # -- analytical path ------------------------------------------------ #
    def features(self, config: Config, arch: str) -> KernelFeatures:
        raise NotImplementedError

    def evaluate(self, config: Config, arch: str = DEFAULT_ARCH) -> Trial:
        if not self.space.satisfies(config):
            return Trial(config, math.inf, arch, valid=False,
                         info={"violated": self.space.violated(config)})
        feats = self.features(config, arch)
        t = estimate_seconds(feats, arch)
        return Trial(config, t, arch, valid=math.isfinite(t),
                     info={"features": feats})

    def feature_columns(self, cols: dict, arch: str) -> FeatureBatch | None:
        """Optional vectorized feature hook: per-parameter *value* column
        arrays in, :class:`FeatureBatch` out.  The column math must mirror
        :meth:`features` operation for operation so the batched cost model
        produces bit-identical objectives.  Return ``None`` to fall back to
        the per-config path."""
        return None

    def features_many(self, configs: Sequence[Config],
                      arch: str) -> FeatureBatch:
        """Struct-of-arrays features for a batch of *valid* configs,
        through :meth:`feature_columns` where the problem provides it
        (``FeatureBatch.features`` then stays empty), else packed from
        per-config :meth:`features`."""
        if configs and \
                type(self).feature_columns is not TunableProblem.feature_columns:
            import numpy as np
            cols = {p.name: np.asarray([c[p.name] for c in configs])
                    for p in self.space.params}
            fb = self.feature_columns(cols, arch)
            if fb is not None:
                return fb
        return FeatureBatch.from_features(
            [self.features(c, arch) for c in configs])

    def _columnar_ok(self, arch: str | None) -> bool:
        """Whether ``arch``'s row endpoints take the columnar path: a
        compiled space, the analytical path and a :meth:`feature_columns`.
        A kernel's ``features`` runs the same numpy math once per config,
        so the columnar path serves every batch size."""
        return (self.space.compiled() is not None
                and self.analytical(arch)
                and type(self).feature_columns
                is not TunableProblem.feature_columns)

    def objectives_for_rows(self, rows: Sequence[int],
                            arch: str = DEFAULT_ARCH):
        """Objective seconds for *valid* compiled-space rows, as a float64
        array (``inf`` == invalid on this arch).  Falls back through
        :meth:`trials_for_rows` when there is no columnar path."""
        import numpy as np
        rows = list(rows)
        if not rows:
            return np.empty(0, dtype=np.float64)
        if self._columnar_ok(arch):
            comp = self.space.compiled()
            fb = self.feature_columns(comp.value_columns(rows), arch)
            if fb is not None:
                return np.ascontiguousarray(np.broadcast_to(
                    np.asarray(estimate_seconds_batch(fb, arch),
                               dtype=np.float64), (len(rows),)))
        return np.array([t.objective if t.ok else math.inf
                         for t in self.trials_for_rows(rows, arch)],
                        dtype=np.float64)

    def _model_archs(self, archs: Sequence[str]) -> None:
        """Refuse an arch the cost model does not answer: a measurement
        belongs to one device and is not shared across arches."""
        for a in archs:
            if a not in GPU_GENERATIONS or not self.analytical(a):
                raise ValueError(
                    f"{self.name}: the multi-arch endpoints take the cost "
                    f"model's ids {ARCH_NAMES}, not {a!r}")

    def objectives_for_rows_archs(self, rows: Sequence[int],
                                  archs: Sequence[str]):
        """(len(archs), len(rows)) objective matrix of the cost model's
        ids: the mixed-radix decode and the per-parameter value columns
        are built once and shared across architectures; only the feature/
        cost-model sweep runs per arch."""
        import numpy as np
        self._model_archs(archs)
        rows = list(rows)
        out = np.empty((len(archs), len(rows)), dtype=np.float64)
        if not rows:
            return out
        if self._columnar_ok(archs[0]):
            comp = self.space.compiled()
            with span("eval.features", cat="eval", n=len(rows),
                      archs=len(archs)):
                cols = comp.value_columns(rows)
                if self.arch_independent_features:
                    fbs = [self.feature_columns(cols, archs[0])] * len(archs)
                else:
                    fbs = [self.feature_columns(cols, a) for a in archs]
            if all(fb is not None for fb in fbs):
                with span("eval.estimate", cat="eval", n=len(rows),
                          archs=len(archs)):
                    for i, (fb, arch) in enumerate(zip(fbs, archs)):
                        out[i] = np.broadcast_to(
                            np.asarray(estimate_seconds_batch(fb, arch)),
                            (len(rows),))
                return out
        for i, arch in enumerate(archs):
            out[i] = self.objectives_for_rows(rows, arch)
        return out

    def trials_for_rows_archs(self, rows: Sequence[int],
                              archs: Sequence[str]) -> list[list[Trial]]:
        """Per-arch lazy trials for *valid* compiled-space rows, one list per
        arch (aligned with ``archs``), from one
        :meth:`objectives_for_rows_archs` sweep."""
        rows = [int(r) for r in rows]
        objs = self.objectives_for_rows_archs(rows, archs)
        sp = self.space
        return [[Trial(None, float(o), a, valid=math.isfinite(float(o)),
                       row=r, space=sp)
                 for r, o in zip(rows, objs[i])]
                for i, a in enumerate(archs)]

    def trials_for_rows(self, rows: Sequence[int],
                        arch: str = DEFAULT_ARCH) -> list[Trial]:
        """Evaluate *valid* compiled-space rows.  On the analytical path
        the value columns come straight from the code matrix and the
        seconds from the batched cost model, as lazy trials; constraint
        checking is skipped (callers pass mask-validated rows).  Otherwise
        the rows are decoded in one batch and go to :meth:`evaluate_many`.
        """
        rows = list(rows)
        if not rows:
            return []
        comp = self.space.compiled()
        fb = None
        if self._columnar_ok(arch):
            with span("eval.features", cat="eval", n=len(rows), arch=arch):
                fb = self.feature_columns(comp.value_columns(rows), arch)
        if fb is None:
            if comp is not None:
                cfgs = comp.decode_many(rows)
            else:
                cfgs = [self.space.from_flat_index(int(r)) for r in rows]
            return self.evaluate_many(cfgs, arch)
        import numpy as np
        with span("eval.estimate", cat="eval", n=len(rows), arch=arch):
            times = np.broadcast_to(
                np.asarray(estimate_seconds_batch(fb, arch),
                           dtype=np.float64), (len(rows),))
        sp = self.space
        return [Trial(None, float(t), arch, valid=math.isfinite(float(t)),
                      row=r, space=sp) for r, t in zip(rows, times)]

    # -- convenience ------------------------------------------------------ #
    def evaluate_many(self, configs: Sequence[Config],
                      arch: str = DEFAULT_ARCH) -> list[Trial]:
        """Evaluate a batch of configs: on the analytical path one numpy
        sweep (:meth:`features_many` + :func:`estimate_seconds_batch`),
        otherwise :meth:`evaluate` one config at a time (a measured
        objective cannot be vectorized)."""
        configs = list(configs)
        if not self.analytical(arch):
            return [self.evaluate(c, arch) for c in configs]
        trials: list[Trial | None] = []
        slots: list[int] = []
        for cfg in configs:
            if not self.space.satisfies(cfg):
                trials.append(Trial(cfg, math.inf, arch, valid=False,
                                    info={"violated": self.space.violated(cfg)}))
            else:
                slots.append(len(trials))
                trials.append(None)
        if slots:
            import numpy as np
            batch = self.features_many([configs[j] for j in slots], arch)
            times = np.broadcast_to(
                np.asarray(estimate_seconds_batch(batch, arch),
                           dtype=np.float64), (len(slots),))
            per_row = batch.features or None
            for i, j in enumerate(slots):
                t = float(times[i])
                info = {"features": per_row[i]} if per_row else {}
                trials[j] = Trial(configs[j], t, arch,
                                  valid=math.isfinite(t), info=info)
        return trials  # type: ignore[return-value]

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

    def archs(self) -> tuple[str, ...]:
        """The cost model's arch ids, which every analytical problem
        answers."""
        return ARCH_NAMES


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

    Trials are recorded under the device's arch id (:attr:`arch`).  An id
    of the cost model (``core.costmodel.ARCH_NAMES``) is answered by the
    analytical path (:meth:`TunableProblem.evaluate`); any other id is an
    error, since a measurement belongs to the device it was taken on.
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
        from ..device import arch_id, resolve   # torch: only when measuring
        self.device = resolve(device)
        self.arch = arch_id(self.device)
        self._flush = None

    def __getstate__(self) -> dict:
        # the L2 flush buffer lives on this process's device: a process
        # the problem is pickled into makes its own
        state = self.__dict__.copy()
        state["_flush"] = None
        return state

    def _seconds(self, fn: Callable[[], Any]) -> list[float]:
        if self.device.type != "cuda":
            return host_seconds(fn, self.repeats, self.warmup)
        if self._flush is None:
            import torch
            self._flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                      device=self.device)
        return cuda_event_seconds(fn, self.repeats, self.warmup, self._flush)

    def analytical(self, arch: str | None) -> bool:
        """A cost-model id takes the analytical path; ``None`` or the
        device's own id is measured; any other id raises."""
        if arch in GPU_GENERATIONS:
            return True
        if arch is not None and arch != self.arch:
            raise ValueError(f"{self.name} measures on {self.device} "
                             f"(arch {self.arch!r}), not {arch!r}; the cost "
                             f"model answers {ARCH_NAMES}")
        return False

    def evaluate(self, config: Config, arch: str | None = None) -> Trial:
        if self.analytical(arch):
            return super().evaluate(config, arch)
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
