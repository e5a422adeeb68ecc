"""Discrete, constrained search spaces — the shared vocabulary of the suite.

A ``SearchSpace`` is an ordered set of named discrete parameters plus a list of
constraints (predicates over full configs).  This mirrors BAT 2.0's problem
interface: every benchmark exposes its tunable parameters and restrictions in
one declarative object that every tuner consumes unmodified.

Configs are plain ``dict[str, value]``.  For numeric work (surrogates, PFI)
configs can be encoded to index vectors and back.
"""

from __future__ import annotations

import itertools
import random
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterator, Sequence

if TYPE_CHECKING:  # pragma: no cover
    import numpy as np

    from .spacetable import CompiledSpace

Config = dict[str, Any]


@dataclass(frozen=True)
class Param:
    """One tunable parameter: a name and its ordered list of discrete values."""

    name: str
    values: tuple

    def __post_init__(self) -> None:
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has no values")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"parameter {self.name!r} has duplicate values")
        # value -> index lookup; every encode/flat_index everywhere hits this
        try:
            index = {v: i for i, v in enumerate(self.values)}
        except TypeError:             # unhashable values: linear fallback
            index = None
        object.__setattr__(self, "_index", index)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def index_of(self, value) -> int:
        if self._index is None:
            return self.values.index(value)
        try:
            return self._index[value]
        except KeyError:
            raise ValueError(
                f"{value!r} is not a value of parameter {self.name!r}") \
                from None
        except TypeError:             # unhashable query: linear fallback
            return self.values.index(value)


@dataclass(frozen=True)
class Constraint:
    """A named predicate over full configs.  ``fn(config) -> bool``.

    ``vec`` is the optional vectorized form used by
    :class:`~repro_torch.core.spacetable.CompiledSpace`: it receives a dict of
    per-parameter *value* column arrays covering the whole cross product and
    returns a boolean array over rows.  It must be a total function (it is
    evaluated on every row, not only rows that passed earlier constraints)
    and must agree elementwise with ``fn``.
    """

    name: str
    fn: Callable[[Config], bool]
    vec: Callable[[dict], "np.ndarray"] | None = None

    def __call__(self, config: Config) -> bool:
        return bool(self.fn(config))


class SearchSpace:
    """An ordered, constrained, discrete configuration space.

    Provides: cardinality accounting (Table VIII), enumeration, uniform
    sampling via rejection, Hamming-1 neighborhoods (for local search and the
    fitness-flow graph), and index-vector encode/decode (for surrogates).
    """

    def __init__(self, params: Sequence[Param],
                 constraints: Sequence[Constraint] = (),
                 name: str = "space"):
        if len({p.name for p in params}) != len(params):
            raise ValueError("duplicate parameter names")
        self.name = name
        self.params: tuple[Param, ...] = tuple(params)
        self.constraints: tuple[Constraint, ...] = tuple(constraints)
        self._by_name = {p.name: p for p in self.params}
        self._compiled: "CompiledSpace | None" = None
        self._compile_lock = threading.Lock()

    # the compiled table and its lock are per-process derived state; drop
    # them when the space crosses a pickle boundary (process worker pools)
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_compiled"] = None
        state["_compile_lock"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._compile_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # compiled fast path
    # ------------------------------------------------------------------ #
    def compiled(self, limit: int | None = None,
                 build: bool = True) -> "CompiledSpace | None":
        """The :class:`~repro_torch.core.spacetable.CompiledSpace` for this space,
        built lazily and cached (``None`` when the cross product exceeds
        ``limit``, default ``spacetable.DEFAULT_COMPILE_LIMIT``).  Compiled
        paths are exact drop-ins: identical configs, orders and draws as the
        iterator paths."""
        if self._compiled is not None:
            return self._compiled
        if not build:
            return None
        from .spacetable import DEFAULT_COMPILE_LIMIT, CompiledSpace
        lim = DEFAULT_COMPILE_LIMIT if limit is None else limit
        if self.cardinality > lim:
            return None
        with self._compile_lock:
            if self._compiled is None:
                self._compiled = CompiledSpace.build(self)
        return self._compiled

    def compile_eagerly(self, py_limit: int = 1 << 16
                        ) -> "CompiledSpace | None":
        """The tuning-entry compile policy (tuner construction, session
        start): compile up to the full limit when every constraint has a
        vectorized form, but cap Python-fallback sweeps at ``py_limit`` rows
        so a tiny tuning budget never pays seconds of predicate sweeping
        up front."""
        all_vec = all(c.vec is not None for c in self.constraints)
        return self.compiled(limit=None if all_vec else py_limit)

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def param_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def param(self, name: str) -> Param:
        return self._by_name[name]

    @property
    def cardinality(self) -> int:
        """Unconstrained cross-product size (Table VIII 'Cardinality')."""
        out = 1
        for p in self.params:
            out *= p.cardinality
        return out

    def satisfies(self, config: Config) -> bool:
        if self._compiled is not None:
            try:
                return bool(self._compiled.mask[self.flat_index(config)])
            except (ValueError, TypeError):
                pass                  # value outside the space: run predicates
        return all(c(config) for c in self.constraints)

    def violated(self, config: Config) -> list[str]:
        return [c.name for c in self.constraints if not c(config)]

    # ------------------------------------------------------------------ #
    # encode / decode
    # ------------------------------------------------------------------ #
    def encode(self, config: Config) -> tuple[int, ...]:
        """Config -> per-parameter value indices (surrogate features)."""
        return tuple(p.index_of(config[p.name]) for p in self.params)

    def decode(self, indices: Sequence[int]) -> Config:
        return {p.name: p.values[i] for p, i in zip(self.params, indices)}

    def flat_index(self, config: Config) -> int:
        """Config -> mixed-radix integer (stable unique id)."""
        idx = 0
        for p in self.params:
            idx = idx * p.cardinality + p.index_of(config[p.name])
        return idx

    def from_flat_index(self, idx: int) -> Config:
        out: Config = {}
        for p in reversed(self.params):
            idx, r = divmod(idx, p.cardinality)
            out[p.name] = p.values[r]
        return {p.name: out[p.name] for p in self.params}

    # ------------------------------------------------------------------ #
    # batched encode / flat-index
    # ------------------------------------------------------------------ #
    def encode_many(self, configs: Sequence[Config]) -> "np.ndarray":
        """(B, P) per-parameter index matrix for a batch of configs."""
        import numpy as np
        out = np.empty((len(configs), len(self.params)), dtype=np.int64)
        for i, p in enumerate(self.params):
            idx = p._index
            name = p.name
            if idx is None:
                out[:, i] = [p.values.index(c[name]) for c in configs]
            else:
                out[:, i] = [idx[c[name]] for c in configs]
        return out

    def flat_index_many(self, configs: Sequence[Config]) -> "np.ndarray":
        """Mixed-radix flat indices for a batch (matches ``flat_index``)."""
        import numpy as np
        if self.cardinality > 2 ** 62:     # int64 would overflow
            return np.array([self.flat_index(c) for c in configs],
                            dtype=object)
        from .spacetable import mixed_radix_strides
        strides = mixed_radix_strides([p.cardinality for p in self.params])
        return self.encode_many(configs) @ strides

    # ------------------------------------------------------------------ #
    # enumeration & sampling
    # ------------------------------------------------------------------ #
    def enumerate(self, constrained: bool = True) -> Iterator[Config]:
        for combo in itertools.product(*(p.values for p in self.params)):
            cfg = dict(zip(self.param_names, combo))
            if not constrained or self.satisfies(cfg):
                yield cfg

    def valid_configs(self) -> list[Config]:
        """All constraint-satisfying configs in ``enumerate`` order —
        vectorized through the compiled table when the space fits the
        compile limit, bit-identical to ``list(self.enumerate())``."""
        comp = self.compiled()
        if comp is not None:
            return comp.valid_configs()
        return list(self.enumerate(constrained=True))

    def constrained_cardinality(self, limit: int | None = None) -> int:
        """Exact count of constraint-satisfying configs (Table VIII
        'Constrained').  ``limit`` caps the count (a count that reaches
        ``limit`` stops there and returns ``limit``)."""
        comp = self.compiled()
        if comp is not None:
            return comp.n_valid if limit is None else min(comp.n_valid, limit)
        n = 0
        for _ in self.enumerate(constrained=True):
            n += 1
            if limit is not None and n >= limit:
                return n
        return n

    def sample(self, rng: random.Random, max_tries: int = 10_000) -> Config:
        """Uniform sample from the *constrained* space via rejection.

        With a compiled table the constraint evaluation per try collapses to
        one mask lookup; the rng draw sequence (one ``choice`` per parameter
        per try) is unchanged, so compiled and legacy paths return the same
        configs for the same rng state.
        """
        comp = self._compiled
        if comp is not None:
            mask, strides = comp.mask, comp.strides
            for _ in range(max_tries):
                row = 0
                vals = []
                for i, p in enumerate(self.params):
                    v = rng.choice(p.values)
                    vals.append(v)
                    row += p.index_of(v) * int(strides[i])
                if mask[row]:
                    return dict(zip(self.param_names, vals))
        else:
            for _ in range(max_tries):
                cfg = {p.name: rng.choice(p.values) for p in self.params}
                if self.satisfies(cfg):
                    return cfg
        raise RuntimeError(
            f"{self.name}: could not sample a valid config in {max_tries} tries")

    def sample_batch(self, n: int, seed: int = 0) -> list[Config]:
        rng = random.Random(seed)
        return [self.sample(rng) for _ in range(n)]

    def sample_distinct(self, n: int, seed: int = 0,
                        max_tries_factor: int = 200) -> list[Config]:
        """Up to ``n`` distinct valid configs (the paper's 10 000-random-configs
        protocol)."""
        rng = random.Random(seed)
        seen: set[int] = set()
        out: list[Config] = []
        tries = 0
        while len(out) < n and tries < n * max_tries_factor:
            tries += 1
            cfg = self.sample(rng)
            key = self.flat_index(cfg)
            if key not in seen:
                seen.add(key)
                out.append(cfg)
        return out

    # ------------------------------------------------------------------ #
    # neighborhoods (local search, FFG/centrality)
    # ------------------------------------------------------------------ #
    def neighbors(self, config: Config, constrained: bool = True,
                  adjacent_only: bool = False) -> Iterator[Config]:
        """Hamming-distance-1 neighbors: change one parameter to another value.

        ``adjacent_only`` restricts moves to the next/previous value in the
        parameter's ordered list (the FFG in Schoonhoven et al. uses full
        Hamming-1; local search may prefer adjacent moves for numeric params).
        """
        for p in self.params:
            cur = config[p.name]
            i = p.index_of(cur)
            if adjacent_only:
                candidates = [j for j in (i - 1, i + 1) if 0 <= j < p.cardinality]
            else:
                candidates = [j for j in range(p.cardinality) if j != i]
            for j in candidates:
                cfg = dict(config)
                cfg[p.name] = p.values[j]
                if not constrained or self.satisfies(cfg):
                    yield cfg

    def neighbors_list(self, config: Config, constrained: bool = True,
                       adjacent_only: bool = False) -> list[Config]:
        """``list(self.neighbors(...))``, served from the compiled CSR
        neighbor table when available (same configs, same order)."""
        if constrained and not adjacent_only and self._compiled is not None:
            comp = self._compiled
            try:
                row = self.flat_index(config)
            except (ValueError, TypeError):
                row = -1
            if row >= 0:
                rows = comp.neighbor_rows(row)
                if rows is not None:      # invalid current row: fall back
                    return comp.decode_many(rows)
        return list(self.neighbors(config, constrained, adjacent_only))

    def random_neighbor(self, config: Config, rng: random.Random,
                        max_tries: int = 1000) -> Config:
        for _ in range(max_tries):
            p = rng.choice(self.params)
            v = rng.choice(p.values)
            if v == config[p.name]:
                continue
            cfg = dict(config)
            cfg[p.name] = v
            if self.satisfies(cfg):
                return cfg
        return dict(config)

    # ------------------------------------------------------------------ #
    # reductions (Table VIII 'Reduced')
    # ------------------------------------------------------------------ #
    def reduce(self, keep: Sequence[str], frozen: Config | None = None,
               name: str | None = None) -> "SearchSpace":
        """Project onto ``keep`` params; others frozen to ``frozen`` (default:
        first value).  Constraints are re-wrapped over the frozen context."""
        frozen = dict(frozen or {})
        for p in self.params:
            if p.name not in keep:
                frozen.setdefault(p.name, p.values[0])
        kept = [p for p in self.params if p.name in keep]

        def wrap(c: Constraint) -> Constraint:
            def fn(cfg: Config, _c=c) -> bool:
                full = dict(frozen)
                full.update(cfg)
                return _c(full)

            vec = None
            if c.vec is not None:     # frozen params become constant columns
                def vec(cols: dict, _c=c):
                    import numpy as np
                    n = len(next(iter(cols.values())))
                    full = {k: np.full(n, v) for k, v in frozen.items()
                            if k not in cols}
                    full.update(cols)
                    return _c.vec(full)
            return Constraint(c.name, fn, vec)

        return SearchSpace(kept, [wrap(c) for c in self.constraints],
                           name=name or f"{self.name}-reduced")

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SearchSpace({self.name!r}, {len(self.params)} params, "
                f"|S|={self.cardinality}, {len(self.constraints)} constraints)")


def powers_of_two(lo: int, hi: int) -> tuple[int, ...]:
    """Inclusive powers of two between lo and hi."""
    out = []
    v = 1
    while v <= hi:
        if v >= lo:
            out.append(v)
        v *= 2
    return tuple(out)


def divisors(n: int) -> tuple[int, ...]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return tuple(out)


def multiples(step: int, lo: int, hi: int) -> tuple[int, ...]:
    return tuple(range(lo - lo % step + (step if lo % step else 0), hi + 1, step)) \
        if lo % step else tuple(range(lo, hi + 1, step))
