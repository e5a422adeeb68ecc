"""Compiled search-space engine: the array-native view of a ``SearchSpace``.

The iterator API on :class:`~repro_torch.core.space.SearchSpace` (``enumerate`` /
``neighbors`` / rejection ``sample``) is per-config Python work — fine for a
few hundred evaluations, prohibitive for the exhaustive analyses (fitness-
flow-graph centrality, Table VIII cardinality accounting) that need the whole
constrained landscape materialized per architecture.  A :class:`CompiledSpace`
pays that cost once, vectorized:

* **mixed-radix enumeration** — the full cross product as per-column index
  arithmetic on ``arange(cardinality)``; row ``r`` of the (virtual) code
  matrix *is* flat index ``r`` (``SearchSpace.flat_index`` order, last
  parameter fastest), so flat indices double as row ids,
* **vectorized constraints** — a :class:`~repro_torch.core.space.Constraint` may
  carry a declarative ``vec(cols) -> bool[N]`` evaluated over column arrays;
  constraints without one fall back to the Python predicate, evaluated in
  declaration order only on rows still alive (preserving ``satisfies``'s
  short-circuit semantics exactly),
* a cached **valid-row mask** + valid-row index (exact constrained counts,
  O(1) membership),
* **rejection-free uniform sampling** from the valid set,
* batched ``encode_many`` / ``decode_many`` / ``flat_index_many``,
* **Hamming-1 neighbor tables in CSR form** over the valid set, in the same
  per-node order as ``SearchSpace.neighbors`` (parameter order, then value
  order) so consumers can swap paths bit-for-bit,
* **row-native draws** for the index-native tuners:
  :meth:`sample_row_rejection` and :meth:`random_neighbor_row` replicate the
  legacy ``SearchSpace.sample`` / ``random_neighbor`` rng draw sequences
  exactly (pure-int row arithmetic + one mask lookup per try, no dicts), and
  :meth:`sample_neighbor_alias` draws a Hamming-1 move in O(1) from per-row
  alias tables over the CSR neighbor lists (same conditional distribution as
  the rejection sampler, different — shorter — draw sequence),
* an **on-disk cache** (``.npz``) of the mask and neighbor tables, keyed by a
  structural fingerprint of the space.

Every compiled path is required to agree exactly with the legacy iterator
path — the property tests in ``tests/test_spacetable.py`` enforce it — so
consumers (tuners, the orchestrator, the analyses) switch transparently.

Vectorized constraints see *value* columns (``cols[name][r]`` is the value of
parameter ``name`` in row ``r``) and must be total functions of the full
cross product: they are evaluated on all rows at once, not only on rows that
passed earlier constraints.  Python predicates keep the short-circuit
ordering guarantee instead.
"""

from __future__ import annotations

import hashlib
import os
import random
from pathlib import Path
from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .space import Config, SearchSpace

#: spaces larger than this are not compiled implicitly (callers can still
#: pass an explicit higher limit to ``SearchSpace.compiled``).
DEFAULT_COMPILE_LIMIT = 1 << 21

_CACHE_VERSION = 1
_CACHE_DIR_ENV = "REPRO_SPACE_CACHE"
_UNSET = object()
_cache_dir: object = _UNSET


def set_cache_dir(path: str | Path | None) -> None:
    """Set the process-wide exhaustive-table cache directory.  ``None``
    disables caching outright (including the ``REPRO_SPACE_CACHE``
    environment default, which applies only while unset)."""
    global _cache_dir
    _cache_dir = Path(path) if path is not None else None


def get_cache_dir() -> Path | None:
    if _cache_dir is not _UNSET:
        return _cache_dir  # type: ignore[return-value]
    env = os.environ.get(_CACHE_DIR_ENV)
    return Path(env) if env else None


#: probe rows hashed into the fingerprint (see space_fingerprint)
_FINGERPRINT_PROBES = 128


def space_fingerprint(space: "SearchSpace") -> str:
    """Structural identity of a space: name, parameters (names + values, in
    order), constraint names, and the constraints' *behaviour* on a
    deterministic probe set.

    Constraint callables close over problem constants (shapes etc.) that
    ``repr`` cannot see, so two same-named spaces with different closures
    must not share a cache entry.  We therefore evaluate the raw constraint
    chain on ~128 rows spread across the cross product and hash the
    accept/reject bits — any semantic difference visible on the probes
    changes the fingerprint.  (Two constraint sets that agree on every probe
    would still collide; delete the cache entry when editing constraints
    in place.)"""
    h = hashlib.sha256()
    h.update(f"v{_CACHE_VERSION}|{space.name}".encode())
    for p in space.params:
        h.update(f"|{p.name}={p.values!r}".encode())
    for c in space.constraints:
        h.update(f"|c:{c.name}".encode())
    if space.constraints:
        n = space.cardinality
        rows = np.unique(np.linspace(0, n - 1, min(n, _FINGERPRINT_PROBES),
                                     dtype=np.int64))
        bits = []
        for r in rows:
            cfg = space.from_flat_index(int(r))
            # the raw declaration-order chain, not the compiled mask (the
            # fingerprint is computed while building that mask)
            bits.append("1" if all(c(cfg) for c in space.constraints)
                        else "0")
        h.update(("|probe:" + "".join(bits)).encode())
    return h.hexdigest()[:16]


def mixed_radix_strides(cards: Sequence[int]) -> np.ndarray:
    """Place values of the mixed-radix encoding used everywhere in the
    suite: ``strides[i] = prod(cards[i+1:])``, so
    ``flat_index == codes @ strides`` (``SearchSpace.flat_index`` order,
    last parameter fastest).  The single authority for this math — the
    row==flat-index invariant depends on every site using it."""
    cards = np.asarray(cards, dtype=np.int64)
    cp = np.cumprod(cards[::-1])
    return np.concatenate(([1], cp[:-1]))[::-1].astype(np.int64)


def rows_from_codes(cards: Sequence[int],
                    codes: np.ndarray | Sequence[Sequence[int]]) -> np.ndarray:
    """Inverse of :meth:`CompiledSpace.codes_for`: fold mixed-radix code
    rows back into flat indices (``codes @ strides``).  Kept next to
    :func:`mixed_radix_strides` so every encoder and decoder of the
    row==flat-index invariant shares the same two functions — the servedb
    binary export writes rows through this and a serving process can
    decode them with plain ``divmod``."""
    codes = np.asarray(codes, dtype=np.int64)
    if codes.size == 0:
        return np.zeros(0, dtype=np.int64)
    return codes @ mixed_radix_strides(cards)


def _value_array(values: tuple) -> np.ndarray:
    """Per-parameter value column as a numpy array (object dtype when the
    values are heterogeneous)."""
    try:
        arr = np.asarray(values)
        if arr.shape == (len(values),):
            return arr
    except (ValueError, TypeError):
        pass
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    return arr


class CompiledSpace:
    """Array-native materialization of one :class:`SearchSpace`.

    Build via :meth:`build` (or ``space.compiled()``, which caches the result
    on the space).  Rows are flat indices: ``row == space.flat_index(config)``
    for the config the row encodes.
    """

    def __init__(self, space: "SearchSpace", mask: np.ndarray,
                 nbr_indptr: np.ndarray | None = None,
                 nbr_indices: np.ndarray | None = None,
                 cache_path: Path | None = None):
        self.space = space
        #: where this table persists (set by :meth:`build` when caching)
        self.cache_path = cache_path
        self.cards = np.array([p.cardinality for p in space.params],
                              dtype=np.int64)
        self.strides = mixed_radix_strides(self.cards)
        self.n_total = int(self.strides[0] * self.cards[0])
        if mask.shape != (self.n_total,):
            raise ValueError("mask shape does not match the space")
        self.mask = mask
        self.valid_rows = np.flatnonzero(mask).astype(np.int64)
        #: row -> position in ``valid_rows`` (-1 for invalid rows)
        self.row_pos = np.full(self.n_total, -1, dtype=np.int64)
        self.row_pos[self.valid_rows] = np.arange(len(self.valid_rows))
        self._nbr_indptr = nbr_indptr
        self._nbr_indices = nbr_indices
        self._alias: tuple[np.ndarray, np.ndarray] | None = None
        self._value_arrays: list[np.ndarray] | None = None
        #: plain-int copies for the tuners' per-candidate hot loops (numpy
        #: scalar indexing costs ~3x a list lookup at these sizes)
        self.py_cards = [int(c) for c in self.cards]
        self.py_strides = [int(s) for s in self.strides]

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def build(space: "SearchSpace",
              cache_dir: str | Path | None = None) -> "CompiledSpace":
        """Compile ``space``; loads from / saves to the table cache when a
        cache directory is configured."""
        from ..telemetry import metrics as _metrics
        cache_dir = Path(cache_dir) if cache_dir is not None \
            else get_cache_dir()
        path = None
        if cache_dir is not None:
            path = cache_dir / f"{space.name}-{space_fingerprint(space)}.npz"
            loaded = CompiledSpace._load(space, path)
            if loaded is not None:
                _metrics.counter("space_cache.hit", space=space.name).inc()
                return loaded
            _metrics.counter("space_cache.miss", space=space.name).inc()
        comp = CompiledSpace(space, CompiledSpace._compute_mask(space),
                             cache_path=path)
        if path is not None:
            comp.save(path)
        return comp

    @staticmethod
    def codes_for(space: "SearchSpace",
                  rows: np.ndarray | None = None) -> np.ndarray:
        """Mixed-radix code matrix for ``rows`` (default: all rows), one
        vectorized pass per column.  Row ``r``'s codes decode to
        ``space.from_flat_index(r)``."""
        cards = [p.cardinality for p in space.params]
        if rows is None:
            n = 1
            for c in cards:
                n *= c
            rows = np.arange(n, dtype=np.int64)
        else:
            rows = np.asarray(rows, dtype=np.int64)
        codes = np.empty((len(rows), len(cards)), dtype=np.int64)
        rem = rows
        for i in range(len(cards) - 1, -1, -1):
            rem, codes[:, i] = np.divmod(rem, cards[i])
        return codes

    @staticmethod
    def _compute_mask(space: "SearchSpace") -> np.ndarray:
        cards = [p.cardinality for p in space.params]
        n = 1
        for c in cards:
            n *= c
        strides = mixed_radix_strides(cards)
        mask = np.ones(n, dtype=bool)
        names = space.param_names
        pyvals = [p.values for p in space.params]
        cols: dict[str, np.ndarray] | None = None
        codes: np.ndarray | None = None       # built only for py fallbacks
        for c in space.constraints:
            vec = getattr(c, "vec", None)
            if vec is not None:
                if cols is None:
                    # mixed-radix value columns by repeat/tile — identical
                    # to fancy-indexing the code matrix, without building it
                    cols = {nm: np.tile(np.repeat(_value_array(pv), s),
                                        n // (s * k))
                            for nm, pv, s, k
                            in zip(names, pyvals,
                                   (int(s) for s in strides), cards)}
                res = np.asarray(vec(cols), dtype=bool)
                if res.shape != (n,):
                    raise ValueError(
                        f"constraint {c.name!r}: vec returned shape "
                        f"{res.shape}, expected ({n},)")
                mask &= res
            else:
                # Python fallback, only on rows still alive — preserves the
                # declaration-order short-circuit of ``satisfies``.
                if codes is None:
                    codes = CompiledSpace.codes_for(space)
                alive = np.flatnonzero(mask)
                fn = c.fn
                drop = [r for r in alive
                        if not fn({nm: pv[j] for nm, pv, j
                                   in zip(names, pyvals, codes[r])})]
                if drop:
                    mask[drop] = False
        return mask

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def n_valid(self) -> int:
        return len(self.valid_rows)

    def decode_row(self, row: int) -> "Config":
        return self.space.from_flat_index(int(row))

    def decode_many(self, rows: Sequence[int] | np.ndarray) -> list["Config"]:
        """Batched decode: one numpy pass per column, then a zip into dicts.

        Type-homogeneous parameters (all-int / all-float / all-str values)
        take a fancy-index + ``tolist`` fast path; heterogeneous ones fall
        back to per-element lookups so decoded values are always ``==`` (and
        same-typed) to the originals in ``Param.values``.
        """
        rows = np.asarray(rows, dtype=np.int64)
        if not len(rows):
            return []
        codes = CompiledSpace.codes_for(self.space, rows)
        names = self.space.param_names
        columns = []
        for i, p in enumerate(self.space.params):
            t = type(p.values[0])
            if t in (int, float, str) \
                    and all(type(v) is t for v in p.values):
                columns.append(np.asarray(p.values)[codes[:, i]].tolist())
            else:
                pv = p.values
                columns.append([pv[j] for j in codes[:, i].tolist()])
        return [dict(zip(names, vals)) for vals in zip(*columns)]

    def encode_many(self, configs: Sequence["Config"]) -> np.ndarray:
        return self.space.encode_many(configs)

    def flat_index_many(self, configs: Sequence["Config"]) -> np.ndarray:
        return self.space.flat_index_many(configs)

    def valid_configs(self) -> list["Config"]:
        """All constraint-satisfying configs, in ``SearchSpace.enumerate``
        order (row order)."""
        return self.decode_many(self.valid_rows)

    def value_columns(self, rows: Sequence[int] | np.ndarray
                      ) -> dict[str, np.ndarray]:
        """Per-parameter *value* column arrays for ``rows`` — the same
        column form the vectorized constraints consume, fed to the
        per-kernel ``feature_columns`` overrides.  No dicts per config."""
        rows = np.asarray(rows, dtype=np.int64)
        codes = CompiledSpace.codes_for(self.space, rows)
        if self._value_arrays is None:
            self._value_arrays = [_value_array(p.values)
                                  for p in self.space.params]
        return {p.name: va[codes[:, i]]
                for i, (p, va) in enumerate(zip(self.space.params,
                                                self._value_arrays))}

    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #
    def sample_row(self, rng: random.Random) -> int:
        """O(1) rejection-free uniform draw from the valid set."""
        if not len(self.valid_rows):
            raise RuntimeError(f"{self.space.name}: no valid configs")
        return int(self.valid_rows[rng.randrange(len(self.valid_rows))])

    def sample(self, rng: random.Random) -> "Config":
        return self.decode_row(self.sample_row(rng))

    def sample_rows_distinct(self, n: int, rng: random.Random) -> np.ndarray:
        """Up to ``n`` distinct valid rows, uniformly without replacement."""
        k = min(n, len(self.valid_rows))
        return self.valid_rows[np.asarray(
            rng.sample(range(len(self.valid_rows)), k), dtype=np.int64)]

    def sample_row_rejection(self, rng: random.Random,
                             max_tries: int = 10_000) -> int:
        """Rejection draw of a valid row with the *legacy draw sequence*.

        ``SearchSpace.sample`` draws one ``rng.choice(p.values)`` per
        parameter per try; ``rng.choice(seq)`` consumes exactly one
        ``_randbelow(len(seq))``, which is what ``rng.randrange(card)``
        consumes too — so this method returns the row of the config the
        legacy path would return, from the identical rng state, without
        building a single dict.  The index-native tuners use it wherever
        their scalar oracles call ``space.sample``.
        """
        mask = self.mask
        cards = self.py_cards
        strides = self.py_strides
        # rng.choice(seq) == seq[rng._randbelow(len(seq))] in CPython;
        # calling _randbelow directly skips randrange's argument ceremony
        # while consuming the identical draws (trajectory tests enforce it)
        randbelow = rng._randbelow
        n_params = len(cards)
        for _ in range(max_tries):
            row = 0
            for i in range(n_params):
                row += randbelow(cards[i]) * strides[i]
            if mask[row]:
                return row
        raise RuntimeError(
            f"{self.space.name}: could not sample a valid config "
            f"in {max_tries} tries")

    def random_neighbor_row(self, row: int, rng: random.Random,
                            max_tries: int = 1000) -> int:
        """Row-native ``SearchSpace.random_neighbor``: identical draw
        sequence (param choice, value choice, retry on self/invalid),
        returning ``row`` itself when no move is found — all in int
        arithmetic plus one mask lookup per try."""
        mask = self.mask
        cards = self.py_cards
        strides = self.py_strides
        n_params = len(cards)
        randbelow = rng._randbelow      # draw-identical to rng.choice
        for _ in range(max_tries):
            d = randbelow(n_params)
            j = randbelow(cards[d])
            cur = (row // strides[d]) % cards[d]
            if j == cur:
                continue
            nrow = row + (j - cur) * strides[d]
            if mask[nrow]:
                return nrow
        return row

    # ------------------------------------------------------------------ #
    # alias-sampled neighbor moves
    # ------------------------------------------------------------------ #
    def edge_params(self) -> np.ndarray:
        """Per-CSR-edge moved-parameter index: edge ``e`` changes parameter
        ``edge_params()[e]`` of its source config."""
        indptr, indices = self.csr_neighbors()
        src_pos = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                            np.diff(indptr))
        delta = np.abs(self.valid_rows[indices] - self.valid_rows[src_pos])
        # a Hamming-1 move along dim d shifts the row by |j-cur| * strides[d]
        # with |j-cur| < cards[d], so strides[d] <= |delta| < strides[d-1]:
        # the dim is the first stride <= |delta| in the descending stride
        # vector, i.e. the count of strides strictly greater than |delta|.
        out = np.searchsorted(-self.strides, -delta, side="left")
        return out.astype(np.int64)

    def neighbor_alias(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-row Vose alias tables over the CSR neighbor lists, weighted
        ``1/cards[moved_param]`` — the conditional distribution of the
        accepted legacy rejection draw (uniform parameter, then uniform
        value).  Aligned with ``csr_neighbors()``: entries
        ``indptr[k]:indptr[k+1]`` are row ``k``'s (prob, alias) table, alias
        indices *local* to the segment.  Built lazily, kept in memory."""
        if self._alias is None:
            indptr, indices = self.csr_neighbors()
            w = 1.0 / self.cards[self.edge_params()].astype(np.float64)
            prob = np.ones(len(indices), dtype=np.float64)
            alias = np.zeros(len(indices), dtype=np.int64)
            for k in range(len(indptr) - 1):
                lo, hi = int(indptr[k]), int(indptr[k + 1])
                deg = hi - lo
                if deg == 0:
                    continue
                p = w[lo:hi] * (deg / w[lo:hi].sum())
                small = [i for i in range(deg) if p[i] < 1.0]
                large = [i for i in range(deg) if p[i] >= 1.0]
                while small and large:
                    s, g = small.pop(), large.pop()
                    prob[lo + s] = p[s]
                    alias[lo + s] = g
                    p[g] = (p[g] + p[s]) - 1.0
                    (small if p[g] < 1.0 else large).append(g)
                for i in large + small:       # numerical leftovers: prob 1
                    prob[lo + i] = 1.0
                    alias[lo + i] = i
        else:
            return self._alias
        self._alias = (prob, alias)
        return self._alias

    def sample_neighbor_alias(self, row: int, rng: random.Random) -> int:
        """O(1) draw of a valid Hamming-1 neighbor row of a *valid* ``row``
        from the alias tables (two rng draws: slot, coin).  Returns ``-1``
        when the row has no valid neighbors (degenerate CSR row) and raises
        ``ValueError`` for rows outside the valid set."""
        pos = int(self.row_pos[row])
        if pos < 0:
            raise ValueError(f"row {row} is not a valid config row")
        indptr, indices = self.csr_neighbors()
        lo, hi = int(indptr[pos]), int(indptr[pos + 1])
        deg = hi - lo
        if deg == 0:
            return -1
        prob, alias = self.neighbor_alias()
        k = rng.randrange(deg)
        if rng.random() >= prob[lo + k]:
            k = int(alias[lo + k])
        return int(self.valid_rows[indices[lo + k]])

    # ------------------------------------------------------------------ #
    # CSR Hamming-1 neighbor tables
    # ------------------------------------------------------------------ #
    def csr_neighbors(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, indices) over valid-set *positions*: the Hamming-1
        neighbors of ``valid_rows[k]`` are
        ``valid_rows[indices[indptr[k]:indptr[k+1]]]``, listed in
        ``SearchSpace.neighbors`` order (parameter order, then value order).
        Built lazily, cached, and re-persisted to this table's own cache
        file (the one :meth:`build` loaded from / saved to) when caching is
        enabled."""
        if self._nbr_indptr is None:
            self._nbr_indptr, self._nbr_indices = self._build_csr()
            if self.cache_path is not None:
                self.save(self.cache_path)
        return self._nbr_indptr, self._nbr_indices

    def _build_csr(self) -> tuple[np.ndarray, np.ndarray]:
        vrows = self.valid_rows
        nv = len(vrows)
        if nv == 0:
            return (np.zeros(1, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        vcodes = CompiledSpace.codes_for(self.space, vrows)
        src_parts: list[np.ndarray] = []
        dst_parts: list[np.ndarray] = []
        for i in range(len(self.cards)):
            stride = int(self.strides[i])
            base = vrows - vcodes[:, i] * stride
            for j in range(int(self.cards[i])):
                sel = np.flatnonzero(vcodes[:, i] != j)
                if not len(sel):
                    continue
                pos = self.row_pos[base[sel] + j * stride]
                hit = pos >= 0
                src_parts.append(sel[hit])
                dst_parts.append(pos[hit])
        src = np.concatenate(src_parts) if src_parts \
            else np.empty(0, dtype=np.int64)
        dst = np.concatenate(dst_parts) if dst_parts \
            else np.empty(0, dtype=np.int64)
        # stable sort by source keeps the (param, value) generation order
        # within each node — the legacy ``neighbors`` iteration order.
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(np.bincount(src, minlength=nv), out=indptr[1:])
        return indptr, dst[order]

    def neighbor_rows(self, row: int) -> np.ndarray | None:
        """Valid Hamming-1 neighbor rows of a *valid* row (``None`` when
        ``row`` itself is invalid — callers fall back to the iterator)."""
        pos = int(self.row_pos[row])
        if pos < 0:
            return None
        indptr, indices = self.csr_neighbors()
        return self.valid_rows[indices[indptr[pos]:indptr[pos + 1]]]

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "fingerprint": np.frombuffer(
                space_fingerprint(self.space).encode(), dtype=np.uint8),
            "n_total": np.array([self.n_total], dtype=np.int64),
            "mask_bits": np.packbits(self.mask),
        }
        if self._nbr_indptr is not None:
            payload["nbr_indptr"] = self._nbr_indptr
            payload["nbr_indices"] = self._nbr_indices
        tmp = path.with_suffix(".tmp.npz")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _load(space: "SearchSpace", path: Path) -> "CompiledSpace | None":
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                fp = bytes(z["fingerprint"]).decode()
                if fp != space_fingerprint(space) \
                        or int(z["n_total"][0]) != space.cardinality:
                    return None
                mask = np.unpackbits(
                    z["mask_bits"], count=space.cardinality).astype(bool)
                indptr = z["nbr_indptr"] if "nbr_indptr" in z else None
                indices = z["nbr_indices"] if "nbr_indices" in z else None
        except (OSError, ValueError, KeyError):  # corrupt cache: rebuild
            return None
        return CompiledSpace(space, mask, indptr, indices, cache_path=path)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CompiledSpace({self.space.name!r}, rows={self.n_total}, "
                f"valid={self.n_valid}, "
                f"csr={'built' if self._nbr_indptr is not None else 'lazy'})")
