"""Results database — BAT-style cachefiles.

Full-space / sampled evaluation data is expensive to (re)compute, and every
analysis (Figs 1-6, Table VIII) reads the same tables.  We persist one JSON
file per (problem × arch) under a cache directory, plus tuner-run traces.

orjson + zstd keep multi-100k-row tables compact when available (the
``[fast]`` extra); otherwise we fall back to stdlib ``json`` + ``zlib``.
The compressor is identified by the frame header — zstd frames start with
the magic ``28 B5 2F FD``, zlib streams with ``0x78`` — so files written by
either path load under the other without corrupting the cache (reading a
zstd file does require zstandard).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

from .compression import compress, decompress
from .problem import Trial, TunableProblem
from .space import Config, SearchSpace

try:  # optional fast path: pip install .[fast]
    import orjson
except ImportError:  # pragma: no cover - depends on environment
    orjson = None


def _np_default(obj):
    """stdlib-json fallback for numpy scalars/arrays (orjson handles these
    natively via OPT_SERIALIZE_NUMPY)."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


def _json_dumps(obj) -> bytes:
    if orjson is not None:
        return orjson.dumps(obj, option=orjson.OPT_SERIALIZE_NUMPY)
    return json.dumps(obj, default=_np_default,
                      separators=(",", ":")).encode()


def _json_loads(raw: bytes):
    return orjson.loads(raw) if orjson is not None else json.loads(raw)


def _dump(obj) -> bytes:
    return compress(_json_dumps(obj), level=6)


def _load(raw: bytes):
    return _json_loads(decompress(raw, what="cachefile"))


@dataclass
class ResultTable:
    """Evaluated configs for one (problem, arch): the unit of analysis."""

    problem: str
    arch: str
    param_names: tuple[str, ...]
    configs: list[tuple]          # encoded index tuples (compact)
    objectives: list[float]       # seconds; inf => invalid on this arch
    protocol: str = "exhaustive"  # or "sampled:<n>:<seed>"
    meta: dict = field(default_factory=dict)

    # -- accessors -------------------------------------------------------- #
    def __len__(self) -> int:
        return len(self.objectives)

    def finite(self) -> list[float]:
        return [o for o in self.objectives if math.isfinite(o)]

    def best(self) -> tuple[tuple, float]:
        i = min(range(len(self.objectives)), key=lambda j: self.objectives[j])
        return self.configs[i], self.objectives[i]

    def decode(self, space: SearchSpace, encoded: tuple) -> Config:
        return space.decode(encoded)

    @staticmethod
    def from_trials(problem: TunableProblem, arch: str,
                    trials: Sequence[Trial], protocol: str) -> "ResultTable":
        sp = problem.space
        rows = [getattr(t, "row", None) for t in trials]
        if trials and all(r is not None for r in rows):
            # row-born trials (row-native sessions, journal-v2 replays):
            # the encoded tuples ARE the mixed-radix codes of the rows, so
            # build them in one vectorized pass — no config dict is ever
            # decoded just to be re-encoded here
            from .spacetable import CompiledSpace
            codes = CompiledSpace.codes_for(sp, rows)
            configs = [tuple(c) for c in codes.tolist()]
        else:
            configs = [sp.encode(t.config) for t in trials]
        return ResultTable(
            problem=problem.name, arch=arch, param_names=sp.param_names,
            configs=configs,
            objectives=[t.objective if t.valid else math.inf for t in trials],
            protocol=protocol)

    # -- (de)serialization ------------------------------------------------- #
    def to_bytes(self) -> bytes:
        return _dump({
            "problem": self.problem, "arch": self.arch,
            "param_names": list(self.param_names),
            "configs": [list(c) for c in self.configs],
            "objectives": [None if math.isinf(o) else o for o in self.objectives],
            "protocol": self.protocol, "meta": self.meta})

    @staticmethod
    def from_bytes(raw: bytes) -> "ResultTable":
        d = _load(raw)
        return ResultTable(
            problem=d["problem"], arch=d["arch"],
            param_names=tuple(d["param_names"]),
            configs=[tuple(c) for c in d["configs"]],
            objectives=[math.inf if o is None else float(o)
                        for o in d["objectives"]],
            protocol=d.get("protocol", "?"), meta=d.get("meta", {}))


class ResultsDB:
    """Directory-backed cache of :class:`ResultTable` and tuner traces."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, problem: str, arch: str, protocol: str) -> Path:
        safe = protocol.replace(":", "_")
        return self.root / f"{problem}.{arch}.{safe}.json.zst"

    def has(self, problem: str, arch: str, protocol: str) -> bool:
        return self._path(problem, arch, protocol).exists()

    def list_tables(self) -> list[tuple[str, str, str]]:
        """Every cached ``(problem, arch, protocol)`` key, sorted.

        The inverse of :meth:`_path`'s naming scheme: problem and arch
        never contain dots, so the first two dot-fields are exact and the
        remainder is the (``:``-mangled) protocol.  Unparsable strays in
        the cache directory are ignored — consumers (the servedb
        distiller) must not fall over a hand-dropped file.
        """
        out = []
        for p in self.root.glob("*.json.zst"):
            parts = p.name[:-len(".json.zst")].split(".")
            if len(parts) >= 3:
                out.append((parts[0], parts[1], ".".join(parts[2:])))
        return sorted(out)

    def put(self, table: ResultTable) -> Path:
        p = self._path(table.problem, table.arch, table.protocol)
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(table.to_bytes())
        os.replace(tmp, p)          # atomic commit
        return p

    def get(self, problem: str, arch: str, protocol: str) -> ResultTable:
        return ResultTable.from_bytes(
            self._path(problem, arch, protocol).read_bytes())

    def get_or_compute(self, problem: TunableProblem, arch: str,
                       protocol: str = "exhaustive", n: int = 10_000,
                       seed: int = 0) -> ResultTable:
        """The paper's data protocol: exhaustive where feasible, otherwise
        ``n`` distinct random configs."""
        key = protocol if protocol == "exhaustive" else f"sampled_{n}_{seed}"
        if self.has(problem.name, arch, key):
            return self.get(problem.name, arch, key)
        if protocol == "exhaustive":
            trials = problem.exhaustive(arch)
        else:
            trials = problem.sampled(n, seed, arch)
        table = ResultTable.from_trials(problem, arch, trials, key)
        self.put(table)
        return table
