"""Distill campaign ResultsDB traces into a servable find-DB snapshot.

The build side of the serving layer (MITuna's ``gen_fastdb`` step, in
this suite's terms): walk a session store's published
:class:`~repro_torch.core.results.ResultTable` traces, keep the best finite
config per (kernel, shape, arch), and publish the condensed golden
tables as one atomic :class:`~repro_torch.servedb.snapshot.Snapshot` — plus
a binary npz export in the ``CompiledSpace`` row encoding, so a serving
process can map the tables without re-parsing JSON.

Only the builder resolves problems (shapes come from session specs via
:func:`~repro_torch.orchestrator.registry.host_problem`, which imports the
kernel stack); the lookup side never needs torch.  A kernel problem is
built on the CPU whatever its spec names (``device: cuda``, or no device,
which is the card): the builder reads only its shape and space, so it runs
on a host with no card and allocates nothing on one that has a card.  The
port's table names are its registry names (:data:`REGISTRY_NAME` is the
identity).
"""

from __future__ import annotations

import io
import json
import math
from pathlib import Path

import numpy as np

from ..core.spacetable import rows_from_codes
from ..orchestrator.registry import PROBLEM_PATHS, TOY_FACTORIES, host_problem
from ..orchestrator.store import SessionStore
from .snapshot import Snapshot, shape_key

__all__ = ["REGISTRY_NAME", "build_snapshot", "binary_export", "load_binary"]

#: ResultTable.problem (table/space name) -> registry name for make_problem:
#: the identity over the port's eight problems and the two toys (the port
#: registers each kernel under its table name, ``flash_attention_h100``
#: included)
REGISTRY_NAME: dict[str, str] = {
    name: name for name in (*PROBLEM_PATHS, *TOY_FACTORIES)}


def _resolve_problem(store: SessionStore, table, problems: list[str]):
    """The live problem behind one published trace — session spec first
    (it carries the real shape kwargs), registry default shape as the
    fallback.  Returns ``(problem | None, shape_dict)``."""
    sid = table.meta.get("session", "")
    if not sid and table.protocol.startswith("session_"):
        sid = table.protocol[len("session_"):]
    try:
        if sid and store.exists(sid):
            spec = store.load_spec(sid)
            p = host_problem(spec.problem, **spec.problem_kwargs)
        else:
            reg = REGISTRY_NAME.get(table.problem)
            if reg is None:
                problems.append(
                    f"{table.problem}.{table.arch}.{table.protocol}: "
                    f"unknown problem, skipped")
                return None, {}
            p = host_problem(reg)
    except Exception as e:
        problems.append(
            f"{table.problem}.{table.arch}.{table.protocol}: problem "
            f"resolution failed ({e}), skipped")
        return None, {}
    return p, dict(getattr(p, "shape", {}) or {})


def _modal_config(entries: list[dict]) -> dict | None:
    """The per-(kernel, arch) heuristic: the config winning the *most*
    shapes — objectives across shapes are incommensurable, vote counts
    are not.  Ties break on the smallest shape key it won, so the pick
    is deterministic."""
    if not entries:
        return None
    votes: dict[str, tuple[int, str, dict]] = {}
    for e in entries:
        ck = json.dumps(e["config"], sort_keys=True, separators=(",", ":"))
        n, first, cfg = votes.get(ck, (0, "￿", e["config"]))
        votes[ck] = (n + 1, min(first, shape_key(e.get("shape"))), cfg)
    _, _, cfg = min(votes.values(), key=lambda v: (-v[0], v[1]))
    return dict(cfg)


def build_snapshot(store_root: str | Path, *,
                   ttl_s: float | None = None,
                   include_protocols: tuple[str, ...] = ("session",),
                   with_binary: bool = True
                   ) -> tuple[Snapshot, bytes | None, list[str]]:
    """Distill every matching published trace under ``store_root`` into a
    publishable snapshot.

    Returns ``(snapshot, binary_bytes | None, problems)``; build-side
    problems (unresolvable sessions, tables with no finite result) are
    reported, never fatal — a campaign with one broken trace still
    serves the rest.  ``include_protocols`` prefixes select which
    ResultsDB protocols feed the tables (``"session"`` matches
    ``session_*``; add ``"exhaustive"``/``"sampled"`` to distill the
    paper's full-space tables too).
    """
    store = SessionStore(store_root)
    problems: list[str] = []
    # (kernel, arch, shape_key) -> best entry
    best: dict[tuple[str, str, str], dict] = {}
    spaces: dict[str, object] = {}      # kernel -> SearchSpace (binary enc)
    for kernel, arch, protocol in store.tables.list_tables():
        if not any(protocol.startswith(p) for p in include_protocols):
            continue
        try:
            table = store.tables.get(kernel, arch, protocol)
        except Exception as e:
            problems.append(f"{kernel}.{arch}.{protocol}: unreadable "
                            f"cachefile ({e}), skipped")
            continue
        problem, shape = _resolve_problem(store, table, problems)
        if problem is None:
            continue
        finite = [i for i, o in enumerate(table.objectives)
                  if math.isfinite(o)]
        if not finite:
            problems.append(f"{kernel}.{arch}.{protocol}: no finite "
                            f"result, skipped")
            continue
        i = min(finite, key=lambda j: table.objectives[j])
        try:
            config = problem.space.decode(table.configs[i])
        except Exception as e:
            problems.append(f"{kernel}.{arch}.{protocol}: best config "
                            f"failed to decode ({e}), skipped")
            continue
        spaces.setdefault(kernel, problem.space)
        entry = {"shape": shape, "config": config,
                 "objective": float(table.objectives[i]),
                 "protocol": protocol, "trials": len(table)}
        key = (kernel, arch, shape_key(shape))
        prev = best.get(key)
        if prev is None or entry["objective"] < prev["objective"]:
            best[key] = entry

    tables: dict = {}
    for (kernel, arch, _), entry in sorted(best.items()):
        group = tables.setdefault(kernel, {}).setdefault(
            arch, {"param_names": list(spaces[kernel].param_names),
                   "entries": [], "heuristic": None})
        group["entries"].append(entry)
    for kernel in tables:
        for arch, group in tables[kernel].items():
            group["heuristic"] = _modal_config(group["entries"])

    snap = Snapshot(tables=tables, ttl_s=ttl_s, source=str(store.root))
    binary = binary_export(snap, spaces) if with_binary and tables else None
    return snap, binary, problems


# --------------------------------------------------------------------- #
# binary export: the CompiledSpace row encoding, npz-packed
# --------------------------------------------------------------------- #
def binary_export(snap: Snapshot, spaces: dict) -> bytes:
    """Pack the snapshot's tables as npz arrays in row encoding.

    Per kernel: ``<k>|param_names`` and per-parameter ``<k>|values|<p>``
    columns (the mixed-radix digit alphabets).  Per (kernel, arch)
    group: ``<k>|<a>|rows`` (flat indices — the same row ids every
    CompiledSpace consumer uses), ``…|objectives`` and ``…|shapes``
    (shape-key strings), entry-aligned with the JSON tables.  The whole
    archive is self-describing: decoding rows back to configs needs only
    these arrays, never a live ``SearchSpace``.
    """
    payload: dict[str, np.ndarray] = {}
    for kernel in sorted(snap.tables):
        space = spaces[kernel]
        names = list(space.param_names)
        payload[f"{kernel}|param_names"] = np.asarray(names)
        for p in space.params:
            payload[f"{kernel}|values|{p.name}"] = np.asarray(p.values)
        cards = [p.cardinality for p in space.params]
        value_index = [
            {v: i for i, v in enumerate(p.values)} for p in space.params]
        for arch in sorted(snap.tables[kernel]):
            group = snap.tables[kernel][arch]
            entries = sorted(group["entries"],
                             key=lambda e: shape_key(e.get("shape")))
            codes = [[value_index[i][e["config"][n]]
                      for i, n in enumerate(names)] for e in entries]
            payload[f"{kernel}|{arch}|rows"] = rows_from_codes(cards, codes)
            payload[f"{kernel}|{arch}|objectives"] = np.asarray(
                [e["objective"] for e in entries], dtype=np.float64)
            payload[f"{kernel}|{arch}|shapes"] = np.asarray(
                [shape_key(e.get("shape")) for e in entries])
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    return buf.getvalue()


def load_binary(root: str | Path, snap: Snapshot) -> dict | None:
    """Open the snapshot's binary export and decode it back to configs.

    Returns ``{kernel: {arch: {"rows", "objectives", "shapes",
    "configs"}}}`` (configs as dicts, entry-aligned with the JSON
    tables), or ``None`` when the snapshot carries no (valid) binary —
    the caller falls back to the JSON tables, per the degradation
    contract.  Never raises on a bad archive.
    """
    if snap.binary is None:
        return None
    try:
        with np.load(Path(root) / snap.binary, allow_pickle=False) as z:
            out: dict = {}
            for kernel in snap.tables:
                names = [str(n) for n in z[f"{kernel}|param_names"]]
                values = [z[f"{kernel}|values|{n}"].tolist() for n in names]
                cards = [len(v) for v in values]
                for arch in snap.tables[kernel]:
                    rows = z[f"{kernel}|{arch}|rows"]
                    configs = []
                    for r in rows.tolist():
                        cfg, rem = {}, r
                        for i in range(len(names) - 1, -1, -1):
                            rem, d = divmod(rem, cards[i])
                            cfg[names[i]] = values[i][d]
                        configs.append({n: cfg[n] for n in names})
                    out.setdefault(kernel, {})[arch] = {
                        "rows": rows,
                        "objectives": z[f"{kernel}|{arch}|objectives"],
                        "shapes": [str(s)
                                   for s in z[f"{kernel}|{arch}|shapes"]],
                        "configs": configs,
                    }
            return out
    except Exception:
        return None
