"""Fig 3: proportion-of-centrality search-difficulty metric.

From Schoonhoven et al.: build the fitness flow graph (FFG) — every valid
config is a node, with a directed edge to each Hamming-1 neighbor of strictly
lower fitness.  A random walk on the FFG mimics randomized first-improvement
local search; PageRank gives the expected arrival mass.  The metric is the
share of PageRank mass held by the "suitably good" local minima
(fitness ≤ (1+p)·f_opt) relative to all local minima — higher == easier for
local search.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..results import ResultTable
from ..space import SearchSpace


@dataclass
class FFG:
    n: int
    src: np.ndarray            # edge sources (node ids)
    dst: np.ndarray            # edge destinations
    fitness: np.ndarray        # per-node objective (seconds)
    minima: np.ndarray         # bool: node is a local minimum (no out-edges)


def build_ffg(space: SearchSpace, table: ResultTable) -> FFG:
    """FFG over the *valid* configs recorded in ``table``.

    Neighborhood = Hamming-1 within the recorded set (for sampled tables this
    is the induced subgraph, same protocol the paper uses when exhaustive
    enumeration is out of reach).

    Vectorized: encoded configs become mixed-radix flat keys; each
    (parameter, value) Hamming-1 move is one arithmetic shift of the key
    column joined back against the sorted key set via ``searchsorted``.
    Produces node ids, fitness, and edge arrays identical to
    :func:`build_ffg_reference` (the per-config dict-loop original, kept as
    the test oracle) — this join is what makes exhaustive FFGs affordable
    for the benchmarks the paper skipped for cost.
    """
    obj = np.asarray(table.objectives, dtype=np.float64)
    enc = np.asarray(table.configs, dtype=np.int64)
    if enc.ndim != 2:                 # empty table: keep a (0, P) shape
        enc = enc.reshape(-1, len(space.params))
    finite = np.isfinite(obj)
    obj, enc = obj[finite], enc[finite]

    from ..spacetable import mixed_radix_strides
    cards = np.array([p.cardinality for p in space.params], dtype=np.int64)
    strides = mixed_radix_strides(cards)
    flat = enc @ strides if len(obj) else np.empty(0, dtype=np.int64)

    # dedup keeping the first occurrence; node ids in first-occurrence order
    uniq, first = np.unique(flat, return_index=True)
    order = np.argsort(first, kind="stable")      # node id -> sorted position
    inv_order = np.empty(len(uniq), dtype=np.int64)
    inv_order[order] = np.arange(len(uniq))       # sorted position -> node id
    occ = first[order]
    fitness = obj[occ]
    node_flat = flat[occ]
    node_codes = enc[occ]
    n = len(uniq)

    # Exhaustive tables over a compiled space reuse its precomputed CSR
    # neighbor table (arch-independent, cached on the space and on disk):
    # the join collapses to one fitness filter over the edge list.
    comp = space.compiled(build=False)
    if comp is not None and n == comp.n_valid \
            and np.array_equal(uniq, comp.valid_rows):
        indptr, indices = comp.csr_neighbors()
        src_pos = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        fit_by_pos = fitness[inv_order]
        keep = fit_by_pos[indices] < fit_by_pos[src_pos]
        src = inv_order[src_pos[keep]]
        dst = inv_order[indices[keep]]
        e_order = np.argsort(src, kind="stable")
        src, dst = src[e_order], dst[e_order]
        outdeg = np.bincount(src, minlength=n)
        return FFG(n=n, src=src, dst=dst, fitness=fitness,
                   minima=outdeg == 0)

    src_parts: list[np.ndarray] = []
    dst_parts: list[np.ndarray] = []
    ids = np.arange(n, dtype=np.int64)
    for d in range(len(cards)):
        stride = int(strides[d])
        card = int(cards[d])
        cur = node_codes[:, d]
        base = node_flat - cur * stride
        # all (node, value) Hamming-1 moves along dim d in one (n, card) pass
        q = (base[:, None] + np.arange(card, dtype=np.int64) * stride).ravel()
        pos = np.searchsorted(uniq, q)
        pos_c = np.minimum(pos, max(n - 1, 0))
        hit = (uniq[pos_c] == q) if n else np.zeros(len(q), dtype=bool)
        not_self = (np.arange(card)[None, :] != cur[:, None]).ravel()
        ok = hit & not_self
        u_ids = np.repeat(ids, card)[ok]
        v_ids = inv_order[pos_c[ok]]
        better = fitness[v_ids] < fitness[u_ids]
        src_parts.append(u_ids[better])
        dst_parts.append(v_ids[better])
    src = np.concatenate(src_parts) if src_parts else np.empty(0, np.int64)
    dst = np.concatenate(dst_parts) if dst_parts else np.empty(0, np.int64)
    # stable sort by source reproduces the reference edge emission order:
    # within each part edges come (node-major, value order), parts come in
    # parameter order, so equal-src runs sort to (parameter, value) order
    e_order = np.argsort(src, kind="stable")
    src, dst = src[e_order], dst[e_order]
    outdeg = np.bincount(src, minlength=n)
    return FFG(n=n, src=src, dst=dst, fitness=fitness, minima=outdeg == 0)


def build_ffg_reference(space: SearchSpace, table: ResultTable) -> FFG:
    """Per-config dict-loop FFG construction — the scalar reference that
    :func:`build_ffg` must match bit-for-bit (see tests/test_spacetable.py)."""
    enc2id: dict[tuple, int] = {}
    fit: list[float] = []
    for cfg_enc, obj in zip(table.configs, table.objectives):
        if np.isfinite(obj) and tuple(cfg_enc) not in enc2id:
            enc2id[tuple(cfg_enc)] = len(fit)
            fit.append(obj)
    fitness = np.array(fit)
    n = len(fitness)
    cards = [p.cardinality for p in space.params]
    src_l: list[int] = []
    dst_l: list[int] = []
    for enc, u in enc2id.items():
        fu = fitness[u]
        for d, c in enumerate(cards):
            for v_idx in range(c):
                if v_idx == enc[d]:
                    continue
                nb = enc[:d] + (v_idx,) + enc[d + 1:]
                v = enc2id.get(nb)
                if v is not None and fitness[v] < fu:
                    src_l.append(u)
                    dst_l.append(v)
    src = np.array(src_l, dtype=np.int64)
    dst = np.array(dst_l, dtype=np.int64)
    outdeg = np.bincount(src, minlength=n)
    return FFG(n=n, src=src, dst=dst, fitness=fitness, minima=outdeg == 0)


def pagerank(ffg: FFG, damping: float = 0.85, iters: int = 100,
             tol: float = 1e-10) -> np.ndarray:
    """Power iteration; dangling (local-minimum) mass redistributes uniformly."""
    n = ffg.n
    if n == 0:
        return np.array([])
    outdeg = np.bincount(ffg.src, minlength=n).astype(np.float64)
    dangling_nodes = outdeg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        # bincount-scatter: np.add.at is an order of magnitude slower on the
        # ~100-iteration power loop run per (benchmark, arch)
        w = r[ffg.src] / outdeg[ffg.src]
        contrib = np.bincount(ffg.dst, weights=w, minlength=n)
        dangling = r[dangling_nodes].sum()
        r_new = (1 - damping) / n + damping * (contrib + dangling / n)
        if np.abs(r_new - r).sum() < tol:
            r = r_new
            break
        r = r_new
    return r / r.sum()


def proportion_of_centrality(space: SearchSpace, table: ResultTable,
                             p: float = 0.10, damping: float = 0.85) -> float:
    """Share of minima PageRank mass on minima with fitness ≤ (1+p)·f_opt."""
    ffg = build_ffg(space, table)
    if ffg.n == 0 or not ffg.minima.any():
        return float("nan")
    pr = pagerank(ffg, damping)
    f_opt = ffg.fitness.min()
    good = ffg.minima & (ffg.fitness <= (1.0 + p) * f_opt)
    total = pr[ffg.minima].sum()
    return float(pr[good].sum() / total) if total > 0 else float("nan")


def centrality_curve(space: SearchSpace, table: ResultTable,
                     ps: np.ndarray | None = None) -> dict:
    """Metric as a function of p (the paper sweeps the proportion p)."""
    ffg = build_ffg(space, table)
    pr = pagerank(ffg)
    f_opt = ffg.fitness.min()
    total = pr[ffg.minima].sum()
    if ps is None:
        ps = np.linspace(0.0, 0.5, 26)
    vals = []
    for p in ps:
        good = ffg.minima & (ffg.fitness <= (1.0 + p) * f_opt)
        vals.append(float(pr[good].sum() / total) if total > 0 else float("nan"))
    return {"p": np.asarray(ps).tolist(), "proportion": vals,
            "n_nodes": ffg.n, "n_minima": int(ffg.minima.sum()),
            "n_edges": int(len(ffg.src))}
