"""The paper's landscape analyses on a table the card measured.

    PYTHONPATH=src python -m repro_torch.landscape [--problem NAME]
        [--samples N] [--small] [--arch ID] [--portability]

``NAME`` is a problem the port measures whole (``pnpoly_h100``,
``nbody_h100``, ``conv2d_h100`` or ``flash_attention_h100``, the default)
or one of the paper's sampled spaces (``hotspot_h100``, ``dedisp_h100``,
``expdist_h100``).

1. time configs of the problem's space on the card, each measured as the
   tuners measure it.  A problem measured whole: a grid search over the
   whole space in shuffled order (so drift of the card's clock is not tied
   to any parameter).  A sampled problem (the paper's protocol, its
   section V-A): ``N`` distinct random configs (default 10 000), which
   come in random order; a space that admits no more than ``N`` is
   measured whole.  A problem measured whole takes no ``--samples``;
2. publish the trials as a :class:`ResultTable`, ``exhaustive`` or
   ``sampled:N:0``;
3. print five results of the paper on that table: the speedup of the best
   config over the median one (Fig 4); the evaluations random search needs
   to reach 90 % and 99 % of the optimum (Fig 2); the proportion of
   centrality at p = 0.1 (Fig 3, on the subgraph the table induces when it
   is sampled); the permutation feature importance of every parameter
   (Fig 6); and the Table VIII row (cardinality, constrained, valid,
   reduced, reduce-constrained), whose valid count a sampled table
   estimates as the constrained count times its share of valid trials.

Runs on the card; ``--device cpu`` (with ``--small``) times the plain
PyTorch version on the host instead, which is what the tests do.

``--arch`` names the arch whose objectives make the table: by default the
device's own (measured), or an id of the Hopper cost model
(``core.costmodel.ARCH_NAMES``: ``h100sxm``, ``h100pcie``), whose table is
host arithmetic at the full shape in seconds and needs no card
(``--device cpu --arch h100sxm``); nothing is timed then.  With a model id
it also prints Fig 5, the portability matrix over the model's ids on the
same configs; ``--portability`` adds the table measured on the device over
those configs as one more arch (with the card: ``h100``), and with the
measured arch it adds the model's ids.

:func:`compare_tuners` runs every registered tuner over a whole table: the
paper's comparison of optimisation algorithms on the suite, with no config
timed again (``chip_smoke.py``'s ``tuners`` phase runs it on the card's
conv2d and pnpoly tables).

Port of the JAX package's ``benchmarks/fig2_convergence.py``,
``fig3_centrality.py``, ``fig4_speedup.py``, ``fig5_portability.py``,
``fig6_importance.py`` and ``table8_spacestats.py`` for one problem.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from .core.analysis import (centrality_curve, evals_to_reach,
                            feature_importance, important_params,
                            median_curve, portability_matrix, reduced_space,
                            reduced_stats, space_stats, speedup_over_median)
from .core.costmodel import ARCH_NAMES
from .core.problem import FunctionProblem
from .core.results import ResultsDB, ResultTable
from .core.tuners import TUNERS, GridSearch, run_tuner
from .kernels import BENCHMARKS, EXHAUSTIVE, SAMPLE_N, SAMPLED

#: the paper's random-search protocol for Fig 2 (benchmarks/fig2_convergence)
CONVERGENCE_BUDGET, CONVERGENCE_REPEATS = 1000, 100
#: Fig 3's sweep of p, and the p it reports
CENTRALITY_PS = np.linspace(0.0, 0.5, 11)
CENTRALITY_P = 0.1
#: Table VIII keeps the parameters with PFI at least this
PFI_THRESHOLD = 0.05
#: the tuner comparison: evaluations and seeds a tuner; SurrogateBO refits
#: its trees after every batch, work that grows with the square of its
#: budget, so it takes the cap the JAX package's tuner benchmark gives it
#: (``benchmarks/tuner_bench.py`` ``BUDGETS``) and three seeds
COMPARE_BUDGET, COMPARE_SEEDS = 200, (0, 1, 2, 3, 4)
COMPARE_CAPS = {"surrogate_bo": (128, (0, 1, 2))}
#: the shares of the table's best the comparison reports reaching
COMPARE_LEVELS = (0.90, 0.99)


def table8(prob, table: ResultTable, trials) -> dict:
    """Table VIII's cardinality, constrained and valid counts.  On an
    exhaustive table the valid count looks the trials up, so nothing is
    timed again; on a sampled one it is the constrained count times the
    sample's share of valid trials, marked ``exact: False``, as
    :func:`space_stats` estimates it."""
    sp = prob.space
    if table.protocol != "exhaustive":
        share = sum(t.ok for t in trials) / max(1, len(trials))
        constrained = sp.compiled().n_valid
        return {"problem": prob.name, "cardinality": sp.cardinality,
                "constrained": constrained,
                "valid": {table.arch: int(constrained * share)},
                "exact": False}
    measured = {sp.flat_index(t.config): t.objective if t.ok else math.inf
                for t in trials}
    lookup = FunctionProblem(sp, lambda c, a: measured[sp.flat_index(c)],
                             name=prob.name)
    return space_stats(lookup, archs=(table.arch,))


def analyse(prob, table: ResultTable, trials) -> dict:
    """The five results on ``table``, the table of ``trials``."""
    sp = prob.space
    curve = median_curve(table, budget=CONVERGENCE_BUDGET,
                         repeats=CONVERGENCE_REPEATS, seed=0)
    cent = centrality_curve(sp, table, ps=CENTRALITY_PS)
    at = int(np.argmin(np.abs(np.asarray(cent["p"]) - CENTRALITY_P)))
    imp = feature_importance(table, seed=0)
    importances = {table.arch: imp}

    row = table8(prob, table, trials)
    best = sp.decode(table.best()[0])
    row.update(reduced_stats(
        sp, reduced_space(sp, importances, best, threshold=PFI_THRESHOLD)))
    row["kept_params"] = important_params(importances, PFI_THRESHOLD)
    return {"speedup": speedup_over_median(table),
            "n90": evals_to_reach(curve, 0.90),
            "n99": evals_to_reach(curve, 0.99),
            "centrality": cent["proportion"][at], "centrality_curve": cent,
            "pfi": dict(zip(imp["params"], imp["pfi"])), "r2": imp["r2"],
            "pfi_sum": imp["pfi_sum"], "table8": row, "best_config": best}


def _evals_to(share: list[float], level: float) -> float:
    """1-based evaluations until ``share`` (the best so far as a share of
    the table's best) reaches ``level``; ``inf`` if it never does."""
    return next((i + 1 for i, v in enumerate(share) if v >= level),
                math.inf)


def compare_tuners(prob, table: ResultTable) -> dict:
    """Every tuner of ``TUNERS`` over ``table``, a whole table of ``prob``:
    each run answers a config with its objective in the table, so nothing
    is timed again.  Per tuner, over
    its seeds (:data:`COMPARE_SEEDS`, :data:`COMPARE_CAPS`): the median of
    the evaluations it took to reach each of :data:`COMPARE_LEVELS` of the
    table's best (``inf`` where the median seed never did within the
    budget) and the median share of the best it reached at the budget."""
    if table.protocol != "exhaustive":
        raise ValueError(f"the tuner comparison needs a whole table, not "
                         f"{table.protocol!r}")
    sp = prob.space
    objs = {sp.flat_index(sp.decode(c)): o
            for c, o in zip(table.configs, table.objectives)}
    best = min(o for o in objs.values() if math.isfinite(o))
    lookup = FunctionProblem(sp, lambda c, a: objs[sp.flat_index(c)],
                             name=prob.name)
    out = {}
    for name in TUNERS:
        budget, seeds = COMPARE_CAPS.get(name,
                                         (COMPARE_BUDGET, COMPARE_SEEDS))
        t0 = time.perf_counter()
        runs = []
        for seed in seeds:
            res = run_tuner(TUNERS[name](sp, seed=seed), lookup, budget,
                            arch=table.arch)
            share = [best / b for b in res.best_curve()]
            runs.append({"seed": seed, "evals": len(share),
                         "share": share[-1] if share else 0.0,
                         **{f"n{round(lv * 100)}": _evals_to(share, lv)
                            for lv in COMPARE_LEVELS}})
        row = {"budget": budget, "seeds": list(seeds),
               "share": float(np.median([r["share"] for r in runs])),
               "runs": runs, "seconds": time.perf_counter() - t0}
        for lv in COMPARE_LEVELS:
            key = f"n{round(lv * 100)}"
            row[key] = float(np.median([r[key] for r in runs]))
        out[name] = row
    return out


def print_comparison(name: str, comp: dict) -> None:
    """The comparison's table, one line a tuner."""
    print(f"tuners on {name}'s whole table (median over seeds; evaluations "
          f"to reach 90 % / 99 % of the best, share of the best at the "
          f"budget)")
    for tuner, r in comp.items():
        reach = " / ".join(
            f"{r[k]:g}" if math.isfinite(r[k]) else f">{r['budget']}"
            for k in (f"n{round(lv * 100)}" for lv in COMPARE_LEVELS))
        print(f"  {tuner:13s} budget {r['budget']:3d} x {len(r['seeds'])} "
              f"seeds: {reach:>11s}, {r['share']:.4f} at the budget "
              f"({r['seconds']:.1f} s)")


def fig5(prob, trials, tables: dict) -> dict:
    """Fig 5 over ``tables`` (arch -> table) plus, for each of the model's
    ids not among them, its table over the configs of ``trials``."""
    rows = [prob.space.flat_index(t.config) for t in trials]
    protocol = next(iter(tables.values())).protocol
    archs = [a for a in ARCH_NAMES if a not in tables]
    for a, col in zip(archs, prob.trials_for_rows_archs(rows, archs)
                      if archs else []):
        tables[a] = ResultTable.from_trials(prob, a, col, protocol)
    out = portability_matrix(tables)
    print(f"Fig 5  portability (row: whose optimum, column: deployed on; "
          f"{len(rows)} configs)")
    for a, row in zip(out["archs"], out["matrix"]):
        print(f"  {a:9s} " + " ".join(f"{v:.4f}" for v in row))
    return out


def main(problem: str = "flash_attention_h100", device=None,
         small: bool = False, results_dir=None,
         samples: int | None = None, arch: str | None = None,
         portability: bool = False) -> dict:
    """Build ``problem``'s table and print the five results; returns them
    with the table and the trials.  ``device`` defaults to ``"cuda"``;
    ``small`` takes the problem's small test shape; ``samples`` (default
    ``SAMPLE_N``) is the most configs a sampled problem takes: a space that
    admits more is sampled.  A problem in ``EXHAUSTIVE`` is always taken
    whole.  ``arch`` (default: the device's, measured) may be an id of the
    cost model; then, or with ``portability``, Fig 5 is printed too."""
    if problem not in EXHAUSTIVE + SAMPLED:
        raise ValueError(f"{problem!r} is neither measured whole nor "
                         f"sampled; the port measures {EXHAUSTIVE} whole and "
                         f"samples {SAMPLED}")
    if problem in EXHAUSTIVE and samples is not None:
        raise ValueError(f"{problem!r} is measured whole; samples applies "
                         f"to {SAMPLED} only")
    if samples is None and problem in SAMPLED:
        samples = SAMPLE_N
    cls = BENCHMARKS[problem]
    prob = cls(shape=cls.small_shape if small else None, device=device)
    arch = prob.arch if arch is None else arch
    model = prob.analytical(arch)          # raises for a foreign id
    n = prob.space.compiled().n_valid
    how = "the Hopper cost model" if model else "measured"
    print(f"problem: {prob.name} {prob.shape} on {prob.device} (arch "
          f"{arch}, {how})  |space| = {prob.space.cardinality:,}, {n} "
          f"admitted")

    t0 = time.perf_counter()
    if samples is not None and n > samples:
        # already in random order: the card's drift is tied to no parameter
        trials = prob.sampled(samples, seed=0, arch=arch)
        protocol = f"sampled:{samples}:0"
    elif model:
        trials = prob.exhaustive(arch)
        protocol = "exhaustive"
    else:
        trials = run_tuner(GridSearch(prob.space, seed=0), prob, budget=n,
                           arch=arch).trials
        protocol = "exhaustive"
    seconds = time.perf_counter() - t0
    invalid = sum(not t.ok for t in trials)
    table = ResultTable.from_trials(prob, arch, trials, protocol)
    if model:
        print(f"modelled {len(trials)} configs ({protocol}); {invalid} "
              f"cannot run")
    else:
        print(f"measured {len(trials)} configs ({protocol}) in "
              f"{seconds:.2f} s; {invalid} invalid")
    if results_dir is not None:
        ResultsDB(results_dir).put(table)

    t0 = time.perf_counter()
    out = analyse(prob, table, trials)
    analyse_s = time.perf_counter() - t0
    best_s = table.best()[1]
    print(f"Fig 4  speedup of the best config over the median: "
          f"{out['speedup']:.3f}x (best {best_s * 1e3:.4f} ms, "
          f"{out['best_config']})")
    print(f"Fig 2  random search reaches 90 % of the optimum after "
          f"{out['n90']} evaluations, 99 % after {out['n99']} (median of "
          f"{CONVERGENCE_REPEATS})")
    print(f"Fig 3  proportion of centrality at p = {CENTRALITY_P}: "
          f"{out['centrality']:.4f} ({out['centrality_curve']['n_minima']} "
          f"local minima)")
    print(f"Fig 6  PFI (R^2 {out['r2']:.3f}, sum {out['pfi_sum']:.3f}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["pfi"].items()))
    row = out["table8"]
    print(f"Table VIII  cardinality {row['cardinality']}, constrained "
          f"{row['constrained']}, valid {row['valid'][arch]}"
          f"{'' if row['exact'] else ' (estimated from the sample)'}, reduced "
          f"{row['reduced']}, reduce-constrained "
          f"{row['reduce_constrained']} (kept: "
          f"{', '.join(row['kept_params'])})")
    if not model:
        print(f"analyses took {analyse_s:.2f} s")
    matrix = None
    if model or portability:
        tables = {arch: table}
        if model and portability:
            cfgs = [t.config for t in trials]
            tables[prob.arch] = ResultTable.from_trials(
                prob, prob.arch, prob.evaluate_many(cfgs, prob.arch),
                protocol)
        matrix = fig5(prob, trials, tables)
    out.update(problem=prob, table=table, trials=trials, invalid=invalid,
               seconds=seconds, analyse_seconds=analyse_s, arch=arch,
               portability=matrix)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="flash_attention_h100",
                    choices=EXHAUSTIVE + SAMPLED)
    ap.add_argument("--samples", type=int, default=None,
                    help=f"most configs a sampled problem measures "
                         f"(default {SAMPLE_N}); not for a problem measured "
                         f"whole")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="measure the problem's small test shape")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--arch", default=None,
                    help=f"the arch of the table: the device's (measured, "
                         f"the default) or one of the cost model's "
                         f"{ARCH_NAMES}")
    ap.add_argument("--portability", action="store_true",
                    help="Fig 5 with the device's measured table and the "
                         "model's over the same configs")
    a = ap.parse_args(argv)
    main(problem=a.problem, device=a.device, small=a.small,
         results_dir=a.results_dir, samples=a.samples, arch=a.arch,
         portability=a.portability)


if __name__ == "__main__":
    _cli()
