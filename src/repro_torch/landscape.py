"""The paper's landscape analyses on a table the card measured whole.

    PYTHONPATH=src python -m repro_torch.landscape [--problem NAME] [--small]

1. time every config of the problem's space on the card: a grid search over
   the whole space in shuffled order (so drift of the card's clock is not
   tied to any parameter), each config measured as the tuners measure it;
2. publish the trials as an exhaustive :class:`ResultTable`;
3. print five results of the paper on that table: the speedup of the best
   config over the median one (Fig 4); the evaluations random search needs
   to reach 90 % and 99 % of the optimum (Fig 2); the proportion of
   centrality at p = 0.1 (Fig 3); the permutation feature importance of
   every parameter (Fig 6); and the Table VIII row (cardinality,
   constrained, valid, reduced, reduce-constrained).

Runs on the card; ``--device cpu`` (with ``--small``) times the plain
PyTorch version on the host instead, which is what the tests do.  Port of
the JAX package's ``benchmarks/fig2_convergence.py``, ``fig3_centrality.py``,
``fig4_speedup.py``, ``fig6_importance.py`` and ``table8_spacestats.py`` for
one problem and one arch.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from .core.analysis import (centrality_curve, evals_to_reach,
                            feature_importance, important_params,
                            median_curve, reduced_space, reduced_stats,
                            space_stats, speedup_over_median)
from .core.problem import FunctionProblem
from .core.results import ResultsDB, ResultTable
from .core.tuners import GridSearch, run_tuner
from .kernels import BENCHMARKS, EXHAUSTIVE

#: the paper's random-search protocol for Fig 2 (benchmarks/fig2_convergence)
CONVERGENCE_BUDGET, CONVERGENCE_REPEATS = 1000, 100
#: Fig 3's sweep of p, and the p it reports
CENTRALITY_PS = np.linspace(0.0, 0.5, 11)
CENTRALITY_P = 0.1
#: Table VIII keeps the parameters with PFI at least this
PFI_THRESHOLD = 0.05


def analyse(prob, table: ResultTable, trials) -> dict:
    """The five results on ``table``, the exhaustive table of ``trials``.
    Table VIII's valid count looks the trials up, so nothing is timed
    again."""
    sp = prob.space
    curve = median_curve(table, budget=CONVERGENCE_BUDGET,
                         repeats=CONVERGENCE_REPEATS, seed=0)
    cent = centrality_curve(sp, table, ps=CENTRALITY_PS)
    at = int(np.argmin(np.abs(np.asarray(cent["p"]) - CENTRALITY_P)))
    imp = feature_importance(table, seed=0)
    importances = {table.arch: imp}

    measured = {sp.flat_index(t.config): t.objective if t.ok else math.inf
                for t in trials}
    lookup = FunctionProblem(sp, lambda c, a: measured[sp.flat_index(c)],
                             name=prob.name)
    row = space_stats(lookup, archs=(table.arch,))
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


def main(problem: str = "flash_attention_h100", device=None,
         small: bool = False, results_dir=None) -> dict:
    """Measure ``problem``'s whole space and print the five results;
    returns them with the table and the trials.  ``device`` defaults to
    ``"cuda"``; ``small`` measures the problem's small test shape."""
    if problem not in EXHAUSTIVE:
        raise ValueError(f"{problem!r} is not measured whole; the port "
                         f"measures {EXHAUSTIVE}")
    cls = BENCHMARKS[problem]
    prob = cls(shape=cls.small_shape if small else None, device=device)
    n = prob.space.compiled().n_valid
    print(f"problem: {prob.name} {prob.shape} on {prob.device} (arch "
          f"{prob.arch})  |space| = {prob.space.cardinality:,}, {n} admitted")

    t0 = time.perf_counter()
    res = run_tuner(GridSearch(prob.space, seed=0), prob, budget=n,
                    arch=prob.arch)
    seconds = time.perf_counter() - t0
    trials = res.trials
    invalid = sum(not t.ok for t in trials)
    table = ResultTable.from_trials(prob, prob.arch, trials, "exhaustive")
    print(f"measured {len(trials)} configs in {seconds:.2f} s; "
          f"{invalid} invalid")
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
          f"{row['constrained']}, valid {row['valid'][prob.arch]}, reduced "
          f"{row['reduced']}, reduce-constrained "
          f"{row['reduce_constrained']} (kept: "
          f"{', '.join(row['kept_params'])})")
    print(f"analyses took {analyse_s:.2f} s")
    out.update(problem=prob, table=table, trials=trials, invalid=invalid,
               seconds=seconds, analyse_seconds=analyse_s)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="flash_attention_h100",
                    choices=EXHAUSTIVE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="measure the problem's small test shape")
    ap.add_argument("--results-dir", default=None)
    a = ap.parse_args(argv)
    main(problem=a.problem, device=a.device, small=a.small,
         results_dir=a.results_dir)


if __name__ == "__main__":
    _cli()
