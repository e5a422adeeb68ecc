"""Quickstart: GEMM tuning on the card, end to end.

    PYTHONPATH=src python -m repro_torch.quickstart [--budget N] [--sample N]

1. pick the tunable GEMM problem (4096^3 bf16, the ``gemm_h100`` space),
2. run random search and a genetic algorithm against its measured
   objective: every config is timed on the card with CUDA events,
3. check the winning config's output against the torch oracle,
4. sample the space and print the paper's speedup-over-median statistic.

Runs on the card; ``--device cpu`` (with ``--small``) runs the plain
PyTorch version on the host instead, timed with the host clock, which is
what the tests do.  Port of the JAX package's ``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse

import torch

from .core.analysis.distribution import speedup_over_median
from .core.results import ResultsDB, ResultTable
from .core.tuners import GeneticAlgorithm, RandomSearch, run_tuner
from .kernels.matmul.space import SMALL_SHAPE, GemmProblem

#: rel-L2 tolerances of the JAX package's kernel tests (``TOLS["gemm"]``):
#: an f32 accumulator, a bf16 one
TOLS = {"f32": 5e-3, "bf16": 2e-2}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(1e-12))


def main(device=None, small: bool = False, budget: int = 60,
         sample: int = 64, results_dir=None) -> dict:
    """Run the quickstart; returns what it measured.  ``device`` defaults to
    ``"cuda"``; ``small`` tunes the 256x256x512 test shape instead of
    4096^3; ``results_dir`` publishes the sampled table to a ResultsDB."""
    prob = GemmProblem(shape=SMALL_SHAPE if small else None, device=device)
    print(f"problem: {prob.name} {prob.shape} on {prob.device} "
          f"(arch {prob.arch})  |space| = {prob.space.cardinality:,} "
          f"({len(prob.space.params)} params)")

    # -- 2. tune -------------------------------------------------------- #
    runs = {}
    for cls in (RandomSearch, GeneticAlgorithm):
        res = run_tuner(cls(prob.space, seed=0), prob, budget=budget,
                        arch=prob.arch)
        runs[cls.__name__] = res
        b = res.best
        print(f"{cls.__name__:18s} best measured "
              f"{b.objective * 1e3:8.4f} ms  config={b.config}")
    best = min((r.best for r in runs.values()), key=lambda t: t.objective)

    # -- 3. correctness of the winning config --------------------------- #
    inputs = prob.make_inputs(seed=0, small=True)
    got = prob.run_kernel(best.config, inputs)
    want = prob.run_reference(best.config, inputs)
    err = rel_l2(got, want)
    tol = TOLS[best.config["acc_dtype"]]
    print(f"best config vs oracle rel_l2 = {err:.3e}  (tolerance {tol:g})")
    if not err <= tol:
        raise RuntimeError(f"best config {best.config} misses the oracle: "
                             f"rel_l2 {err:.3e} > {tol:g}")

    # -- 4. landscape statistics ----------------------------------------- #
    trials = prob.sampled(sample, seed=1, arch=prob.arch)
    table = ResultTable.from_trials(prob, prob.arch, trials,
                                    f"sampled_{sample}_1")
    speedup = speedup_over_median(table)
    print(f"speedup over median config: {speedup:.2f}x over {len(table)} "
          f"sampled configs (the paper's Fig 4 statistic)")
    if results_dir is not None:
        ResultsDB(results_dir).put(table)
    return {"problem": prob, "runs": runs, "best": best, "rel_l2": err,
            "table": table, "sampled": trials, "speedup": speedup}


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="tune the 256x256x512 test shape")
    ap.add_argument("--budget", type=int, default=60)
    ap.add_argument("--sample", type=int, default=64)
    ap.add_argument("--results-dir", default=None)
    a = ap.parse_args(argv)
    main(device=a.device, small=a.small, budget=a.budget, sample=a.sample,
         results_dir=a.results_dir)


if __name__ == "__main__":
    _cli()
