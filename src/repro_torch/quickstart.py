"""Quickstart: tuning one benchmark kernel on the card, end to end.

    PYTHONPATH=src python -m repro_torch.quickstart [--problem NAME]
        [--budget N] [--sample N] [--arch ID]

1. pick a tunable problem: ``gemm_h100`` (4096^3 bf16, the default),
   ``nbody_h100`` (131 072 bodies, f32), ``pnpoly_h100`` (2 000 000 points
   against a 600-gon, f32), ``conv2d_h100`` (a 4096 x 4096 f32 image, a 15
   x 15 filter), ``hotspot_h100`` (600 sweeps of a 2048 x 2048 domain
   padded to 3248 x 3248, f32), ``dedisp_h100`` (1536 channels of 12 288
   samples, 2048 DMs, 4096 samples out, f32), ``expdist_h100`` (65 536 x
   65 536 points, f32) or ``flash_attention_h100`` (32 q heads, 8 kv
   heads, 4096 x 4096, d 128, causal, bf16),
2. run random search and a genetic algorithm against its measured
   objective: every config is timed on the card with CUDA events,
3. check the winning config's output against the torch oracle at the
   shape it was tuned at,
4. sample the space and print the paper's speedup-over-median statistic.

Runs on the card; ``--device cpu`` (with ``--small``) runs the plain
PyTorch version on the host instead, timed with the host clock, which is
what the tests do.  ``--arch`` with an id of the Hopper cost model
(``h100sxm``, ``h100pcie``) tunes against the model instead of the
device, host arithmetic that needs no card (``--device cpu``); step 3 is
then skipped, since nothing runs the kernel.  Port of the JAX package's
``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse

import torch

from .core.analysis.distribution import speedup_over_median
from .core.results import ResultsDB, ResultTable
from .core.tuners import GeneticAlgorithm, RandomSearch, run_tuner
from .kernels import BENCHMARKS

#: rel-L2 tolerances of the JAX package's kernel tests
#: (``tests/test_kernels.py`` ``TOLS``) by problem: (full-precision configs,
#: configs with any value ``"bf16"``).  pnpoly's integer output is exact.
TOLS = {"gemm_h100": (5e-3, 2e-2), "flash_attention_h100": (5e-3, 2e-2),
        "conv2d_h100": (5e-3, 3e-2), "nbody_h100": (1e-3, 8e-2),
        "pnpoly_h100": (0.0, 0.0), "hotspot_h100": (5e-3, 3e-2),
        "expdist_h100": (1e-3, 2e-2), "dedisp_h100": (1e-3, 2e-2)}


def tolerance(problem: str, config: dict) -> float:
    """The oracle tolerance of ``config`` of ``problem``: the low-precision
    one when any value of the config is ``"bf16"`` (an accumulator or a
    compute dtype), as ``tests/test_kernels.py`` chooses it."""
    return TOLS[problem][any(v == "bf16" for v in config.values())]


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(1e-12))


def main(problem: str = "gemm_h100", device=None, small: bool = False,
         budget: int = 60, sample: int = 64, results_dir=None,
         arch: str | None = None) -> dict:
    """Run the quickstart; returns what it measured.  ``device`` defaults to
    ``"cuda"``; ``small`` tunes the problem's small test shape instead of
    its full one; ``results_dir`` publishes the sampled table to a
    ResultsDB; ``arch`` (default: the device's, measured) may be an id of
    the cost model."""
    cls = BENCHMARKS[problem]
    prob = cls(shape=cls.small_shape if small else None, device=device)
    arch = prob.arch if arch is None else arch
    model = prob.analytical(arch)          # raises for a foreign id
    print(f"problem: {prob.name} {prob.shape} on {prob.device} "
          f"(arch {arch}{', the Hopper cost model' if model else ''})  "
          f"|space| = {prob.space.cardinality:,} "
          f"({len(prob.space.params)} params)")

    # -- 2. tune -------------------------------------------------------- #
    runs = {}
    how = "modelled" if model else "measured"
    for cls in (RandomSearch, GeneticAlgorithm):
        res = run_tuner(cls(prob.space, seed=0), prob, budget=budget,
                        arch=arch)
        runs[cls.__name__] = res
        b = res.best
        print(f"{cls.__name__:18s} best {how} "
              f"{b.objective * 1e3:8.4f} ms  config={b.config}")
    best = min((r.best for r in runs.values()), key=lambda t: t.objective)

    # -- 3. correctness of the winning config, at the shape it won at ---- #
    # (a config of the full space need not fit the small test shape: an
    # attention config with block_h 4 needs a GQA group of 4)
    err = None
    if not model:
        inputs = prob.make_inputs(seed=0, small=False)
        got = prob.run_kernel(best.config, inputs)
        want = prob.run_reference(best.config, inputs)
        err = rel_l2(got, want)
        tol = tolerance(prob.name, best.config)
        print(f"best config vs oracle rel_l2 = {err:.3e}  (tolerance "
              f"{tol:g})")
        if not err <= tol:
            raise RuntimeError(f"best config {best.config} misses the "
                               f"oracle: rel_l2 {err:.3e} > {tol:g}")

    # -- 4. landscape statistics ----------------------------------------- #
    trials = prob.sampled(sample, seed=1, arch=arch)
    table = ResultTable.from_trials(prob, arch, trials,
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
    ap.add_argument("--problem", default="gemm_h100", choices=BENCHMARKS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="tune the problem's small test shape")
    ap.add_argument("--budget", type=int, default=60)
    ap.add_argument("--sample", type=int, default=64)
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--arch", default=None,
                    help="the arch tuned for: the device's (measured, the "
                         "default) or an id of the Hopper cost model")
    a = ap.parse_args(argv)
    main(problem=a.problem, device=a.device, small=a.small, budget=a.budget,
         sample=a.sample, results_dir=a.results_dir, arch=a.arch)


if __name__ == "__main__":
    _cli()
