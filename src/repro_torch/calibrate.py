"""Fit the Hopper cost model's global constants to the card's measured rows.

    PYTHONPATH=src python -m repro_torch.calibrate [--write]
    PYTHONPATH=src python -m repro_torch.calibrate --rows-from RUN.json \\
        --run "NAME" [--write]

The rows (``core/h100_rows.json``) are, per problem at its default shape,
at most :data:`MAX_ROWS` flat row indices and their measured median
seconds: a seeded sample of the table each path of ``chip_smoke.py
--json`` measured (GEMM's: the distinct configs its tuners and sample
timed), with the chip run that made them and its ``nvidia-smi`` line.
``--rows-from`` rebuilds that file from such a run's JSON.

The fit sets the eight constants of :class:`~repro_torch.core.costmodel.Fit`
(achieved fractions of the peak rates, L2's rate as a multiple of HBM's,
the launch cost, the wait at a synchronised step and the overlap weight),
shared by all eight kernels: no per-kernel or per-config constant.  It is least squares on log seconds,
each problem weighted equally, from a fixed start, so a rerun on the same
rows gives the same constants.  ``--write`` puts them into
``core/costmodel.py`` as the ``FIT`` literal.  It prints, per problem,
Spearman's rho between the model and the rows, and the model over the
measurement at the median row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
from pathlib import Path

import numpy as np

from .core import costmodel
from .core.costmodel import FIT, GPU_GENERATIONS, Fit, estimate_seconds_batch

ROWS_PATH = Path(__file__).resolve().parent / "core" / "h100_rows.json"
#: rows kept per problem at most, and the seed of their sample
MAX_ROWS, SEED = 256, 0
#: the arch id the rows were measured as (the model's row of the card)
FIT_ARCH = "h100sxm"
#: the ``chip_smoke.py --json`` keys of each problem's table
RUN_KEYS = {"gemm_h100": "trials", "flash_attention_h100": "flash_attention",
            "nbody_h100": "nbody", "pnpoly_h100": "pnpoly",
            "conv2d_h100": "conv2d", "hotspot_h100": "hotspot",
            "expdist_h100": "expdist", "dedisp_h100": "dedisp"}


def spearman(a, b) -> float:
    """Spearman's rank correlation of two equal-length sequences (ties
    take their mean rank)."""
    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x))
        r[order] = np.arange(len(x), dtype=np.float64)
        for v in np.unique(x):          # mean rank of ties
            tie = x == v
            if tie.sum() > 1:
                r[tie] = r[tie].mean()
        return r
    ra, rb = ranks(a), ranks(b)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    den = math.sqrt(float((ra * ra).sum() * (rb * rb).sum()))
    return float((ra * rb).sum() / den) if den else math.nan


def problem(name: str):
    """``name``'s problem at its default shape, on the host (the model
    needs no card)."""
    from .kernels import BENCHMARKS
    return BENCHMARKS[name](device="cpu")


def run_table(run: dict, name: str) -> list[tuple[dict, float]]:
    """(config, median seconds) of every distinct config ``name``'s path
    measured in a ``chip_smoke.py --json`` record."""
    key = RUN_KEYS[name]
    if key == "trials":
        seen = {json.dumps(t["config"], sort_keys=True): t["info"]["median_s"]
                for t in run["trials"] if "median_s" in t["info"]}
        return [(json.loads(c), s) for c, s in seen.items()]
    return [(r["config"], r["seconds"]) for r in run[key]["table"]
            if r["seconds"] is not None and math.isfinite(r["seconds"])]


def rows_from_run(run: dict, source: str) -> dict:
    """The rows file's content from a ``chip_smoke.py --json`` record."""
    out = {"source": source, "nvidia_smi": run["device"]["nvidia_smi"],
           "max_rows": MAX_ROWS, "seed": SEED, "problems": {}}
    for name in RUN_KEYS:
        prob = problem(name)
        table = run_table(run, name)
        rng = np.random.default_rng(SEED)
        pick = sorted(rng.choice(len(table), min(MAX_ROWS, len(table)),
                                 replace=False).tolist())
        rows = sorted((prob.space.flat_index(table[i][0]), table[i][1])
                      for i in pick)
        out["problems"][name] = [[int(r), float(s)] for r, s in rows]
    return out


def load_rows(path: Path = ROWS_PATH) -> dict:
    return json.loads(Path(path).read_text())


def with_fit(arch: str, fit: Fit) -> costmodel.GpuGeneration:
    return dataclasses.replace(GPU_GENERATIONS[arch], fit=fit)


def model_columns(rows: dict) -> dict:
    """Per problem: its feature batch on its rows and their log seconds."""
    out = {}
    for name, pairs in rows["problems"].items():
        prob = problem(name)
        r = np.array([p[0] for p in pairs], dtype=np.int64)
        fb = prob.feature_columns(prob.space.compiled().value_columns(r),
                                  FIT_ARCH)
        out[name] = (fb, np.log(np.array([p[1] for p in pairs])))
    return out


def fit(rows: dict) -> Fit:
    """Least squares on log seconds, each problem weighted equally, over
    the logs of the eight constants, from :data:`START`."""
    from scipy.optimize import least_squares
    cols = model_columns(rows)

    def residuals(theta):
        gen = with_fit(FIT_ARCH, Fit(*np.exp(theta)))
        res = [(np.log(estimate_seconds_batch(fb, gen)) - y)
               / math.sqrt(len(y)) for fb, y in cols.values()]
        return np.concatenate(res)

    lo, hi = np.log(np.array(BOUNDS, dtype=np.float64).T)
    sol = least_squares(residuals, np.log(START), bounds=(lo, hi),
                        method="trf", x_scale=1.0, xtol=1e-15, ftol=1e-15,
                        gtol=1e-15, max_nfev=20000)
    return Fit(*(float(v) for v in np.exp(sol.x)))


#: where the fit starts: half the public figures' rates, a 2.5x L2, 5 us a
#: launch, 1 us a step, an overlap weight of 1
START = (0.5, 0.5, 0.5, 0.5, 2.5, 5e-6, 1e-6, 1.0)
#: the range each constant may take: a fraction of a peak rate at most 1,
#: L2 between 1x and 10x HBM's rate, a launch between 1 and 10 us, a step
#: between 10 ns and 100 us
BOUNDS = ((0.05, 1.0), (0.05, 1.0), (0.05, 1.0), (0.05, 1.0),
          (1.0, 10.0), (1e-6, 1e-5), (1e-8, 1e-4), (1e-4, 100.0))


def report(rows: dict, fit_: Fit = FIT) -> dict:
    """Per problem: Spearman's rho of the model against the rows, and the
    model over the measurement at the row of median seconds."""
    gen = with_fit(FIT_ARCH, fit_)
    out = {}
    for name, (fb, y) in model_columns(rows).items():
        t = np.broadcast_to(estimate_seconds_batch(fb, gen), y.shape)
        mid = int(np.argsort(y)[len(y) // 2])
        out[name] = {"rho": spearman(t, y),
                     "ratio_at_median": float(t[mid] / math.exp(y[mid]))}
    return out


def write_fit(fit_: Fit, path: Path | None = None) -> None:
    """Rewrite the ``FIT`` literal of ``core/costmodel.py``."""
    path = Path(costmodel.__file__) if path is None else path
    text = path.read_text()
    args = ", ".join(f"{k}={v!r}"
                     for k, v in dataclasses.asdict(fit_).items())
    new = re.sub(r"FIT = Fit\([^)]*\)", lambda _: _wrap(f"FIT = Fit({args})"),
                 text, count=1)
    path.write_text(new)


def _wrap(line: str, width: int = 79) -> str:
    out, cur = [], ""
    for part in line.split(", "):
        piece = part if not cur else ", " + part
        if len(cur) + len(piece) > width - 1:
            out.append(cur + ",")
            cur = "          " + part
        else:
            cur += piece
    return "\n".join(out + [cur])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows-from", default=None,
                    help="rebuild core/h100_rows.json from this chip_smoke.py "
                         "--json record first")
    ap.add_argument("--run", default="",
                    help="with --rows-from (required there): the chip run "
                         "that made it, as the rows file records it")
    ap.add_argument("--write", action="store_true",
                    help="write the fitted constants into core/costmodel.py")
    a = ap.parse_args(argv)
    if a.rows_from and not a.run:
        ap.error("--rows-from needs --run, the chip run that made it")
    if a.rows_from:
        rows = rows_from_run(json.loads(Path(a.rows_from).read_text()),
                             a.run)
        ROWS_PATH.write_text(json.dumps(rows, indent=0) + "\n")
    rows = load_rows()
    fitted = fit(rows)
    print(f"rows: {rows['source']} ({rows['nvidia_smi']})")
    print("fitted: " + ", ".join(
        f"{k}={v!r}" for k, v in dataclasses.asdict(fitted).items()))
    rep = report(rows, fitted)
    for name, r in rep.items():
        print(f"  {name:22s} rho {r['rho']:.4f}  model/measured at the "
              f"median row {r['ratio_at_median']:.3f}")
    print("rho on its rows: " + ", ".join(f"{name} {r['rho']:.4f}"
                                          for name, r in rep.items()))
    if a.write:
        write_fit(fitted)
        print(f"wrote FIT into {costmodel.__file__}")
    return {"fit": fitted, "rows": rows}


if __name__ == "__main__":
    main()
