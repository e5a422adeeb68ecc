"""The port's tuners and results database against the JAX package's: on the
same space and the same objective table, random search and the genetic
algorithm walk identical trajectories, publish byte-identical tables, and
each package's ``ResultsDB`` reads the other's files."""

import inspect
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import problem as jproblem  # noqa: E402
from repro.core import results as jresults  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import tuners as jtuners  # noqa: E402
from repro.kernels.matmul.space import GemmProblem as JaxGemm  # noqa: E402
from repro_torch.core import problem as tproblem  # noqa: E402
from repro_torch.core import results as tresults  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import tuners as ttuners  # noqa: E402

ARCH = "v5e"
BUDGET = 150


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


def _setup():
    """The reference gemm space in both packages, and its v5e cost-model
    objectives as one numpy table indexed by flat row."""
    jprob = JaxGemm()
    comp = jprob.space.compiled()
    table = np.full(comp.n_total, math.inf)
    table[comp.valid_rows] = jprob.objectives_for_rows(comp.valid_rows, ARCH)
    jsp = rebuild(jprob.space, jspace)
    tsp = rebuild(jprob.space, tspace)
    jp = jproblem.FunctionProblem(
        jsp, lambda c, a: table[jsp.flat_index(c)], name="gemm")
    tp = tproblem.FunctionProblem(
        tsp, lambda c, a: table[tsp.flat_index(c)], name="gemm")
    return jp, tp


JP, TP = _setup()
RUNS: dict = {}


def _run(name: str, seed: int):
    key = (name, seed)
    if key not in RUNS:
        jr = jtuners.run_tuner(getattr(jtuners, name)(JP.space, seed=seed),
                               JP, BUDGET, arch=ARCH)
        tr = ttuners.run_tuner(getattr(ttuners, name)(TP.space, seed=seed),
                               TP, BUDGET, arch=ARCH)
        RUNS[key] = (jr, tr)
    return RUNS[key]


CASES = [(n, s) for n in ("GeneticAlgorithm", "RandomSearch")
         for s in (0, 1, 2)]


@pytest.mark.parametrize("name,seed", CASES)
def test_identical_trajectories(name, seed):
    jr, tr = _run(name, seed)
    assert len(tr.trials) == len(jr.trials) == BUDGET
    assert [JP.space.flat_index(t.config) for t in jr.trials] \
        == [TP.space.flat_index(t.config) for t in tr.trials]
    assert [t.objective for t in jr.trials] == [t.objective for t in tr.trials]
    assert tr.best_curve() == jr.best_curve()


@pytest.mark.parametrize("name,seed", CASES)
def test_identical_tables_across_packages(name, seed, tmp_path):
    jr, tr = _run(name, seed)
    proto = f"trace_{name}_{seed}"
    jt = jresults.ResultTable.from_trials(JP, ARCH, jr.trials, proto)
    tt = tresults.ResultTable.from_trials(TP, ARCH, tr.trials, proto)
    assert jt.to_bytes() == tt.to_bytes()
    jdb = jresults.ResultsDB(tmp_path / "jax")
    tdb = tresults.ResultsDB(tmp_path / "torch")
    jdb.put(jt)
    tdb.put(tt)
    # each package reads the file the other wrote
    assert tresults.ResultsDB(tmp_path / "jax").get("gemm", ARCH, proto) == tt
    assert jresults.ResultsDB(tmp_path / "torch").get("gemm", ARCH, proto) == jt


def test_port_registry_holds_the_ported_tuners():
    assert set(ttuners.TUNERS) == {ttuners.RandomSearch.name,
                                   ttuners.GridSearch.name,
                                   ttuners.GeneticAlgorithm.name}
    assert all(ttuners.TUNERS[n].__name__ == jtuners.TUNERS[n].__name__
               for n in ttuners.TUNERS)
    arch = inspect.signature(ttuners.run_tuner).parameters["arch"].default
    assert arch == tproblem.DEFAULT_ARCH == "h100"
