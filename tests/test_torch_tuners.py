"""The port's tuners and results database against the JAX package's: on the
same space and the same objective table, all eight tuners walk identical
trajectories, cold and warm-started, publish byte-identical tables, and
each package's ``ResultsDB`` reads the other's files.  Each port tuner's
row path walks its scalar path's trajectory."""

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
#: SurrogateBO refits its trees after every batch (work that grows with the
#: square of the budget), so its runs here take a smaller budget
BUDGETS = {"SurrogateBO": 60}
#: tuners whose runs here end at the stall guard, before their budget
STALLS = ("ParticleSwarm",)
TUNER_CLASSES = ("RandomSearch", "GridSearch", "LocalSearch",
                 "SimulatedAnnealing", "GeneticAlgorithm",
                 "DifferentialEvolution", "ParticleSwarm", "SurrogateBO")


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
        budget = BUDGETS.get(name, BUDGET)
        jr = jtuners.run_tuner(getattr(jtuners, name)(JP.space, seed=seed),
                               JP, budget, arch=ARCH)
        tr = ttuners.run_tuner(getattr(ttuners, name)(TP.space, seed=seed),
                               TP, budget, arch=ARCH)
        RUNS[key] = (jr, tr)
    return RUNS[key]


CASES = [(n, s) for n in TUNER_CLASSES for s in (0, 1, 2)]


@pytest.mark.parametrize("name,seed", CASES)
def test_identical_trajectories(name, seed):
    jr, tr = _run(name, seed)
    # the stall guard (50 x budget asks) ends a converged swarm, which
    # re-asks configs it has seen, before its budget
    budget = len(jr.trials) if name in STALLS else BUDGETS.get(name, BUDGET)
    assert len(tr.trials) == len(jr.trials) == budget
    assert len(tr.trials) >= 60
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
    assert list(ttuners.TUNERS) == list(jtuners.TUNERS) == [
        "random", "grid", "local", "annealing", "genetic", "diffevo", "pso",
        "surrogate_bo"]
    assert [c.__name__ for c in ttuners.TUNERS.values()] \
        == list(TUNER_CLASSES)
    assert all(ttuners.TUNERS[n].__name__ == jtuners.TUNERS[n].__name__
               for n in ttuners.TUNERS)
    arch = inspect.signature(ttuners.run_tuner).parameters["arch"].default
    assert arch == tproblem.DEFAULT_ARCH == "h100"


# --------------------------------------------------------------------- #
# the warm-start seam: the same warm rows, the same runs
# --------------------------------------------------------------------- #
def _warm_rows() -> list[int]:
    """The table's five best rows (what a surrogate would predict), one of
    them twice, a row the constraints exclude and one past the space: the
    repeat, the excluded row and the row past the space are dropped."""
    comp = TP.space.compiled()
    objs = np.array([TP.evaluate(TP.space.from_flat_index(int(r))).objective
                     for r in comp.valid_rows])
    top = [int(comp.valid_rows[i]) for i in np.argsort(objs)[:5]]
    invalid = int(np.flatnonzero(~comp.mask)[0])
    return [top[3], top[0], top[3], invalid, top[1], comp.n_total + 7,
            top[4], top[2]]


WARM = _warm_rows()
WARM_CASES = [(n, s) for n in TUNER_CLASSES for s in (0, 1, 2)]


@pytest.mark.parametrize("name,seed", WARM_CASES)
def test_warm_started_runs_are_the_references(name, seed):
    budget = min(BUDGETS.get(name, BUDGET), 80)
    jr = jtuners.run_tuner(getattr(jtuners, name)(JP.space, seed=seed), JP,
                           budget, arch=ARCH, warm_start=WARM)
    tt = getattr(ttuners, name)(TP.space, seed=seed)
    tr = ttuners.run_tuner(tt, TP, budget, arch=ARCH, warm_start=WARM)
    rows = [TP.space.flat_index(t.config) for t in tr.trials]
    assert rows == [JP.space.flat_index(t.config) for t in jr.trials]
    assert [t.objective for t in tr.trials] \
        == [t.objective for t in jr.trials]
    # the valid rows lead, deduplicated, in queue order
    kept = [WARM[i] for i in (0, 1, 4, 6, 7)]
    assert rows[:5] == kept and tt.warm_started
    jt = jresults.ResultTable.from_trials(JP, ARCH, jr.trials, "warm")
    assert tresults.ResultTable.from_trials(
        TP, ARCH, tr.trials, "warm").to_bytes() == jt.to_bytes()


@pytest.mark.parametrize("name", TUNER_CLASSES)
def test_no_warm_start_is_a_cold_run(name):
    """``warm_start=None`` and an empty or all-invalid queue leave the run
    draw for draw the cold one."""
    budget = min(BUDGETS.get(name, BUDGET), 60)
    cold = _run(name, 0)[1].trials[:budget]
    invalid = int(np.flatnonzero(~TP.space.compiled().mask)[0])
    for warm in (None, [], [invalid, -1]):
        t = getattr(ttuners, name)(TP.space, seed=0)
        res = ttuners.run_tuner(t, TP, budget, arch=ARCH, warm_start=warm)
        assert [x.config for x in res.trials] == [x.config for x in cold]
        assert not t.warm_started


# --------------------------------------------------------------------- #
# the row path == the scalar path, as tests/test_tuners.py holds the JAX
# package's
# --------------------------------------------------------------------- #
def _scalar_space(space):
    """A copy of ``space`` that refuses to compile: tuners built on it run
    their scalar paths (``_comp`` stays ``None``)."""
    s = tspace.SearchSpace(space.params, space.constraints, name=space.name)
    s.compile_eagerly = lambda *a, **k: None
    return s


def _constrained():
    params = [tspace.Param("a", (1, 2, 3, 4, 5)), tspace.Param("b", (1, 2, 3, 4)),
              tspace.Param("c", (0, 1, 2))]
    space = tspace.SearchSpace(params, [tspace.Constraint(
        "sum_odd", lambda c: (c["a"] + c["b"] + c["c"]) % 2 == 1,
        vec=lambda c: (c["a"] + c["b"] + c["c"]) % 2 == 1)], name="constr")
    return tproblem.FunctionProblem(
        space, lambda c, a: 1.0 + (c["a"] - 3) ** 2 + (c["b"] - 2) ** 2
        + c["c"], name="constr")


def _quad():
    space = tspace.SearchSpace(
        [tspace.Param(f"p{i}", tuple(range(5))) for i in range(3)],
        name="quad")
    return tproblem.FunctionProblem(
        space, lambda c, a: 1.0 + sum((c[f"p{i}"] - 2) ** 2
                                      for i in range(3)), name="quad")


def _traj(res):
    return [(tuple(sorted(t.config.items())), t.objective) for t in res.trials]


#: SurrogateBO's scalar path decodes and ranks its candidates config by
#: config, seconds a batch: its cases take fewer evaluations
SCALAR_BUDGETS = {"SurrogateBO": 26}


@pytest.mark.parametrize("name", TUNER_CLASSES)
def test_row_path_equals_scalar_path(name):
    cls = getattr(ttuners, name)
    budget = SCALAR_BUDGETS.get(name, 50)
    for make in (_constrained, _quad):
        for seed in (0, 3, 11):
            prob = make()
            t_row = cls(prob.space, seed=seed)
            assert t_row.index_native and t_row._comp is not None
            r_row = ttuners.run_tuner(t_row, prob, budget=budget)
            prob2 = make()
            prob2.space = _scalar_space(prob2.space)
            t_sc = cls(prob2.space, seed=seed)
            assert not t_sc.index_native and t_sc._comp is None
            r_sc = ttuners.run_tuner(t_sc, prob2, budget=budget)
            assert _traj(r_row) == _traj(r_sc), (name, seed)
            assert t_row.rng.random() == t_sc.rng.random()


@pytest.mark.parametrize("name", TUNER_CLASSES)
def test_warm_row_path_equals_scalar_path(name):
    """With a warm queue (a duplicate and an invalid row in it) the row
    and scalar paths still walk one trajectory."""
    cls = getattr(ttuners, name)
    prob = _constrained()
    comp = prob.space.compiled()
    good = [int(r) for r in comp.valid_rows[[5, 0, 9]]]
    warm = [good[0], good[1], good[0], int(np.flatnonzero(~comp.mask)[0]),
            good[2]]
    budget = SCALAR_BUDGETS.get(name, 40)
    r_row = ttuners.run_tuner(cls(prob.space, seed=4), prob, budget=budget,
                              warm_start=warm)
    prob2 = _constrained()
    prob2.space = _scalar_space(prob2.space)
    r_sc = ttuners.run_tuner(cls(prob2.space, seed=4), prob2, budget=budget,
                             warm_start=warm)
    assert _traj(r_row) == _traj(r_sc)
    assert [prob.space.flat_index(t.config) for t in r_row.trials[:3]] \
        == [good[0], good[1], good[2]]


# --------------------------------------------------------------------- #
# chip_smoke.py's tuners phase, rehearsed on the host
# --------------------------------------------------------------------- #
def test_chip_smoke_tuners_phase_on_the_host(monkeypatch, capsys):
    """The phase's checks at GEMM's small shape on the CPU, each call of a
    measured config counted as a launch (the card's wrapper counts its
    own), and the comparison over a cost-model table: every check passes,
    and a launch miscounted by one fails the run."""
    import importlib.util
    from pathlib import Path

    import torch
    from repro_torch import landscape
    from repro_torch.kernels.matmul import ops
    from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem
    from repro_torch.kernels.pnpoly.space import PnpolyProblem

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(landscape, "COMPARE_BUDGET", 30)
    monkeypatch.setattr(landscape, "COMPARE_SEEDS", (0, 1))
    monkeypatch.setattr(landscape, "COMPARE_CAPS",
                        {"surrogate_bo": (20, (0,))})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gemm = GemmProblem(shape=SMALL_SHAPE, device="cpu", repeats=2,
                           warmup=1)
        build = gemm.make_runner

        def counted(cfg, extra=[0]):
            fn = build(cfg)

            def call():
                ops.gemm.launches += 1 + extra[0]
                extra[0] = 0
                return fn()
            return call
        monkeypatch.setattr(gemm, "build", counted)
        pn = PnpolyProblem(shape=PnpolyProblem.small_shape, device="cpu")
        table = tresults.ResultTable.from_trials(
            pn, "h100sxm", pn.exhaustive("h100sxm"), "exhaustive")
        winners = []
        failures: list[str] = []
        out = smoke.tuners_check(gemm, winners.append,
                                 {"pnpoly": (pn, table)}, failures)
        assert failures == []
        assert list(out["live"]) == list(smoke.LIVE_TUNERS)
        assert len(winners) == len(smoke.LIVE_TUNERS)
        assert out["launches"] == 5 * smoke.LIVE_BUDGET * 3
        assert all(r["replay_same"] and r["configs"] == smoke.LIVE_BUDGET
                   for r in out["live"].values())
        comp = out["compare"]["pnpoly"]["tuners"]
        assert list(comp) == list(ttuners.TUNERS)
        assert "tuners on pnpoly_h100's whole table" in capsys.readouterr().out
        # one launch too many in a config: the count check fails the run
        counted.__defaults__[0][0] = 1
        smoke.tuners_check(gemm, winners.append, {}, failures)
        assert len(failures) == 1 and "gemm launches" in failures[0]
    finally:
        torch.set_num_threads(n)
