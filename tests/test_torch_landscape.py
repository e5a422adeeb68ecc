"""The port's copies of the landscape analyses and of grid search against the
JAX package's: the same ``ResultTable``, loaded into both packages, gives
identical numbers for Fig 2 (convergence), Fig 3 (centrality), Fig 6 (PFI)
and Table VIII (space accounting), and grid search walks the same rows.
Two tables: a seeded synthetic one over ``flash_attention_h100``'s space,
and the reference's own attention space under its v5e cost model.  Then
``repro_torch.landscape`` end to end on the host at the small shape."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import analysis as janalysis  # noqa: E402
from repro.core import problem as jproblem  # noqa: E402
from repro.core import results as jresults  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import tuners as jtuners  # noqa: E402
from repro.kernels.attention.space import AttentionProblem as JaxAttention  # noqa: E402
from repro_torch import landscape  # noqa: E402
from repro_torch.core import analysis as tanalysis  # noqa: E402
from repro_torch.core import problem as tproblem  # noqa: E402
from repro_torch.core import results as tresults  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import tuners as ttuners  # noqa: E402
from repro_torch.kernels.attention.space import AttentionProblem  # noqa: E402

ARCH = "v5e"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores, which slowed these
    small CPU ops by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


def _synthetic():
    """Log-normal times on the valid rows of the port's space, a few of them
    invalid (inf)."""
    sp = AttentionProblem(device="cpu").space
    comp = sp.compiled()
    rng = np.random.default_rng(11)
    obj = np.exp(rng.normal(-7.0, 0.5, comp.n_valid))
    obj[rng.choice(comp.n_valid, 5, replace=False)] = math.inf
    table = tresults.ResultTable(
        problem=sp.name, arch=ARCH, param_names=sp.param_names,
        configs=[tuple(c) for c in comp.codes_for(sp, comp.valid_rows)
                 .tolist()],
        objectives=obj.tolist(), protocol="exhaustive")
    return sp, table


def _reference():
    prob = JaxAttention()
    trials = prob.exhaustive(ARCH)
    return prob.space, jresults.ResultTable.from_trials(prob, ARCH, trials,
                                                        "exhaustive")


def _load(name):
    """(jax space, port space, jax table, port table): one table's bytes
    loaded into each package."""
    sp, table = _synthetic() if name == "synthetic" else _reference()
    raw = table.to_bytes()
    return (rebuild(sp, jspace), rebuild(sp, tspace),
            jresults.ResultTable.from_bytes(raw),
            tresults.ResultTable.from_bytes(raw))


CASES = {name: _load(name) for name in ("synthetic", "reference")}


@pytest.fixture(params=list(CASES))
def case(request):
    return CASES[request.param]


def test_convergence(case):
    _, _, jt, tt = case
    jc = janalysis.median_curve(jt, budget=1000, repeats=100, seed=0)
    tc = tanalysis.median_curve(tt, budget=1000, repeats=100, seed=0)
    assert np.array_equal(jc, tc)
    for level in (0.9, 0.99):
        assert janalysis.evals_to_reach(jc, level) \
            == tanalysis.evals_to_reach(tc, level) > 0


def test_centrality(case):
    js, ts, jt, tt = case
    ps = np.linspace(0.0, 0.5, 11)
    want = janalysis.centrality_curve(js, jt, ps=ps)
    assert tanalysis.centrality_curve(ts, tt, ps=ps) == want
    assert want["n_minima"] > 0
    # the port's vectorised FFG against its own per-config oracle
    fast, slow = tanalysis.build_ffg(ts, tt), tanalysis.build_ffg_reference(ts, tt)
    for f in ("src", "dst", "fitness", "minima"):
        assert np.array_equal(getattr(fast, f), getattr(slow, f))


def test_feature_importance(case):
    _, _, jt, tt = case
    want = janalysis.feature_importance(jt, seed=0)
    assert tanalysis.feature_importance(tt, seed=0) == want
    assert want["params"] == list(tt.param_names)


def _lookup(mod, space, table):
    by_row = {space.flat_index(space.decode(c)): o
              for c, o in zip(table.configs, table.objectives)}
    return mod.FunctionProblem(
        space, lambda c, a: by_row.get(space.flat_index(c), math.inf),
        name=table.problem)


def test_space_stats_and_reduction(case):
    js, ts, jt, tt = case
    jrow = janalysis.space_stats(_lookup(jproblem, js, jt), archs=(ARCH,))
    trow = tanalysis.space_stats(_lookup(tproblem, ts, tt), archs=(ARCH,))
    assert trow == jrow
    imps = {ARCH: janalysis.feature_importance(jt, seed=0)}
    best = js.decode(jt.best()[0])
    jred = janalysis.reduced_space(js, imps, best)
    tred = tanalysis.reduced_space(ts, imps, best)
    assert tred.param_names == jred.param_names
    assert tanalysis.reduced_stats(ts, tred) \
        == janalysis.reduced_stats(js, jred)
    assert tanalysis.important_params(imps) == janalysis.important_params(imps)


def test_space_stats_default_arch_is_the_ports():
    _, ts, _, tt = CASES["synthetic"]
    row = tanalysis.space_stats(_lookup(tproblem, ts, tt))
    assert list(row["valid"]) == [tproblem.DEFAULT_ARCH]


@pytest.mark.parametrize("seed,shuffle", [(0, True), (3, True), (0, False)])
def test_grid_search_walks_the_same_rows(case, seed, shuffle):
    js, ts, jt, tt = case
    n = len(jt.configs) + 5               # past the end of the grid too
    jr = jtuners.run_tuner(jtuners.GridSearch(js, seed=seed, shuffle=shuffle),
                           _lookup(jproblem, js, jt), n, arch=ARCH)
    tr = ttuners.run_tuner(ttuners.GridSearch(ts, seed=seed, shuffle=shuffle),
                           _lookup(tproblem, ts, tt), n, arch=ARCH)
    assert [js.flat_index(t.config) for t in jr.trials] \
        == [ts.flat_index(t.config) for t in tr.trials]
    assert [t.objective for t in jr.trials] == [t.objective for t in tr.trials]


def test_landscape_on_the_host(tmp_path, capsys):
    out = landscape.main(device="cpu", small=True, results_dir=tmp_path)
    prob, table = out["problem"], out["table"]
    n = prob.space.compiled().n_valid
    assert prob.arch == "cpu" and len(table) == n and out["invalid"] == 0
    assert sorted(prob.space.flat_index(t.config) for t in out["trials"]) \
        == prob.space.compiled().valid_rows.tolist()
    assert out["speedup"] >= 1.0
    assert 1 <= out["n90"] <= out["n99"] <= n
    assert 0.0 <= out["centrality"] <= 1.0
    assert list(out["pfi"]) == list(prob.space.param_names)
    row = out["table8"]
    assert row["cardinality"] == prob.space.cardinality
    assert row["constrained"] == row["valid"]["cpu"] == n
    assert row["reduce_constrained"] <= row["reduced"]
    # the published table loads in the JAX package
    back = jresults.ResultsDB(tmp_path).get(prob.name, "cpu", "exhaustive")
    assert back.objectives == table.objectives
    assert "Table VIII" in capsys.readouterr().out


def test_landscape_refuses_a_problem_it_does_not_measure_whole():
    with pytest.raises(ValueError, match="measured whole"):
        landscape.main(problem="gemm_h100", device="cpu")


def test_landscape_takes_no_sample_of_a_problem_it_measures_whole():
    """``samples`` belongs to the sampled protocol: a problem in
    ``EXHAUSTIVE`` is always measured whole, so asking for a sample of it
    is an error, raised before anything is measured."""
    with pytest.raises(ValueError, match="samples applies to"):
        landscape.main(problem="pnpoly_h100", device="cpu", small=True,
                       samples=4)


def test_landscape_samples_a_sampled_problem_on_the_host(tmp_path, capsys):
    """The paper's sampled protocol through ``landscape.main --small
    --samples 40`` on ``expdist_h100`` (720 admitted configs): 40 distinct
    configs in random order, a ``sampled:40:0`` table that the JAX
    package's ``ResultsDB`` reads, the five results on it, and a Table VIII
    row whose valid count is estimated (``exact`` False)."""
    out = landscape.main(problem="expdist_h100", device="cpu", small=True,
                         samples=40, results_dir=tmp_path)
    prob, table = out["problem"], out["table"]
    assert prob.space.compiled().n_valid == 720
    assert table.protocol == "sampled:40:0" and len(table) == 40
    assert out["invalid"] == 0
    rows = [prob.space.flat_index(t.config) for t in out["trials"]]
    assert len(set(rows)) == 40
    assert rows == [prob.space.flat_index(c)
                    for c in prob.space.sample_distinct(40, 0)]
    assert out["speedup"] >= 1.0
    assert 1 <= out["n90"] <= out["n99"] <= 40
    assert 0.0 <= out["centrality"] <= 1.0
    assert list(out["pfi"]) == list(prob.space.param_names)
    row = out["table8"]
    assert row["exact"] is False
    assert row["constrained"] == 720 and row["valid"]["cpu"] == 720
    back = jresults.ResultsDB(tmp_path).get(prob.name, "cpu", "sampled:40:0")
    assert back.objectives == table.objectives
    assert "estimated from the sample" in capsys.readouterr().out


def test_landscape_measures_a_small_sampled_space_whole():
    """A sampled problem whose space admits no more than ``samples``
    configs is measured whole, and its table is exhaustive: dedisp_h100 at
    its small shape admits 102 (of 112: a ring of two steps of 64
    channels' slots does not fit every pass)."""
    out = landscape.main(problem="dedisp_h100", device="cpu", small=True)
    prob, table = out["problem"], out["table"]
    n = prob.space.compiled().n_valid
    assert n == 102 and table.protocol == "exhaustive" and len(table) == n
    assert out["invalid"] == 0
    assert out["table8"]["exact"] is True
    assert out["table8"]["valid"]["cpu"] == n


def test_landscape_measures_nbody_whole_on_the_host():
    """A problem of this slice through ``landscape.main --small``: every
    admitted config of ``nbody_h100`` at N = 512 measured once, with no
    invalid trial, and the five results on that table."""
    out = landscape.main(problem="nbody_h100", device="cpu", small=True)
    prob, table = out["problem"], out["table"]
    n = prob.space.compiled().n_valid
    assert prob.name == "nbody_h100" and n == 480
    assert len(table) == n and out["invalid"] == 0
    assert out["speedup"] >= 1.0
    assert 1 <= out["n90"] <= out["n99"] <= n
    assert list(out["pfi"]) == list(prob.space.param_names)
    assert out["table8"]["constrained"] == n
