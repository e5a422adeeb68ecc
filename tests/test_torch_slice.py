"""The port's slices end to end on the host: the quickstart and a genetic
algorithm over ``GemmProblem(device="cpu")`` at 256x256x512, the quickstart
over ``flash_attention_h100`` at its small shape, timing the plain versions
with the host clock, and published tables both packages' ``ResultsDB``
read."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import results as jresults  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.core import results as tresults  # noqa: E402
from repro_torch.core.tuners import GeneticAlgorithm, run_tuner  # noqa: E402
from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem  # noqa: E402

BUDGET = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores, which slowed these
    small CPU ops by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return GemmProblem(shape=SMALL_SHAPE, device="cpu", repeats=3, warmup=1)


@pytest.fixture(scope="module")
def ga_run(problem):
    return run_tuner(GeneticAlgorithm(problem.space, seed=0), problem,
                     BUDGET, arch=problem.arch)


def test_ga_measures_every_admitted_config(ga_run):
    assert ga_run.evaluations == BUDGET
    assert all(t.ok and t.arch == "cpu" for t in ga_run.trials)
    for t in ga_run.trials:
        info = t.info
        assert info["repeats"] == 3
        assert info["min_s"] <= info["median_s"] == t.objective <= info["max_s"]
    assert len({tuple(sorted(t.config.items())) for t in ga_run.trials}) \
        == BUDGET


def test_table_round_trips_through_both_packages(problem, ga_run, tmp_path):
    table = tresults.ResultTable.from_trials(problem, problem.arch,
                                             ga_run.trials, "trace_ga_0")
    tresults.ResultsDB(tmp_path).put(table)
    back = jresults.ResultsDB(tmp_path).get("gemm_h100", "cpu", "trace_ga_0")
    assert back.to_bytes() == table.to_bytes()
    assert back.objectives == [t.objective for t in ga_run.trials]
    assert tresults.ResultsDB(tmp_path).list_tables() \
        == [("gemm_h100", "cpu", "trace_ga_0")]


def test_quickstart_on_the_host(tmp_path, capsys):
    out = quickstart.main(device="cpu", small=True, budget=12, sample=12,
                          results_dir=tmp_path)
    prob = out["problem"]
    assert prob.arch == "cpu" and prob.shape == SMALL_SHAPE
    assert set(out["runs"]) == {"RandomSearch", "GeneticAlgorithm"}
    assert all(r.evaluations == 12 for r in out["runs"].values())
    assert out["rel_l2"] <= quickstart.tolerance("gemm_h100",
                                                 out["best"].config)
    assert math.isfinite(out["speedup"]) and out["speedup"] >= 1.0
    assert len(out["table"]) == 12
    # the published table loads in the JAX package
    key = ("gemm_h100", "cpu", "sampled_12_1")
    assert jresults.ResultsDB(tmp_path).get(*key).objectives \
        == out["table"].objectives
    assert "speedup over median" in capsys.readouterr().out


def test_quickstart_tunes_attention_on_the_host(tmp_path):
    out = quickstart.main(problem="flash_attention_h100", device="cpu",
                          small=True, budget=8, sample=8,
                          results_dir=tmp_path)
    prob = out["problem"]
    assert prob.name == "flash_attention_h100" and prob.arch == "cpu"
    assert all(r.evaluations == 8 and all(t.ok for t in r.trials)
               for r in out["runs"].values())
    assert out["rel_l2"] <= quickstart.tolerance(prob.name,
                                                 out["best"].config)
    key = ("flash_attention_h100", "cpu", "sampled_8_1")
    assert jresults.ResultsDB(tmp_path).get(*key).objectives \
        == out["table"].objectives
