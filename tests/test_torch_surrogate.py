"""The port's surrogate (``repro_torch.core.surrogate``) and its two tuner
seams held against the JAX package's (``repro.core.surrogate``) on the CPU:
the GBDT on degenerate inputs, the harvest and its leakage guards (the
fixtures in ``tests/fixtures/warmstart`` give identical ``X`` and ``y``,
and models fitted on them predict identically), the model's ranking,
transfer and lossless round trip, the checksummed model store and its
quarantine, the warm-start seam, the screen's decisions, screened sessions
(the reference's journaled trace, resumed estimate for estimate) and the
CLI; and the port's own arch vocabulary: measured ``h100`` rows are
harvested by default."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mlmodel as ref_mlmodel  # noqa: E402
from repro.core import surrogate as ref  # noqa: E402
from repro.core.tuners.base import run_tuner as ref_run_tuner  # noqa: E402
from repro.core.tuners import TUNERS as REF_TUNERS  # noqa: E402
from repro.orchestrator.registry import make_problem as ref_problem  # noqa: E402
from repro.orchestrator.runner import run_session as ref_run  # noqa: E402
from repro.orchestrator.session import SessionSpec as RefSpec  # noqa: E402
from repro.orchestrator.store import SessionStore as RefStore  # noqa: E402

from repro_torch.core import mlmodel  # noqa: E402
from repro_torch.core.costmodel import ARCH_NAMES  # noqa: E402
from repro_torch.core.problem import FunctionProblem  # noqa: E402
from repro_torch.core.results import ResultTable  # noqa: E402
from repro_torch.core.surrogate import (ESTIMATED_INFO, Harvest,  # noqa: E402
                                        KernelSurrogate, ModelStore,
                                        SurrogateScreen)
from repro_torch.core.surrogate.dataset import DEFAULT_ARCHS  # noqa: E402
from repro_torch.core.surrogate.store import (HEADER_FIELDS,  # noqa: E402
                                              MAGIC, ModelStoreError,
                                              parse_model, section_checksum)
from repro_torch.core.tuners import TUNERS  # noqa: E402
from repro_torch.core.tuners.base import run_tuner  # noqa: E402
from repro_torch.orchestrator.cli import main as cli_main  # noqa: E402
from repro_torch.orchestrator.registry import make_problem  # noqa: E402
from repro_torch.orchestrator.runner import (resume_session,  # noqa: E402
                                             run_session)
from repro_torch.orchestrator.session import SessionSpec  # noqa: E402
from repro_torch.orchestrator.store import SessionStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "warmstart"
SMALL = {"n_trees": 24, "max_depth": 4, "min_samples_leaf": 2, "seed": 0}
#: the archs the toys' training rows are harvested under
ARCHS = ("h100", "h100sxm", "h100pcie")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    return make_problem("toy_quad")


def _objectives(prob, rows, arch):
    sp = prob.space
    return [prob.evaluate(sp.from_flat_index(int(r)), arch).objective
            for r in rows]


def _training_set(archs=ARCHS, n=240, seed=0):
    prob = _problem()
    h = Harvest("toy_quad", prob.space)
    rows = np.random.default_rng(seed).choice(prob.space.cardinality,
                                              size=n, replace=False)
    for arch in archs:
        h.add_rows(rows.tolist(), arch, _objectives(prob, rows, arch))
    return prob, h.build()


def _model(archs=ARCHS, n=240, seed=0, params=SMALL):
    prob, ts = _training_set(archs, n, seed)
    return prob, KernelSurrogate.fit(ts, params=params)


# --------------------------------------------------------------------- #
# the GBDT on degenerate inputs, prediction for prediction the reference's
# --------------------------------------------------------------------- #
DEGENERATE = {
    "tree_empty": ("RegressionTree", np.empty((0, 3)), np.empty(0),
                   np.array([[1.0, 2.0, 3.0]])),
    "tree_single_row": ("RegressionTree", np.array([[1.0, 2.0]]),
                        np.array([5.0]), np.array([[9.0, 9.0]])),
    "tree_constant": ("RegressionTree",
                      np.arange(20, dtype=float).reshape(10, 2),
                      np.full(10, 3.25),
                      np.arange(20, dtype=float).reshape(10, 2)),
    "gbdt_empty": ("GradientBoostedTrees", np.empty((0, 2)), np.empty(0),
                   np.array([[1.0, 1.0]])),
    "gbdt_flat_input": ("GradientBoostedTrees", np.arange(8, dtype=float),
                        np.arange(8, dtype=float), np.array([[3.0]])),
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_fits_predict_as_the_references(case):
    cls, X, y, Q = DEGENERATE[case]
    kw = {"n_trees": 3} if cls == "GradientBoostedTrees" else {}
    got = getattr(mlmodel, cls)(**kw).fit(X, y).predict(Q)
    want = getattr(ref_mlmodel, cls)(**kw).fit(X, y).predict(Q)
    assert got.shape == (len(Q),)
    np.testing.assert_array_equal(got, want)
    if case == "tree_single_row":
        assert got[0] == pytest.approx(5.0)
    if case == "tree_constant":
        assert np.allclose(got, 3.25)


# --------------------------------------------------------------------- #
# harvest
# --------------------------------------------------------------------- #
def test_harvest_default_vocabulary_keeps_measured_h100_rows():
    """Measured rows carry the card's id, ``h100``: the default vocabulary
    names it first, so a harvest with no ``archs`` keeps them (a plain
    copy of the JAX package's default, the cost model's ids alone, kept
    none)."""
    assert DEFAULT_ARCHS == ("h100", *ARCH_NAMES) == ("h100", "h100sxm",
                                                      "h100pcie")
    prob = _problem()
    h = Harvest("toy_quad", prob.space)
    assert h.archs == DEFAULT_ARCHS
    assert h.add_rows([1, 2, 3], "h100", [1.0, 2.0, 3.0]) == 3
    ts = h.build()
    assert ts.archs == DEFAULT_ARCHS and set(ts.X[:, -1]) == {0}
    model = KernelSurrogate.fit(ts, params=SMALL)
    assert model.archs == DEFAULT_ARCHS
    assert len(model.top_rows(prob.space, "h100", k=4)) == 4


def test_harvest_basic_schema():
    prob, ts = _training_set(archs=("h100", "h100sxm"), n=50)
    assert ts.X.shape == (100, len(prob.space.params) + 1)
    assert ts.param_names == prob.space.param_names
    assert set(ts.X[:, -1].tolist()) == {ts.archs.index("h100"),
                                         ts.archs.index("h100sxm")}
    assert np.all(np.isfinite(ts.y))


def test_harvest_skips_nonfinite_and_nonpositive():
    h = Harvest("toy_quad", _problem().space)
    assert h.add_rows([1, 2, 3, 4], "h100",
                      [1.0, math.inf, math.nan, -2.0]) == 1
    assert len(h.build()) == 1


def test_harvest_dedups_row_arch_pairs():
    h = Harvest("toy_quad", _problem().space)
    assert h.add_rows([7, 7], "h100", [1.0, 2.0]) == 1
    assert h.add_rows([7], "h100", [3.0]) == 0
    assert h.add_rows([7], "h100sxm", [3.0]) == 1
    ts = h.build()
    assert len(ts) == 2
    i = int(np.argmax(ts.X[:, -1] == ts.archs.index("h100")))
    assert ts.y[i] == pytest.approx(math.log(1.0))


def test_harvest_exclude_and_unknown_archs():
    h = Harvest("toy_quad", _problem().space, exclude_archs=("h100sxm",))
    assert h.add_rows([1], "h100sxm", [1.0]) == 0
    assert h.add_rows([1], "v5e", [1.0]) == 0     # not in the vocabulary
    assert h.add_rows([1], "h100", [1.0]) == 1


def test_harvest_add_table():
    prob = _problem()
    trials = prob.exhaustive(arch="h100sxm", limit=32)
    table = ResultTable.from_trials(prob, "h100sxm", trials, "exhaustive")
    h = Harvest("toy_quad", prob.space)
    assert h.add_table(table) == 32 and h.n_sources == 1
    table.problem = "other"
    assert h.add_table(table) == 0


def test_harvest_split_arch():
    _, ts = _training_set(archs=("h100", "h100sxm"), n=40)
    rest, held = ts.split_arch("h100")
    assert len(rest) == 40 and len(held) == 40
    assert np.all(held.X[:, -1] == ts.archs.index("h100"))
    assert not np.any(rest.X[:, -1] == ts.archs.index("h100"))


def _fixture_rows() -> dict[str, tuple[list[int], list[float]]]:
    out = {}
    for path in sorted(FIXTURES.glob("*.trials.jsonl")):
        recs = [json.loads(line) for line in path.read_text().splitlines()
                if line.strip()]
        out[path.name.split(".")[0]] = ([r["k"] for r in recs],
                                        [r["o"] for r in recs])
    return out


def test_fixture_harvest_and_model_are_the_references():
    """The eight fixture journals (``toy_quad``, arch ``v5e``) harvested
    under a named vocabulary, each journal under its own arch: identical
    ``X``, ``y`` and rows; a model fitted on them predicts bit for bit what
    the JAX package's does."""
    archs = ("v4", "v5e", "v5p", "v6e", "h100", "h100sxm", "h100pcie",
             "cpu")
    space = _problem().space
    rspace = ref_problem("toy_quad").space
    got, want = Harvest("toy_quad", space, archs=archs), \
        ref.Harvest("toy_quad", rspace, archs=archs)
    for (name, (rows, objs)), arch in zip(_fixture_rows().items(), archs):
        assert got.add_rows(rows, arch, objs) \
            == want.add_rows(rows, arch, objs) > 0
    ts, rts = got.build(), want.build()
    assert ts.archs == rts.archs and ts.param_names == rts.param_names
    np.testing.assert_array_equal(ts.X, rts.X)
    np.testing.assert_array_equal(ts.y, rts.y)
    np.testing.assert_array_equal(ts.rows, rts.rows)
    model = KernelSurrogate.fit(ts, params=SMALL)
    rmodel = ref.KernelSurrogate.fit(rts, params=SMALL)
    rows = np.arange(space.cardinality)
    for arch in ("v5e", "h100", "cpu"):
        np.testing.assert_array_equal(model.predict_rows(space, rows, arch),
                                      rmodel.predict_rows(rspace, rows, arch))
        assert model.top_rows(space, arch, k=8) \
            == rmodel.top_rows(rspace, arch, k=8)
    assert model.payload() == rmodel.payload()


def test_harvest_add_store_skips_estimated(tmp_path):
    """The leakage guard: screened (model-estimated) journal records are
    never harvested as training rows."""
    prob, model = _model(n=120)
    store = SessionStore(tmp_path / "s", clock=lambda: 0.0)
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.5)
    spec = SessionSpec(problem="toy_quad", tuner="random", arch="h100",
                       budget=24, seed=9, workers=2)
    store.create(spec)
    res = run_session(spec, store=store, screen=screen)
    n_est = sum(1 for t in res.trials if t.info.get("estimated"))
    assert n_est > 0
    h = Harvest("toy_quad", prob.space)
    added = h.add_store(store)
    assert h.n_skipped_estimated == n_est
    assert added == len(res.trials) - n_est


# --------------------------------------------------------------------- #
# model: fit, predict, transfer, serialization
# --------------------------------------------------------------------- #
def test_model_recovers_ranking():
    prob, model = _model(archs=("h100sxm", "h100pcie"), n=400, params=None)
    top = model.top_rows(prob.space, "h100", k=8)      # an arch never seen
    best_true = min(prob.evaluate(prob.space.from_flat_index(r),
                                  "h100").objective for r in top)
    assert best_true <= 3.0
    preds = model.predict_rows(prob.space, top, "h100")
    assert list(preds) == sorted(preds)
    opt = prob.space.flat_index({f"p{i}": 2 for i in range(4)})
    worst = prob.space.flat_index({f"p{i}": 7 for i in range(4)})
    p = model.predict_rows(prob.space, [opt, worst], "h100")
    assert p[0] < p[1]


def test_model_unknown_arch_raises():
    prob, model = _model(archs=("h100", "h100sxm"))
    with pytest.raises(ValueError, match="not in model vocabulary"):
        model.predict_rows(prob.space, [0], "hal9000")


def test_model_heldout_beats_shuffled_baseline():
    prob, ts = _training_set(n=200)
    rest, held = ts.split_arch("h100")
    model = KernelSurrogate.fit(rest, params=SMALL)
    perm = np.random.default_rng(1).permutation(len(rest))
    shuffled = KernelSurrogate.fit(replace(rest, y=rest.y[perm]),
                                   params=SMALL)
    r2 = model.r2(held)
    assert r2 > 0.5 and r2 > shuffled.r2(held) + 0.3


def test_model_top_params_exclude_arch():
    prob, ts = _training_set(n=150)
    top = KernelSurrogate.fit(ts, params=SMALL).top_params(ts, k=3)
    assert len(top) == 3 and "arch" not in top
    assert set(top) <= set(prob.space.param_names)


def test_model_serialization_bit_identical(tmp_path):
    prob, model = _model(n=150)
    store = ModelStore(tmp_path, clock=lambda: 42.0)
    path = store.save(model)
    loaded, problems = store.load("toy_quad")
    assert problems == [] and loaded is not None
    rows = np.arange(64)
    np.testing.assert_array_equal(
        model.predict_rows(prob.space, rows, "h100"),
        loaded.predict_rows(prob.space, rows, "h100"))
    assert (loaded.archs, loaded.param_names, loaded.n_rows) \
        == (model.archs, model.param_names, model.n_rows)
    # the JAX package's store reads the port's model file as its own
    rloaded, rproblems = ref.ModelStore(tmp_path).load("toy_quad")
    assert rproblems == [] and rloaded.archs == model.archs
    assert path.exists()


def test_model_payload_requires_fit():
    with pytest.raises(ValueError, match="not fitted"):
        KernelSurrogate("k", ("a",), ("h100",)).payload()


# --------------------------------------------------------------------- #
# model store: header grammar, checksums, quarantine
# --------------------------------------------------------------------- #
def _saved(tmp_path):
    _, model = _model(n=100)
    store = ModelStore(tmp_path, clock=lambda: 0.0)
    return store, store.save(model)


def test_store_header_grammar(tmp_path):
    store, path = _saved(tmp_path)
    doc = json.loads(path.read_text())
    assert set(doc["header"]) == set(HEADER_FIELDS) \
        == set(ref.HEADER_FIELDS)
    assert doc["header"]["magic"] == MAGIC
    assert doc["header"]["sections"]["model"] == \
        section_checksum(doc["model"])
    assert store.list_models() == ["toy_quad"]


def test_store_load_missing(tmp_path):
    model, problems = ModelStore(tmp_path).load("nope")
    assert model is None and "no model" in problems[0]


MUTATIONS = {
    "magic": (lambda d: d.update(header={**d["header"], "magic": "evil"}),
              "bad magic"),
    "version": (lambda d: d.update(header={**d["header"], "version": 99}),
                "unsupported version"),
    "field": (lambda d: d.update(header={**d["header"], "surprise": 1}),
              "undocumented header field"),
    "checksum": (lambda d: d["model"]["trees"].pop(), "checksum mismatch"),
    "section": (lambda d: d.pop("model"), "missing model section"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_store_corrupt_variants_quarantined(tmp_path, name):
    mutate, expect = MUTATIONS[name]
    store, path = _saved(tmp_path)
    doc = json.loads(path.read_text())
    mutate(doc)
    path.write_text(json.dumps(doc))
    model, problems = store.load("toy_quad")
    assert model is None and any(expect in p for p in problems)
    assert not path.exists()
    (bad,) = (tmp_path / "quarantine").glob("*.bad")
    assert expect in bad.with_suffix(bad.suffix + ".reason").read_text()


def test_store_garbage_bytes_quarantined(tmp_path):
    store, path = _saved(tmp_path)
    path.write_bytes(b"\x00\xffnot json")
    model, problems = store.load("toy_quad")
    assert model is None and "quarantined" in problems[0]


def test_store_quarantine_numbering(tmp_path):
    store, path = _saved(tmp_path)
    for junk in ("junk", "junk again"):
        path.write_text(junk)
        store.load("toy_quad")
    names = sorted(p.name for p in (tmp_path / "quarantine").glob("*.bad"))
    assert names == ["toy_quad.model.json.0.bad", "toy_quad.model.json.1.bad"]


def test_store_verify_dir_readonly(tmp_path):
    store, path = _saved(tmp_path)
    assert store.verify_dir() == {"ok": ["toy_quad"], "problems": {}}
    path.write_text("junk")
    assert "toy_quad.model.json" in store.verify_dir()["problems"]
    assert path.exists()


def test_parse_model_strict_raises():
    with pytest.raises(ModelStoreError, match="not JSON"):
        parse_model(b"nope")
    with pytest.raises(ModelStoreError, match="missing header"):
        parse_model(b"{}")


# --------------------------------------------------------------------- #
# warm-start seam
# --------------------------------------------------------------------- #
def _warm_rows(prob):
    opt = prob.space.flat_index({f"p{i}": 2 for i in range(4)})
    return [opt, opt + 1, opt + 8]


@pytest.mark.parametrize("tuner_name", sorted(TUNERS))
def test_warm_rows_proposed_first(tuner_name):
    prob = _problem()
    warm = _warm_rows(prob)
    t = TUNERS[tuner_name](prob.space, seed=1)
    res = run_tuner(t, prob, budget=20, warm_start=warm)
    assert [prob.space.flat_index(x.config) for x in res.trials[:3]] == warm
    assert t.warm_started and t._warm_adopted
    assert res.best.objective == 1.0


@pytest.mark.parametrize("tuner_name", sorted(TUNERS))
def test_warm_disabled_is_bit_identical(tuner_name):
    prob = _problem()
    cold = run_tuner(TUNERS[tuner_name](prob.space, seed=5), prob, budget=24)
    t = TUNERS[tuner_name](prob.space, seed=5)
    t.set_warm_start([])
    warm = run_tuner(t, prob, budget=24)
    assert [x.config for x in cold.trials] == [x.config for x in warm.trials]


def test_set_warm_start_filters_invalid_rows():
    prob = _problem()
    t = TUNERS["random"](prob.space, seed=0)
    t.set_warm_start([5, -1, prob.space.cardinality + 7, 5, 9])
    assert t._warm_queue == [5, 9]


def test_warm_adoption_walker_continues_from_best():
    prob = _problem()
    opt = prob.space.flat_index({f"p{i}": 2 for i in range(4)})
    worst = prob.space.flat_index({f"p{i}": 7 for i in range(4)})
    t = TUNERS["annealing"](prob.space, seed=2)
    run_tuner(t, prob, budget=12, warm_start=[opt, worst])
    assert t._warm_best_row == opt


def test_warm_scalar_path():
    prob = _problem()
    warm = _warm_rows(prob)
    t = TUNERS["genetic"](prob.space, seed=1)
    t._comp = None
    res = run_tuner(t, prob, budget=20, warm_start=warm)
    assert [prob.space.flat_index(x.config) for x in res.trials[:3]] == warm
    assert t._warm_adopted


def test_warm_spec_identity():
    base = SessionSpec(problem="toy_quad", tuner="genetic", budget=10)
    warm = SessionSpec(problem="toy_quad", tuner="genetic", budget=10,
                       warm_start=[3, 1])
    assert "warm_start" not in base.canonical()
    assert warm.canonical()["warm_start"] == [3, 1]
    assert base.session_id != warm.session_id
    rt = SessionSpec.from_json(warm.to_json())
    assert rt.warm_start == [3, 1] and rt.session_id == warm.session_id
    rt0 = SessionSpec.from_json(base.to_json())
    assert rt0.warm_start is None and rt0.session_id == base.session_id


def test_warm_session_resumes_identically(tmp_path):
    spec = SessionSpec(problem="toy_quad", tuner="annealing", arch="h100",
                       budget=24, seed=4, workers=2,
                       warm_start=_warm_rows(_problem()))
    s1 = SessionStore(tmp_path / "a", clock=lambda: 0.0)
    s1.create(spec)
    full = run_session(spec, store=s1)
    s2 = SessionStore(tmp_path / "b", clock=lambda: 0.0)
    s2.create(spec)
    run_session(spec, store=s2, stop_after=7)
    resumed = resume_session(spec.session_id, s2)
    assert [t.config for t in full.trials] == [t.config for t in resumed.trials]


# --------------------------------------------------------------------- #
# screening seam
# --------------------------------------------------------------------- #
def _both_models(n=120):
    """One training set through both packages' surrogates: the screens
    built on them decide alike."""
    prob, ts = _training_set(n=n)
    rts = ref.TrainingSet(ts.problem, ts.param_names, ts.archs, ts.X, ts.y,
                          ts.rows, ts.n_sources)
    return (prob, KernelSurrogate.fit(ts, params=SMALL),
            ref.KernelSurrogate.fit(rts, params=SMALL))


def test_screen_batch_split():
    prob, model, rmodel = _both_models()
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.25)
    rscreen = ref.SurrogateScreen(rmodel, ref_problem("toy_quad").space,
                                  "h100", measure_frac=0.25)
    rows = list(range(0, 160, 10))
    verdicts = screen.screen_rows(rows)
    measured = [i for i, v in enumerate(verdicts) if v is None]
    assert len(measured) == math.ceil(0.25 * len(rows))
    preds = model.predict_rows(prob.space, rows, "h100")
    assert set(measured) == set(
        np.argsort(preds, kind="stable")[:len(measured)].tolist())
    rverdicts = rscreen.screen_rows(rows)
    assert [v is None for v in verdicts] == [v is None for v in rverdicts]
    assert [v.objective for v in verdicts if v is not None] \
        == [v.objective for v in rverdicts if v is not None]


def test_screen_estimated_trials_flagged():
    prob, model = _model(n=120)
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.25)
    est = [v for v in screen.screen_rows(list(range(8))) if v is not None]
    assert est and ESTIMATED_INFO == ref.ESTIMATED_INFO
    for t in est:
        assert t.info == ESTIMATED_INFO and t.info is not ESTIMATED_INFO
        assert t.valid and math.isfinite(t.objective) and t.arch == "h100"


def test_screen_singleton_threshold_and_max_defer():
    prob, model, rmodel = _both_models()
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.25,
                             max_defer=3)
    rscreen = ref.SurrogateScreen(rmodel, ref_problem("toy_quad").space,
                                  "h100", measure_frac=0.25, max_defer=3)
    assert screen._tau == rscreen._tau
    worst = prob.space.flat_index({f"p{i}": 7 for i in range(4)})
    outcomes = [screen.screen_rows([worst])[0] is None for _ in range(8)]
    assert outcomes[:4] == [False, False, False, True]
    assert outcomes == [rscreen.screen_rows([worst])[0] is None
                        for _ in range(8)]
    opt = prob.space.flat_index({f"p{i}": 2 for i in range(4)})
    assert screen.screen_rows([opt])[0] is None


def test_screen_wrong_arch_and_bad_measure_frac():
    prob, model = _model(n=100)
    screen = SurrogateScreen(model, prob.space, "h100")
    with pytest.raises(ValueError, match="calibrated for"):
        screen.screen_rows([1], "h100sxm")
    with pytest.raises(ValueError, match="measure_frac"):
        SurrogateScreen(model, prob.space, "h100", measure_frac=0.0)


@pytest.mark.parametrize("tuner", ["genetic", "random"])
def test_screened_session_journals_the_references_trace(tuner, tmp_path):
    """A screened session: the port's journal, trace and table are the JAX
    package's (explicit arch on both sides), estimated trials flagged in
    the journal and left out of the published table; resumed from disk
    with no screen, the trace replays estimate for estimate."""
    prob, model, rmodel = _both_models()
    kw = dict(problem="toy_quad", tuner=tuner, arch="h100", budget=20,
              seed=6, workers=2)
    spec, rspec = SessionSpec(**kw), RefSpec(**kw)
    assert spec.session_id == rspec.session_id
    store = SessionStore(tmp_path / "p", clock=lambda: 0.0)
    rstore = RefStore(tmp_path / "r", clock=lambda: 0.0)
    store.create(spec)
    rstore.create(rspec)
    res = run_session(spec, store=store, screen=SurrogateScreen(
        model, prob.space, "h100", measure_frac=0.5))
    rres = ref_run(rspec, store=rstore, screen=ref.SurrogateScreen(
        rmodel, ref_problem("toy_quad").space, "h100", measure_frac=0.5))
    trace = [(t.config, t.objective, t.info.get("estimated"))
             for t in res.trials]
    assert trace == [(t.config, t.objective, t.info.get("estimated"))
                     for t in rres.trials]
    est = [i for i, t in enumerate(res.trials) if t.info.get("estimated")]
    assert est and len(res.trials) == 20
    sid = spec.session_id
    assert (tmp_path / "p" / sid / "trials.jsonl").read_bytes() \
        == (tmp_path / "r" / sid / "trials.jsonl").read_bytes()
    journal = store.load_journal(sid, prob.space, "h100")
    for i in est:
        assert journal[i][1].info.get("provenance") == "surrogate-screen"
    ((_, arch, protocol),) = store.tables.list_tables()
    table = store.tables.get("toy_quad", arch, protocol)
    assert len(table) == 20 - len(est)
    assert table.meta.get("screened") == len(est)
    resumed = resume_session(sid, store)
    assert [(t.objective, t.info.get("estimated")) for t in resumed.trials] \
        == [(t.objective, t.info.get("estimated")) for t in res.trials]


def test_screened_session_measures_fewer():
    prob, model = _model(n=120)
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.25)
    spec = SessionSpec(problem="toy_quad", tuner="genetic", arch="h100",
                       budget=32, seed=7, workers=2)
    res = run_session(spec, screen=screen)
    measured = sum(1 for t in res.trials if not t.info.get("estimated"))
    assert measured < len(res.trials)
    assert screen.n_estimated == len(res.trials) - measured


@pytest.mark.parametrize("tuner", ["genetic", "annealing"])
def test_run_tuner_screen_is_the_references(tuner):
    """``run_tuner(screen=)``: the singleton-batch screen in the serial
    loop, trial for trial the JAX package's, and estimated trials never
    reach the problem's evaluator."""
    prob, model, rmodel = _both_models()
    evaluated = []

    def fn(cfg, arch):
        evaluated.append(dict(cfg))
        return 1.0 + sum((cfg[f"p{i}"] - 2) ** 2 for i in range(4))

    counting = FunctionProblem(prob.space, fn, name="toy_quad")
    screen = SurrogateScreen(model, prob.space, "h100", measure_frac=0.25,
                             max_defer=3)
    res = run_tuner(TUNERS[tuner](prob.space, seed=3), counting, 30,
                    arch="h100", screen=screen)
    rprob = ref_problem("toy_quad")
    rres = ref_run_tuner(REF_TUNERS[tuner](rprob.space, seed=3), rprob, 30,
                         arch="h100", screen=ref.SurrogateScreen(
                             rmodel, rprob.space, "h100", measure_frac=0.25,
                             max_defer=3))
    assert [(t.config, t.objective, t.info.get("estimated"))
            for t in res.trials] == \
        [(t.config, t.objective, t.info.get("estimated"))
         for t in rres.trials]
    assert len(evaluated) == screen.n_measured == sum(
        1 for t in res.trials if not t.info.get("estimated"))
    assert screen.n_estimated > 0


def test_broker_session_refuses_a_screen(tmp_path):
    from repro_torch.orchestrator.broker import SQLiteBroker
    prob, model = _model(n=60)
    spec = SessionSpec(problem="toy_quad", tuner="random", budget=8)
    with pytest.raises(ValueError, match="screen="):
        run_session(spec, store=SessionStore(tmp_path / "s"),
                    broker=SQLiteBroker(tmp_path / "q.db"),
                    screen=SurrogateScreen(model, prob.space, "h100"))


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #
def _seed_store(tmp_path, archs=ARCHS, budget=60):
    store_dir = tmp_path / "sessions"
    store = SessionStore(store_dir, clock=lambda: 0.0)
    for i, arch in enumerate(archs):
        spec = SessionSpec(problem="toy_quad", tuner="random", arch=arch,
                           budget=budget, seed=i, workers=2)
        store.create(spec)
        run_session(spec, store=store)
    return store_dir


def test_cli_surrogate_train_predict_eval(tmp_path, capsys):
    store_dir = _seed_store(tmp_path)
    models = str(tmp_path / "models")
    assert cli_main(["surrogate", "train", "--store", str(store_dir),
                     "--models", models, "--problem", "toy_quad",
                     "--params", json.dumps(SMALL), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["report"][0]["trained"]
    assert cli_main(["surrogate", "predict", "--models", models,
                     "--problem", "toy_quad", "--top", "4", "--json"]) == 0
    pred = json.loads(capsys.readouterr().out)
    assert pred["arch"] == "h100" and len(pred["rows"]) == 4
    assert pred["predicted_s"] == sorted(pred["predicted_s"])
    assert cli_main(["surrogate", "eval", "--store", str(store_dir),
                     "--problem", "toy_quad", "--json"]) == 0
    ev = json.loads(capsys.readouterr().out)
    assert ev["holdout"] == "h100" and ev["transfers"] is True
    assert ev["r2_holdout"] > ev["r2_shuffled_baseline"]


def test_cli_train_too_few_rows(tmp_path, capsys):
    SessionStore(tmp_path / "empty")
    assert cli_main(["surrogate", "train", "--store",
                     str(tmp_path / "empty"), "--models",
                     str(tmp_path / "m"), "--problem", "toy_quad"]) == 1
    assert "not trained" in capsys.readouterr().out


def test_cli_predict_and_warm_start_with_no_model(tmp_path, capsys):
    assert cli_main(["surrogate", "predict", "--models",
                     str(tmp_path / "m"), "--problem", "toy_quad"]) == 1
    assert "no usable model" in capsys.readouterr().err
    assert cli_main(["submit", "--problem", "toy_quad", "--tuner", "random",
                     "--store", str(tmp_path / "s"), "--warm-start",
                     str(tmp_path / "m")]) == 2
    assert "--warm-start: no usable model" in capsys.readouterr().err


def test_cli_submit_warm_start(tmp_path, capsys):
    store_dir = _seed_store(tmp_path, archs=("h100sxm", "h100pcie"))
    models = str(tmp_path / "models")
    cli_main(["surrogate", "train", "--store", str(store_dir),
              "--models", models, "--problem", "toy_quad"])
    capsys.readouterr()
    assert cli_main(["submit", "--problem", "toy_quad", "--tuner", "genetic",
                     "--arch", "h100", "--budget", "16", "--seed", "0",
                     "--workers", "2", "--store", str(store_dir),
                     "--warm-start", models, "--warm-top", "4"]) == 0
    out = capsys.readouterr().out
    assert "warm start: 4 predicted-top rows" in out
    assert "best 1.0000s" in out
    sid = next(line.split()[1] for line in out.splitlines()
               if line.startswith("session "))
    model, _ = ModelStore(models).load("toy_quad")
    top = model.top_rows(_problem().space, "h100", k=4)
    spec = SessionStore(store_dir).load_spec(sid)
    assert spec.warm_start == top
    recs = [json.loads(line) for line in
            (store_dir / sid / "trials.jsonl").read_text().splitlines()]
    assert [r["k"] for r in recs[:4]] == top


def test_cli_subprocess_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.orchestrator", "surrogate",
         "--help"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert proc.returncode == 0
    assert "train" in proc.stdout and "predict" in proc.stdout

