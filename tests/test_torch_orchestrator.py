"""The port's session layer (``repro_torch.orchestrator``) held against the
JAX package's (``repro.orchestrator``) on the CPU: the same session ids,
trajectories, journals and ``ResultTable`` bytes for the toy problems;
parallel == serial; exact resume; the chaos plane and retry delays; the
brokers' lease protocol; the CLI; the kernel problems measured on the host
in spawned worker processes; the campaign that mixes the measured arch with
the cost model's; what the port refuses (a session with no card and no
``--device``); the surrogate screen's session against the JAX package's;
and every tuner's session stopped and resumed, cold and warm-started."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.orchestrator as ref  # noqa: E402
from repro.core import retry as ref_retry  # noqa: E402
from repro.orchestrator import chaos as ref_chaos  # noqa: E402
from repro.orchestrator.cli import main as ref_cli  # noqa: E402
from repro.telemetry import metrics as ref_metrics  # noqa: E402

import repro_torch.orchestrator as port  # noqa: E402
from repro_torch.core import retry as port_retry  # noqa: E402
from repro_torch.core.problem import FunctionProblem  # noqa: E402
from repro_torch.core.space import Param, SearchSpace  # noqa: E402
from repro_torch.core.tuners import TUNERS, run_tuner  # noqa: E402
from repro_torch.kernels.attention.space import AttentionProblem  # noqa: E402
from repro_torch.kernels.hotspot.space import HotspotProblem  # noqa: E402
from repro_torch.kernels.matmul.space import GemmProblem  # noqa: E402
from repro_torch.orchestrator import chaos as port_chaos  # noqa: E402
from repro_torch.orchestrator import workers as port_workers  # noqa: E402
from repro_torch.orchestrator.campaign import _partition_archsets  # noqa: E402
from repro_torch.orchestrator.cli import main as port_cli  # noqa: E402
from repro_torch.telemetry import metrics as port_metrics  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402

from torch_toys import WorkerKiller  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOYS = ("toy_quad", "toy_rastrigin")
PORT_TUNERS = sorted(TUNERS)             # all eight
#: the tuners whose ask stream does not depend on the batch width: their
#: sessions replay ``run_tuner`` exactly (the population tuners switch to
#: generational batches)
BATCH_INVARIANT = ("random", "grid", "local", "annealing", "surrogate_bo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process, and in every worker it spawns:
    under ``-n 6`` the default pools oversubscribe the host."""
    n = torch.get_num_threads()
    old = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    ref_chaos.uninstall()
    port_chaos.uninstall()


def _trace_of(res) -> list:
    return [(t.config, t.objective, t.valid) for t in res.trials]


def _store_files(root: Path, sid: str) -> dict:
    """A session's journal, its meta without the clock stamps, and its
    published table's bytes."""
    meta = json.loads((root / sid / "meta.json").read_text())
    for k in ("created_at", "updated_at"):
        meta.pop(k)
    tables = {p.name: p.read_bytes() for p in (root / "tables").glob("*")}
    return {"journal": (root / sid / "trials.jsonl").read_bytes(),
            "meta": meta, "tables": tables}


def _kernel_kwargs(cls, **kw) -> dict:
    return {"shape": dict(cls.small_shape), "device": "cpu", "repeats": 1,
            "warmup": 0, **kw}


# --------------------------------------------------------------------- #
# the port's toy sessions == the JAX package's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("tuner", PORT_TUNERS)
@pytest.mark.parametrize("problem", TOYS)
def test_toy_session_matches_the_jax_package(problem, tuner, tmp_path):
    """Same spec (an explicit arch: the default ids differ) through both
    packages' ``run_session`` with a store: the same session id, trial
    sequence, journal bytes, meta and published ``ResultTable`` bytes."""
    kw = dict(problem=problem, tuner=tuner, arch="h100sxm", budget=48,
              seed=5, workers=3)
    rspec, pspec = ref.SessionSpec(**kw), port.SessionSpec(**kw)
    assert rspec.session_id == pspec.session_id
    r = ref.run_session(rspec, store=ref.SessionStore(tmp_path / "r"))
    p = port.run_session(pspec, store=port.SessionStore(tmp_path / "p"))
    assert _trace_of(r) == _trace_of(p)
    assert (_store_files(tmp_path / "r", rspec.session_id)
            == _store_files(tmp_path / "p", pspec.session_id))


def test_spec_defaults_to_the_ports_arch():
    spec = port.SessionSpec(problem="toy_quad", tuner="random")
    assert spec.arch == "h100"
    assert port.SessionSpec.from_json(
        {"problem": "toy_quad", "tuner": "grid"}).arch == "h100"
    assert spec.canonical() == ref.SessionSpec(
        problem="toy_quad", tuner="random", arch="h100").canonical()


# --------------------------------------------------------------------- #
# parallel == serial; exact resume
# --------------------------------------------------------------------- #
def _quad(record=None):
    space = SearchSpace([Param(f"p{i}", tuple(range(8))) for i in range(4)],
                        name="quad")

    def fn(cfg, arch):
        if record is not None:
            record.append(tuple(cfg.values()))
        return 1.0 + sum((cfg[f"p{i}"] - 2) ** 2 for i in range(4))

    return FunctionProblem(space, fn, name="quad")


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("tuner", PORT_TUNERS)
def test_parallel_session_equals_serial(tuner, workers):
    """Any worker count replays one trajectory; the batch-invariant tuners
    replay ``run_tuner``'s exactly."""
    prob = _quad()
    spec = port.SessionSpec(problem="quad", tuner=tuner, budget=40, seed=3,
                            workers=workers)
    par = port.run_session(spec, problem=prob)
    one = port.run_session(port.SessionSpec(problem="quad", tuner=tuner,
                                            budget=40, seed=3, workers=1),
                           problem=prob)
    assert _trace_of(par) == _trace_of(one)
    if tuner in BATCH_INVARIANT:
        serial = run_tuner(TUNERS[tuner](prob.space, seed=3), prob,
                           budget=40, arch="h100")
        assert _trace_of(par) == _trace_of(serial)


@pytest.mark.parametrize("tuner", PORT_TUNERS)
def test_resume_is_exact_and_evaluates_nothing_twice(tuner, tmp_path):
    calls: list = []
    prob = _quad(calls)
    spec = port.SessionSpec(problem="quad", tuner=tuner, budget=60, seed=2,
                            workers=4)
    full = port.run_session(spec, problem=_quad())
    store = port.SessionStore(tmp_path)
    part = port.run_session(spec, problem=prob, store=store, stop_after=25)
    assert store.meta(spec.session_id)["status"] == "interrupted"
    n_first = len(calls)
    assert n_first == len(part.trials) < 60
    res = port.run_session(spec, problem=prob, store=store)   # the resume
    assert _trace_of(res) == _trace_of(full)
    assert len(calls) == 60 == len(set(calls))       # nothing twice
    assert store.meta(spec.session_id)["status"] == "done"


def test_torn_journal_line_is_skipped_and_redone(tmp_path):
    spec = port.SessionSpec(problem="toy_quad", tuner="random", budget=40,
                            seed=1)
    store = port.SessionStore(tmp_path)
    full = port.run_session(spec)
    port.run_session(spec, store=store, stop_after=20)
    path = store._journal_path(spec.session_id)
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[:-1]) + "\n" + lines[-1][:9])  # torn
    assert len(store.load_journal(spec.session_id, _quad().space)) \
        == len(lines) - 1
    res = port.resume_session(spec.session_id, store)
    assert _trace_of(res) == _trace_of(full)
    assert store.meta(spec.session_id)["status"] == "done"


# --------------------------------------------------------------------- #
# the chaos plane and the retry policy
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("salt", ["", "s0g1", "s3g2"])
def test_fault_plan_fires_at_the_same_hits(salt):
    rules = [("eval.hang", {"p": 0.4, "after": 3, "max_fires": 50,
                           "params": {"hang_s": 0.0}}),
             ("journal.append.torn", {"p": 0.2, "params": {"frac": 0.3}})]
    seqs = []
    for mod in (ref_chaos, port_chaos):
        plan = mod.FaultPlan(seed=7, rules=tuple(
            mod.FaultRule(site, **kw) for site, kw in rules))
        assert plan.to_json() == json.loads(json.dumps(plan.to_json()))
        mod.install(plan, salt=salt)
        seqs.append([[mod.fire(site) for _ in range(200)]
                     for site, _ in rules])
        mod.uninstall()
    assert seqs[0] == seqs[1]
    assert any(f is not None for f in seqs[1][0])
    assert set(port_chaos.SITES) == set(ref_chaos.SITES)


@pytest.mark.parametrize("salt,jitter", [("broker", 0.5), ("publish", 0.5),
                                         ("x", 0.0)])
def test_retry_delays_are_the_jax_packages(salt, jitter):
    kw = dict(base_s=0.01, max_s=0.2, jitter=jitter, salt=salt)
    assert list(port_retry.backoff_delays(12, **kw)) \
        == list(ref_retry.backoff_delays(12, **kw))
    slept = {}
    for name, mod in (("ref", ref_retry), ("port", port_retry)):
        got: list = []
        tries = iter(range(4))

        def flaky():
            if next(tries) < 3:
                raise OSError("busy")
            return "ok"

        assert mod.retry_call(flaky, retries=5,
                              retry_on=lambda e: isinstance(e, OSError),
                              sleep=got.append, **kw) == "ok"
        slept[name] = got
    assert slept["ref"] == slept["port"] and len(slept["port"]) == 3


# --------------------------------------------------------------------- #
# brokers: the lease protocol, in both backends
# --------------------------------------------------------------------- #
@pytest.fixture(params=["memory", "sqlite"])
def broker(request, tmp_path):
    b = (port.MemoryBroker() if request.param == "memory"
         else port.SQLiteBroker(tmp_path / "queue.db"))
    yield b
    b.close()


def test_broker_lease_heartbeat_complete_fail(broker):
    """Submit, lease (one holder), heartbeat, complete once, fail with a
    requeue, and the attempts cap turning into a failure."""
    payload = {"problem": "toy_quad", "archs": ["h100sxm"], "rows": [1],
               "sessions": ["sid-a"]}
    jid = broker.submit(payload)
    got = broker.lease("w1", lease_s=30.0)
    assert got is not None and got[0] == jid and got[1]["rows"] == [1]
    assert broker.lease("w2", lease_s=30.0) is None        # held
    assert broker.heartbeat(jid, "w1", 30.0)
    assert not broker.heartbeat(jid, "w2", 30.0)           # not its lease
    assert broker.counts()["leased"] == 1
    assert [j["sessions"] for j in broker.in_flight()] == [["sid-a"]]
    assert broker.complete(jid, "w1", {"arch_trials": {"h100sxm": []}})
    assert not broker.complete(jid, "w1", {"arch_trials": {}})  # once
    done, failed = broker.collect()
    assert list(done) == [jid] and not failed

    jid2 = broker.submit(payload)
    for i in range(broker.max_attempts):
        assert broker.lease(f"w{i}", lease_s=30.0)[0] == jid2
        assert broker.fail(jid2, f"w{i}", "boom")
    done, failed = broker.collect()
    assert not done and [f["id"] for f in failed] == [jid2]
    assert failed[0]["attempts"] == broker.max_attempts


def test_broker_campaign_matches_the_in_process_run(broker, tmp_path):
    """Detached ``BrokerWorker`` loops (threads here) serve a campaign:
    trajectories and journals equal the in-process campaign's."""
    import threading
    specs = port.Campaign.grid(["toy_rastrigin"], ["genetic", "random"],
                               archs=["h100"], seeds=[0], budget=24).specs
    want = port.run_campaign(specs, port.SessionStore(tmp_path / "a"))
    stop = threading.Event()
    fleet = [port.BrokerWorker(broker, workers=2, poll_s=0.005)
             for _ in range(2)]
    threads = [threading.Thread(target=w.run, kwargs={"stop": stop},
                                daemon=True) for w in fleet]
    for t in threads:
        t.start()
    try:
        got = port.run_campaign(specs, port.SessionStore(tmp_path / "b"),
                                broker=broker)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    for spec in specs:
        sid = spec.session_id
        assert _trace_of(want[sid]) == _trace_of(got[sid])
        assert ((tmp_path / "a" / sid / "trials.jsonl").read_bytes()
                == (tmp_path / "b" / sid / "trials.jsonl").read_bytes())
    snap = port_metrics.fleet_snapshot(broker)
    assert snap["queue"] == broker.counts()
    assert sum(w.get("jobs", 0) for w in snap["workers"].values()) >= 1


def test_fleet_aggregation_is_the_jax_packages():
    samples = [{"worker": w, "name": n, "value": v, "kind": k}
               for w, n, v, k in [("a", "jobs", 1, "counter"),
                                  ("a", "jobs", 1, "counter"),
                                  ("a", "configs_per_s", 5.0, "gauge"),
                                  ("a", "configs_per_s", 7.0, "gauge"),
                                  ("b", "evals", 12, "counter")]]
    assert port_metrics.aggregate_samples(samples) \
        == ref_metrics.aggregate_samples(samples)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def test_cli_submit_status_resume_campaign(tmp_path, capsys):
    """On ``toy_quad``: submit stops, status says so, resume finishes, and
    the journal equals the JAX package's CLI run of the same session; a
    campaign grid ends every session done."""
    args = ["--problem", "toy_quad", "--tuner", "genetic", "--arch",
            "h100sxm", "--budget", "60", "--seed", "4", "--workers", "3"]
    stores = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        store = str(tmp_path / name)
        assert cli(["submit", *args, "--store", store,
                    "--stop-after", "30"]) == 0
        sid = capsys.readouterr().out.split()[1]
        assert cli(["status", "--store", store, "--json"]) == 0
        row = json.loads(capsys.readouterr().out)
        assert row["status"] == "interrupted" and 30 <= row["evaluated"] < 60
        assert cli(["resume", sid, "--store", store]) == 0
        assert cli(["status", sid, "--store", store, "--json"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert json.loads(out[-1])["status"] == "done"
        stores[name] = _store_files(Path(store), sid)
    assert stores["ref"] == stores["port"]

    assert port_cli(["campaign", "--problems", "toy_quad,toy_rastrigin",
                     "--tuners", "random,grid", "--archs", "h100sxm",
                     "--seeds", "0,1", "--budget", "20", "--store",
                     str(tmp_path / "c")]) == 0
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith("toy_")]
    assert len(rows) == 8 and all(" done " in r for r in rows)
    assert port_cli(["doctor", "--store", str(tmp_path / "c"),
                     "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["servedb"] is None


def test_cli_runs_a_toy_with_device_cpu(tmp_path, capsys):
    """``--device cpu`` reaches every problem's kwargs; a toy, which runs
    nowhere, ignores it: a toy's submit, and a campaign mixing a toy with
    a kernel problem (its arch the cost model's), end done."""
    assert port_cli(["submit", "--problem", "toy_quad", "--tuner", "random",
                     "--arch", "h100sxm", "--device", "cpu", "--budget",
                     "8", "--store", str(tmp_path / "s")]) == 0
    sid = capsys.readouterr().out.split()[1]
    assert port_cli(["status", sid, "--store", str(tmp_path / "s"),
                     "--json"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "status"] == "done"
    assert port_cli(["campaign", "--problems", "toy_quad,conv2d_h100",
                     "--tuners", "random", "--archs", "h100sxm",
                     "--device", "cpu", "--budget", "8", "--store",
                     str(tmp_path / "c")]) == 0
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith(("toy_quad", "conv2d_h100"))]
    assert len(rows) == 2 and all(" done " in r for r in rows)
    assert port.make_problem("toy_quad", device="cpu").name == "toy_quad"


def test_cli_without_a_card_or_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["submit", "--problem", "gemm_h100", "--tuner", "random",
                  "--budget", "4", "--store", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["campaign", "--problems", "gemm_h100", "--tuners",
                  "random", "--archs", "h100sxm", "--budget", "4",
                  "--store", str(tmp_path / "c")])


def test_module_entry_point_is_guarded():
    """Importing ``__main__`` runs nothing (a package walk, a spawned
    worker); ``python -m`` runs the CLI."""
    import importlib
    importlib.import_module("repro_torch.orchestrator.__main__")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.orchestrator",
                        "--help"], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "campaign" in r.stdout
    for cmd in ("servedb", "surrogate", "lint"):
        assert cmd in r.stdout.split("positional")[0]


# --------------------------------------------------------------------- #
# the warm start and the surrogate screen run as the JAX package's
# --------------------------------------------------------------------- #
def test_warm_start_and_screen_are_refused():
    """The name is older than both seams: a spec's ``warm_start`` runs (the
    JAX package's session, warm rows first), and so does a ``screen=`` (a
    surrogate screen: the JAX package's trace, estimated trials and all)."""
    spec = port.SessionSpec(problem="toy_quad", tuner="random", budget=8,
                            warm_start=[1, 2])
    assert "warm_start" in spec.canonical()
    rspec = ref.SessionSpec(problem="toy_quad", tuner="random", budget=8,
                            arch="h100", warm_start=[1, 2])
    assert spec.session_id == rspec.session_id
    res = port.run_session(spec)
    assert _trace_of(res) == _trace_of(ref.run_session(rspec))
    space = port.make_problem("toy_quad").space
    assert [space.flat_index(t.config) for t in res.trials[:2]] == [1, 2]
    from repro.core import surrogate as ref_surrogate
    from repro_torch.core import surrogate
    rows = list(range(0, space.cardinality, 7))
    objs = [1.0 + sum((c[f"p{i}"] - 2) ** 2 for i in range(4))
            for c in map(space.from_flat_index, rows)]
    models = []
    for mod, sp in ((surrogate, space),
                    (ref_surrogate, ref.make_problem("toy_quad").space)):
        h = mod.Harvest("toy_quad", sp, archs=("h100", "h100sxm"))
        h.add_rows(rows, "h100sxm", objs)
        models.append(mod.SurrogateScreen(
            mod.KernelSurrogate.fit(h.build(), params={"n_trees": 12}),
            sp, "h100", measure_frac=0.25))
    kw = dict(problem="toy_quad", tuner="genetic", arch="h100", budget=16,
              seed=2, workers=2)
    got = port.run_session(port.SessionSpec(**kw), screen=models[0])
    want = ref.run_session(ref.SessionSpec(**kw), screen=models[1])
    assert _trace_of(got) == _trace_of(want)
    assert [t.info for t in got.trials] == [t.info for t in want.trials]
    assert models[0].n_estimated == models[1].n_estimated > 0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("tuner", ["local", "annealing", "diffevo", "pso",
                                   "surrogate_bo"])
def test_new_tuner_session_stops_and_resumes_as_the_jax_packages(
        tuner, warm, tmp_path):
    """Each tuner the warm-start seam came with, cold and warm-started on
    a toy: stopped at a batch boundary and resumed, the journal is the
    uninterrupted run's byte for byte, and both are the JAX package's."""
    space = port.make_problem("toy_quad").space
    opt = space.flat_index({f"p{i}": 2 for i in range(4)})
    kw = dict(problem="toy_quad", tuner=tuner, arch="h100sxm", budget=24,
              seed=11, workers=2,
              warm_start=[opt + 3, opt, opt + 3, opt + 16] if warm else None)
    pspec, rspec = port.SessionSpec(**kw), ref.SessionSpec(**kw)
    assert pspec.session_id == rspec.session_id
    full = port.run_session(pspec, store=port.SessionStore(
        tmp_path / "full", clock=lambda: 0.0))
    cut = port.SessionStore(tmp_path / "cut", clock=lambda: 0.0)
    part = port.run_session(pspec, store=cut, stop_after=5)
    assert cut.meta(pspec.session_id)["status"] == "interrupted"
    assert len(part.trials) < 24
    resumed = port.resume_session(pspec.session_id, cut)
    assert _trace_of(resumed) == _trace_of(full)
    journal = (tmp_path / "cut" / pspec.session_id / "trials.jsonl")
    assert journal.read_bytes() == (tmp_path / "full" / pspec.session_id
                                    / "trials.jsonl").read_bytes()
    r = ref.run_session(rspec, store=ref.SessionStore(
        tmp_path / "ref", clock=lambda: 0.0))
    assert _trace_of(r) == _trace_of(full)
    assert journal.read_bytes() == (tmp_path / "ref" / rspec.session_id
                                    / "trials.jsonl").read_bytes()
    if warm:
        assert [space.flat_index(t.config) for t in full.trials[:3]] \
            == [opt + 3, opt, opt + 16]


# --------------------------------------------------------------------- #
# worker pools: modes, spawned processes, faults
# --------------------------------------------------------------------- #
def test_pool_mode_follows_the_arch():
    prob = GemmProblem(**_kernel_kwargs(GemmProblem))
    assert port.WorkerPool(prob, "cpu").mode == "process"
    assert port.WorkerPool(prob, "h100sxm").mode == "thread"
    assert port.WorkerPool(_quad(), "h100").mode == "thread"
    assert port.WorkerPool(prob, "cpu", mode="thread").mode == "thread"
    assert port_workers.measures(prob, "cpu")
    assert not port_workers.measures(prob, "h100pcie")
    assert port_workers.measuring_devices(prob) == 1
    with pytest.raises(ValueError, match="rayon"):
        port.WorkerPool(prob, "cpu", mode="rayon")
    with pytest.raises(ValueError, match="not 'h100'"):
        port.WorkerPool(prob, "h100")           # the host is not the card


def test_kernel_problem_pickles_as_its_constructor():
    import pickle
    prob = GemmProblem(**_kernel_kwargs(GemmProblem))
    prob.make_runner(prob.space.sample_distinct(1, 0)[0])   # inputs made
    blob = pickle.dumps(prob)
    assert len(blob) < 1024                     # no tensors, no closures
    again = pickle.loads(blob)
    assert again is pickle.loads(blob)          # one live copy a process
    assert again.shape == prob.shape and again.repeats == 1
    assert again.space.cardinality == prob.space.cardinality


@pytest.mark.parametrize("device,cards,rebuilt", [
    ("cuda", [0, 1, 2, 3], "cuda"), ("cuda:2", [2], "cuda:2")])
def test_a_problem_measures_on_the_card_it_names(device, cards, rebuilt,
                                                 monkeypatch):
    """On a host of four cards (faked: no card is touched), a problem on
    plain ``cuda`` measures in one process a card, each pinned to its own,
    and rebuilds in the child on the card it was pinned to; one that names
    ``cuda:2`` measures in one process, pinned to card 2, and rebuilds
    there, so the trial's recorded device is the card it ran on."""
    import pickle

    from repro_torch import device as port_device
    from repro_torch.kernels import common
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(port_device, "arch_id", lambda dev: "h100")
    monkeypatch.setattr(common, "_REBUILT", {})
    prob = GemmProblem(**_kernel_kwargs(GemmProblem, device=device))
    assert port_workers.measuring_cards(prob) == cards
    pool = port.WorkerPool(prob, "h100", workers=4)
    assert pool.mode == "process"
    assert pool._size("process", prob, "h100") == len(cards)
    again = pickle.loads(pickle.dumps(prob))
    assert again.device == torch.device(rebuilt)
    pinned: list = []
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    monkeypatch.setattr(port_workers, "_DEVICE", None)
    import multiprocessing
    slots = multiprocessing.get_context("spawn").Value("i", 1)
    port_workers._init_worker(slots, cards, False)
    assert pinned == [cards[1 % len(cards)]] == [port_workers._DEVICE]


def test_arch_shared_evaluation_refuses_a_measured_arch():
    """The campaign's partition owns the measured arch's batch; the pool's
    arch-shared sweep refuses it rather than keep a second path."""
    prob = AttentionProblem(**_kernel_kwargs(AttentionProblem))
    rows = [int(r) for r in prob.space.compiled().valid_rows[:3]]
    with port.WorkerPool(prob, "h100sxm", workers=1) as pool:
        with pytest.raises(ValueError, match="measured arch"):
            pool.evaluate_rows(rows, archs=["cpu", "h100sxm"])
        shared = pool.evaluate_rows(rows, archs=["h100sxm", "h100pcie"])
    assert [len(v) for v in shared.values()] == [3, 3]


@pytest.mark.parametrize("cls", [GemmProblem, HotspotProblem],
                         ids=["gemm_h100", "hotspot_h100"])
def test_measured_grid_across_two_runs_publishes_the_whole_table(cls,
                                                                 tmp_path):
    """A kernel problem measured on the host, in one spawned process (the
    one device), by a grid session stopped halfway and resumed: the
    published table holds every admitted config, each once, none
    invalid, and the resumed run measured only what the journal lacked."""
    kw = _kernel_kwargs(cls)
    prob = cls(**kw)
    n = len(prob.space.compiled().valid_rows)
    spec = port.SessionSpec(problem=prob.name, tuner="grid", arch="cpu",
                            budget=n, workers=4, problem_kwargs=kw)
    store = port.SessionStore(tmp_path)
    with trace.tracing():
        port.run_session(spec, store=store, stop_after=n // 2)
        first = [e for e in trace.events() if e["name"] == "kernel.measure"]
    done = store.meta(spec.session_id)["evaluated"]
    assert n // 2 <= done < n and len(first) == done
    assert len({e["args"]["pid"] for e in first}) == 1
    with trace.tracing():
        port.resume_session(spec.session_id, store)
        second = [e for e in trace.events() if e["name"] == "kernel.measure"]
    assert len(second) == n - done
    table = store.tables.get(prob.name, "cpu", f"session_{spec.session_id}")
    assert len(table.configs) == len(set(table.configs)) == n
    assert all(math.isfinite(o) for o in table.objectives)
    recs = store.load_journal(spec.session_id, prob.space, "cpu")
    assert sorted(k for k, _ in recs) == sorted(
        int(r) for r in prob.space.compiled().valid_rows)
    assert all(t.info["repeats"] == 1 for _, t in recs)


def test_campaign_keeps_the_measured_arch_off_the_models_endpoints(tmp_path,
                                                                   monkeypatch):
    """``cpu`` (measured) beside ``h100sxm`` and ``h100pcie`` (the model):
    the model's ids share one sweep, the measured rows go to the pool's
    measuring process, each once for both of its sessions, and never to
    ``trials_for_rows_archs``."""
    seen: list = []
    orig = AttentionProblem.trials_for_rows_archs

    def spy(self, rows, archs):
        seen.append(tuple(archs))
        return orig(self, rows, archs)

    monkeypatch.setattr(AttentionProblem, "trials_for_rows_archs", spy)
    kw = _kernel_kwargs(AttentionProblem)
    camp = port.Campaign.grid(["flash_attention_h100"], ["random", "genetic"],
                              archs=["cpu", "h100sxm", "h100pcie"], seeds=[0],
                              budget=24, workers=1, problem_kwargs=kw)
    store = port.SessionStore(tmp_path)
    with trace.tracing():
        out = camp.run(store, interleave=True, workers=1)
        measured = [e for e in trace.events()
                    if e["name"] == "kernel.measure"]
    assert camp.done(store) and len(out) == 6
    assert seen and all("cpu" not in a for a in seen)
    assert {a for a in seen} == {("h100sxm", "h100pcie")}
    asked = set()
    for spec in camp.specs:
        recs = store.load_journal(spec.session_id,
                                  AttentionProblem(**kw).space, spec.arch)
        measured_info = [t for _, t in recs if "median_s" in t.info]
        if spec.arch == "cpu":
            asked |= {k for k, _ in recs}
            assert len(measured_info) == len(recs) == 24
        else:
            assert not measured_info
    assert len(measured) == len(asked)


def test_partition_puts_the_measured_arch_alone():
    prob = AttentionProblem(**_kernel_kwargs(AttentionProblem))
    need = {5: {"cpu", "h100sxm", "h100pcie"}, 9: {"h100sxm"}, 11: {"cpu"}}
    got = _partition_archsets(need, ["cpu", "h100sxm", "h100pcie"], True,
                              prob)
    assert got == {("h100sxm", "h100pcie"): [5], ("cpu",): [5, 11],
                   ("h100sxm",): [9]}


def test_worker_death_poisons_only_its_config():
    """Two processes, and a config that kills its worker: a death under
    several in-flight attempts charges none of them, so only the killer
    ends poisoned, and the session completes."""
    spec = port.SessionSpec(problem="killer", tuner="grid", budget=4,
                            workers=2)
    res = port.run_session(spec, problem=WorkerKiller(), mode="process",
                           max_retries=1)
    bad = [t for t in res.trials if not t.valid]
    assert [t.config["a"] for t in bad] == [1]
    assert bad[0].info["poison"] is True and bad[0].info["attempts"] == 2
    assert sorted(t.objective for t in res.trials if t.valid) \
        == [1.0, 3.0, 4.0]


def test_batch_after_a_broken_pool_is_not_lost():
    """The last attempt of a batch killed its worker, leaving the pool
    broken; the next batch's submit must rebuild it, not raise
    ``BrokenProcessPool`` (the JAX package's race)."""
    with port.WorkerPool(WorkerKiller(), "h100", workers=1, mode="process",
                         max_retries=0) as pool:
        first = pool.evaluate([{"a": 1}])
        assert first[0].info["poison"] is True
        time.sleep(0.2)                  # the pool notices its dead worker
        again = pool.evaluate([{"a": 0}, {"a": 2}, {"a": 3}])
        assert [t.objective for t in again] == [1.0, 3.0, 4.0]
        ex = pool._exs["process"]        # a broken pool refuses submits
        ex._broken = "a worker died"
        later = pool.evaluate([{"a": 3}])
        assert later[0].objective == 4.0


def test_supervisor_gives_each_slot_its_own_card(tmp_path, monkeypatch,
                                                 capsys):
    """Three workers asked on two cards: the fleet is clamped to two,
    the clamp printed, and no two slots share a card."""
    envs = []

    class _Proc:
        pid = 1

        def poll(self):
            return None

    def popen(cmd, env, stdout, stderr):
        envs.append((cmd, env))
        return _Proc()

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    sup = port.FleetSupervisor(port.SQLiteBroker(tmp_path / "q.db"),
                               min_workers=3, max_workers=3, devices=2)
    assert (sup.min_workers, sup.max_workers, len(sup.slots)) == (2, 2, 2)
    assert "3 workers asked, 2 (one per card)" in capsys.readouterr().err
    for slot in sup.slots:
        sup._spawn_subprocess(slot, f"w{slot.idx}")
    assert [e["CUDA_VISIBLE_DEVICES"] for _, e in envs] == ["0", "1"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    envs.clear()
    sup._spawn_subprocess(sup.slots[1], "w1")
    assert envs[0][1]["CUDA_VISIBLE_DEVICES"] == "5"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert envs[0][0][1:3] == ["-m", "repro_torch.orchestrator"]
    none = port.FleetSupervisor(port.SQLiteBroker(tmp_path / "r.db"),
                                devices=0)
    envs.clear()
    none._spawn_subprocess(none.slots[0], "w")
    assert "CUDA_VISIBLE_DEVICES" not in envs[0][1]


# --------------------------------------------------------------------- #
# the commands the CLI's docstring and the README quote
# --------------------------------------------------------------------- #
def _quoted_commands() -> list[str]:
    """Every ``python -m repro_torch.orchestrator ...`` command quoted in
    the CLI's docstring and the README, continuation lines joined."""
    import re

    import repro_torch.orchestrator.cli as cli_mod
    out = set()
    for text in (cli_mod.__doc__, (ROOT / "README.md").read_text()):
        text = re.sub(r"\\\s*\n\s*", " ", text)
        for line in text.splitlines():
            line = re.sub(r"^\s*(PYTHONPATH=\S+\s+)?", "", line)
            if line.startswith("python -m repro_torch.orchestrator "):
                out.add(line.split("#", 1)[0].strip())
    return sorted(out)


QUOTED = _quoted_commands()


@pytest.mark.parametrize("cmd", QUOTED)
def test_quoted_command_matches_the_cli(cmd, capsys):
    """Each quoted subcommand exists and takes each quoted flag."""
    import re
    sub = cmd.split()[3]
    with pytest.raises(SystemExit) as e:
        port_cli([sub, "--help"])
    assert e.value.code == 0
    help_text = capsys.readouterr().out
    for flag in re.findall(r"(--[a-z][a-z0-9-]*)", cmd):
        assert flag in help_text, f"{flag} quoted but {sub!r} lacks it"
    assert len(QUOTED) >= 10


# --------------------------------------------------------------------- #
# a measuring process started before the parent builds its problem
# --------------------------------------------------------------------- #
def test_an_early_measuring_process_is_adopted(monkeypatch, capsys):
    """``start_early`` spawns the process a pool of one on the first card
    would build; the pool adopts it and measures through it (on the host
    the child finds no card and pins nothing, so the cards are faked)."""
    monkeypatch.setattr(port_workers, "measuring_cards", lambda p: [0])
    prob = GemmProblem(**_kernel_kwargs(GemmProblem))
    port_workers.start_early(None, trace.is_enabled())
    early = port_workers._EARLY[0]
    pool = port_workers.WorkerPool(prob, "cpu", workers=4)
    try:
        got = pool.evaluate(prob.space.sample_distinct(3, 0))
        assert pool._exs["process"] is early
        assert port_workers._EARLY is None
        assert len(got) == 3 and all(t.ok for t in got)
    finally:
        pool.close()
    assert "adopted the measuring process" in capsys.readouterr().err


class _FakeExecutor:
    def __init__(self):
        self.shut = False

    def shutdown(self, wait=True, cancel_futures=False):
        self.shut = True


@pytest.mark.parametrize("early_card,tracing,n,cards,adopted", [
    (None, False, 1, [0], True), (None, False, 1, [0, 1], True),
    (1, False, 1, [1], True), (None, True, 1, [0], False),
    (None, False, 2, [0, 1], False), (1, False, 1, [0, 1], False),
    (None, False, 1, [], False)])
def test_an_early_process_only_a_matching_pool_adopts(
        early_card, tracing, n, cards, adopted, monkeypatch):
    """Adopted only by a pool of one process pinned to the early one's card
    and tracing as it does; otherwise shut down, never kept."""
    ex = _FakeExecutor()
    monkeypatch.setattr(port_workers, "_EARLY", (ex, early_card, tracing))
    got = port_workers._adopt_early(n, cards, False)
    assert (got is ex) == adopted and ex.shut == (not adopted)
    assert port_workers._EARLY is None


def test_the_cli_starts_a_measuring_process_early_only_to_measure(
        monkeypatch, tmp_path):
    """``submit``, ``resume`` and ``campaign`` start one where a kernel is
    timed on a card: not for the model's ids, ``--device cpu``, a toy,
    ``--mode thread`` or a host with no NVIDIA device."""
    from repro_torch.orchestrator import cli as port_cli_mod
    calls: list = []
    nodes = ["/dev/nvidia0"]
    monkeypatch.setattr("glob.glob", lambda pat: list(nodes))
    monkeypatch.setattr(port_workers, "start_early",
                        lambda card, tracing: calls.append(card))
    early = port_cli_mod._start_measuring_early
    early(["gemm_h100"], ["h100"], {}, "auto")
    early(["gemm_h100"], ["h100"], {"device": "cuda:1"}, "process")
    early(["flash_attention_h100"], ["h100", "h100sxm"], {"device": "cuda"},
          "auto")
    assert calls == [None, 1, None]
    for args in ((["gemm_h100"], ["h100sxm", "h100pcie"], {}, "auto"),
                 (["gemm_h100"], ["cpu"], {"device": "cpu"}, "auto"),
                 (["toy_quad"], ["h100"], {}, "auto"),
                 (["gemm_h100"], ["h100"], {}, "thread")):
        early(*args)
    nodes.clear()
    early(["gemm_h100"], ["h100"], {}, "auto")
    assert calls == [None, 1, None]
    # the CLI's submit asks for it before it builds the problem
    monkeypatch.setattr(port_cli_mod, "_start_measuring_early",
                        lambda *a: calls.append(a))
    port_cli(["submit", "--problem", "toy_quad", "--tuner", "random",
              "--budget", "4", "--store", str(tmp_path)])
    assert calls[-1] == (["toy_quad"], ["h100"], {}, "auto")
