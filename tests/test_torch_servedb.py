"""The port's find-DB (``repro_torch.servedb``) held against the JAX
package's (``repro.servedb``) on the CPU: the snapshot grammar and its
bytes, atomic publish under the chaos sites, the publish lock, quarantine,
the degradation chain's tiers and their order, never raising, staleness,
hot reload, distillation from a session store (the same ``toy_quad``
sessions in both packages' stores distill to equal tables), the static
floor (each entry its op's ``DEFAULT_CONFIG``), the retry policy, doctor
and the CLI; and the port's own choices: a cost-model lookup measures
nothing and never touches CUDA, a spec that names the card distills on a
host without one, and a lookup from a published snapshot imports neither
torch nor JAX."""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.servedb as ref  # noqa: E402
from repro.core import retry as ref_retry  # noqa: E402
from repro.orchestrator import chaos as ref_chaos  # noqa: E402
from repro.orchestrator.runner import run_session as ref_run  # noqa: E402
from repro.orchestrator.session import SessionSpec as RefSpec  # noqa: E402
from repro.orchestrator.store import SessionStore as RefStore  # noqa: E402
from repro.servedb import distill as ref_distill  # noqa: E402
from repro.servedb import lookup as ref_lookup  # noqa: E402
from repro.servedb import snapshot as ref_snap  # noqa: E402

import repro_torch.servedb as port  # noqa: E402
from repro_torch.core import retry as port_retry  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.orchestrator import chaos  # noqa: E402
from repro_torch.orchestrator.cli import main as cli_main  # noqa: E402
from repro_torch.orchestrator.registry import (PROBLEM_PATHS,  # noqa: E402
                                               make_problem)
from repro_torch.orchestrator.runner import run_session  # noqa: E402
from repro_torch.orchestrator.session import SessionSpec  # noqa: E402
from repro_torch.orchestrator.store import SessionStore  # noqa: E402
from repro_torch.servedb import snapshot as snap_mod  # noqa: E402
from repro_torch.servedb.distill import (REGISTRY_NAME,  # noqa: E402
                                         build_snapshot, load_binary)
from repro_torch.servedb.lookup import _best_entry  # noqa: E402
from repro_torch.servedb.snapshot import (SNAPSHOT_NAME, load,  # noqa: E402
                                          publish, shape_distance, shape_key,
                                          verify_dir)

ROOT = Path(__file__).resolve().parents[1]
#: the toys' sessions, under arch ids both packages accept
TOY_CELLS = (("toy_quad", "h100sxm"), ("toy_quad", "h100pcie"),
             ("toy_rastrigin", "h100sxm"))


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.uninstall()
    ref_chaos.uninstall()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(shape, config, objective=1.0, protocol="session_x"):
    return {"shape": shape, "config": config, "objective": objective,
            "protocol": protocol, "trials": 10}


def _snap(mod=port, entries=None, heuristic=None, ttl_s=None):
    group = {"param_names": ["a", "b"], "heuristic": heuristic,
             "entries": entries or []}
    return mod.Snapshot(tables={"k": {"h100": group}}, ttl_s=ttl_s)


# --------------------------------------------------------------------- #
# snapshot grammar + atomic publish
# --------------------------------------------------------------------- #
def test_publish_load_roundtrip(tmp_path):
    snap = _snap(entries=[_entry({"n": 64}, {"a": 1, "b": 2})])
    path = publish(snap, tmp_path)
    assert path.name == SNAPSHOT_NAME
    got, problems = load(tmp_path)
    assert problems == []
    assert got.generation == 1
    assert got.tables == snap_mod._canonical_tables(snap.tables)
    publish(snap, tmp_path)
    got2, _ = load(tmp_path)
    assert got2.generation == 2 and got2.tables == got.tables
    # the JAX package reads the port's snapshot as its own
    rgot, rproblems = ref_snap.load(tmp_path)
    assert rproblems == [] and rgot.generation == 2
    assert rgot.tables == got.tables


def test_publish_is_byte_deterministic_and_the_references():
    entries = [_entry({"n": 64}, {"a": 1}), _entry({"n": 8}, {"a": 2})]
    a = _snap(entries=entries)
    b = _snap(entries=entries[::-1])
    r = _snap(ref, entries=entries)
    for s in (a, b, r):
        s.generation, s.created_at = 3, 123.0
    assert a.to_bytes() == b.to_bytes() == r.to_bytes()


CORRUPTERS = {
    "truncate": lambda raw: raw[: len(raw) // 2],
    "bitflip": lambda raw: raw[:50] + bytes([raw[50] ^ 0x20]) + raw[51:],
    "not_json": lambda raw: b"not json at all",
    "bad_magic": lambda raw: b'{"header": {"magic": "something-else"}}',
}


@pytest.mark.parametrize("corrupter", sorted(CORRUPTERS))
def test_corrupt_snapshot_quarantines_without_raising(tmp_path, corrupter):
    publish(_snap(entries=[_entry({}, {"a": 1})]), tmp_path)
    p = tmp_path / SNAPSHOT_NAME
    p.write_bytes(CORRUPTERS[corrupter](p.read_bytes()))
    got, problems = load(tmp_path)          # must not raise
    assert got is None
    assert problems and "quarantined" in problems[0]
    assert not p.exists()
    assert list((tmp_path / "quarantine").glob("*.bad"))
    report = verify_dir(tmp_path)
    assert not report["ok"] and report["quarantined"]


def test_binary_checksum_failure_disables_binary_only(tmp_path):
    publish(_snap(entries=[_entry({}, {"a": 1})]), tmp_path,
            binary_bytes=b"not-an-npz-but-checksummed")
    next(tmp_path.glob("tables-g*.npz")).write_bytes(b"rotted")
    got, problems = load(tmp_path)
    assert got is not None and got.binary is None
    assert problems and "binary" in problems[0]


def test_crash_between_temp_and_rename_preserves_old_snapshot(tmp_path):
    publish(_snap(entries=[_entry({}, {"a": 1})]), tmp_path)
    before = (tmp_path / SNAPSHOT_NAME).read_bytes()
    chaos.install(chaos.FaultPlan(seed=3, rules=[
        chaos.FaultRule(chaos.SERVEDB_PUBLISH_CRASH, p=1.0, max_fires=1)]))
    with pytest.raises(BaseException):
        publish(_snap(entries=[_entry({}, {"a": 2})]), tmp_path)
    assert (tmp_path / SNAPSHOT_NAME).read_bytes() == before
    assert any("temp" in p for p in verify_dir(tmp_path)["problems"])
    publish(_snap(entries=[_entry({}, {"a": 2})]), tmp_path)
    got, problems = load(tmp_path)
    assert problems == []
    assert got.tables["k"]["h100"]["entries"][0]["config"] == {"a": 2}


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_site_is_detected(tmp_path, mode):
    chaos.install(chaos.FaultPlan(seed=0, rules=[
        chaos.FaultRule(chaos.SERVEDB_SNAPSHOT_CORRUPT, p=1.0, max_fires=1,
                        params={"mode": mode, "frac": 0.5})]))
    publish(_snap(entries=[_entry({}, {"a": 1})]), tmp_path)
    chaos.uninstall()
    got, problems = load(tmp_path)
    assert got is None and "quarantined" in problems[0]


def test_publish_lock_serializes_and_breaks_dead_holders(tmp_path):
    snap = _snap(entries=[_entry({}, {"a": 1})])
    errs = []

    def contend():
        try:
            publish(snap, tmp_path)
        except Exception as e:              # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=contend) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert load(tmp_path)[0].generation == 4
    (tmp_path / "publish.lock").write_text("999999999\n")
    publish(snap, tmp_path)
    assert load(tmp_path)[0].generation == 5


# --------------------------------------------------------------------- #
# the degradation chain, answer for answer the JAX package's
# --------------------------------------------------------------------- #
def _chain_db(mod, root, **kw):
    snap = _snap(mod, entries=[
        _entry({"n": 64}, {"a": 1, "b": 1}, objective=0.5),
        _entry({"n": 256}, {"a": 2, "b": 2}, objective=0.7)],
        heuristic={"a": 9, "b": 9}, **kw)
    snap.tables["k"]["h100sxm"] = {
        "param_names": ["a", "b"], "heuristic": None,
        "entries": [_entry({"n": 64}, {"a": 7, "b": 7})]}
    mod.publish(snap, root)
    return mod.ServeDB(root, use_cost_model=False, reload_every_s=0.0)


#: (kernel, shape, arch) -> (tier, detail, config); gemm_h100 and
#: flash_attention_h100 have no table: the static floor answers
CHAIN = [
    (("k", {"n": 64}, "h100"), ("exact", "session_x", {"a": 1, "b": 1})),
    (("k", {"n": 96}, "h100"), ("nearest", "session_x", {"a": 1, "b": 1})),
    (("k", {"n": 300}, "h100pcie"),
     ("heuristic", "heuristic:cross-arch:h100", {"a": 2, "b": 2})),
    (("unknown_kernel", {}, "h100"), ("default", "default:static", {})),
]


def test_chain_order_exact_nearest_heuristic_default(tmp_path):
    pdb = _chain_db(port, tmp_path / "port")
    rdb = _chain_db(ref, tmp_path / "ref")
    for (kernel, shape, arch), (tier, detail, config) in CHAIN:
        got = pdb.lookup(kernel, shape, arch)
        want = rdb.lookup(kernel, shape, arch)
        assert (got.tier, got.detail, got.config) == (tier, detail, config)
        assert (want.tier, want.detail, want.config) == (tier, detail, config)
        assert (got.matched_shape, got.distance, got.objective) \
            == (want.matched_shape, want.distance, want.objective)
    r = pdb.lookup("k", {"n": 96}, "h100")
    assert r.degraded() and r.matched_shape == {"n": 64} and r.distance > 0
    assert not pdb.lookup("k", {"n": 64}, "h100").degraded()
    for name in ("gemm_h100", "flash_attention_h100"):
        r = pdb.lookup(name, {}, "h100")
        assert (r.tier, r.config) == ("default", port.STATIC_DEFAULTS[name])
    counts = pdb.tier_counts()
    assert counts == {"exact": 2, "nearest": 2, "heuristic": 1,
                      "default": 3}
    assert tuple(counts) == port.TIERS == ref.TIERS


def test_chain_heuristic_distilled_beats_default(tmp_path):
    publish(_snap(entries=[], heuristic={"a": 9, "b": 9}), tmp_path)
    db = port.ServeDB(tmp_path, use_cost_model=False, reload_every_s=0.0)
    r = db.lookup("k", {"n": 1}, "h100")
    assert (r.tier, r.detail, r.config) == ("heuristic",
                                            "heuristic:distilled",
                                            {"a": 9, "b": 9})


def test_nearest_is_deterministic_under_ties():
    e1, e2 = _entry({"n": 32}, {"a": 1}), _entry({"n": 128}, {"a": 2})
    q = {"n": 64}
    assert shape_distance(q, e1["shape"]) == shape_distance(q, e2["shape"])
    for entries in ([e1, e2], [e2, e1]):
        e, d = _best_entry(entries, q)
        assert e["config"] == {"a": 2}
        assert (e, d) == ref_lookup._best_entry(entries, q)


@pytest.mark.parametrize("a,b", [
    ({"n": 64}, {"n": 64}), ({"n": 64}, {"n": 128}), ({"n": 64}, {"n": 1024}),
    ({"n": 64}, {"m": 64}), ({"n": "x"}, {"n": 64}), ({}, {"n": 3}),
    ({"m": 4096, "n": 4096, "k": 4096}, {"m": 2048, "n": 2048, "k": 2048})])
def test_shape_distance_and_key_are_the_references(a, b):
    assert shape_distance(a, b) == ref_snap.shape_distance(a, b)
    assert shape_key(a) == ref_snap.shape_key(a)
    assert math.isfinite(shape_distance(a, b))
    assert shape_distance({"n": 64}, {"n": 128}) \
        < shape_distance({"n": 64}, {"n": 1024})
    assert shape_distance({"n": 64}, {"m": 64}) > 30


def test_lookup_never_raises_even_on_internal_error(tmp_path):
    db = port.ServeDB(tmp_path / "nonexistent", use_cost_model=False,
                      reload_every_s=3600.0)
    assert db.lookup("k", {"n": 1}, "h100").tier == "default"
    db._snapshot = object()
    r = db.lookup("k", {"n": 1}, "h100")
    assert r.tier == "default" and "chain-error" in r.detail


def test_stale_snapshot_degrades_and_flags(tmp_path):
    snap = _snap(entries=[_entry({"n": 64}, {"a": 1, "b": 1})], ttl_s=0.0)
    snap.created_at = 1.0
    publish(snap, tmp_path)
    db = port.ServeDB(tmp_path, use_cost_model=False, reload_every_s=0.0)
    r = db.lookup("k", {"n": 64}, "h100")
    assert r.stale and r.tier == "default"
    db2 = port.ServeDB(tmp_path, use_cost_model=False, reload_every_s=0.0,
                       serve_stale=True)
    r2 = db2.lookup("k", {"n": 64}, "h100")
    assert r2.stale and r2.tier == "exact"
    assert verify_dir(tmp_path)["snapshots"][0]["status"] == "stale"


# --------------------------------------------------------------------- #
# hot reload
# --------------------------------------------------------------------- #
def test_hot_reload_unchanged_snapshot_is_bit_identical(tmp_path):
    db = _chain_db(port, tmp_path)
    queries = [("k", {"n": 64}, "h100"), ("k", {"n": 96}, "h100"),
               ("k", {"n": 1}, "h100pcie"), ("zzz", {}, "h100")]
    before = [db.lookup(*q) for q in queries]
    p = tmp_path / SNAPSHOT_NAME
    p.write_bytes(p.read_bytes())
    assert db.reload(force=True) is False
    after = [db.lookup(*q) for q in queries]
    assert [(b.config, b.tier, b.detail, b.generation) for b in before] \
        == [(a.config, a.tier, a.detail, a.generation) for a in after]


def test_hot_reload_picks_up_new_generation(tmp_path):
    db = _chain_db(port, tmp_path)
    assert db.lookup("k", {"n": 64}, "h100").config == {"a": 1, "b": 1}
    publish(_snap(entries=[_entry({"n": 64}, {"a": 5, "b": 5})]), tmp_path)
    assert db.reload(force=True) is True
    r = db.lookup("k", {"n": 64}, "h100")
    assert r.config == {"a": 5, "b": 5} and r.generation == 2


def test_hot_reload_corrupt_replacement_keeps_serving_old(tmp_path):
    db = _chain_db(port, tmp_path)
    before = db.lookup("k", {"n": 64}, "h100")
    p = tmp_path / SNAPSHOT_NAME
    p.write_bytes(p.read_bytes()[:100])
    db.reload(force=True)
    assert db.problems()
    after = db.lookup("k", {"n": 64}, "h100")
    assert (after.tier, after.config) == (before.tier, before.config)
    _chain_db(port, tmp_path)
    db.reload(force=True)
    restored = db.lookup("k", {"n": 64}, "h100")
    assert (restored.tier, restored.config, restored.detail) \
        == (before.tier, before.config, before.detail)


# --------------------------------------------------------------------- #
# distillation: the same sessions in both packages' stores
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The toys' sessions run by each package into its own store (same
    specs, explicit arch on both sides, so the same session ids)."""
    roots = {}
    for name, spec_cls, store_cls, run in (
            ("port", SessionSpec, SessionStore, run_session),
            ("ref", RefSpec, RefStore, ref_run)):
        root = tmp_path_factory.mktemp(f"store_{name}")
        store = store_cls(root, clock=lambda: 0.0)
        for problem, arch in TOY_CELLS:
            spec = spec_cls(problem=problem, tuner="random", arch=arch,
                            budget=16, seed=0, workers=2)
            store.create(spec)
            run(spec, store=store, mode="thread")
        roots[name] = root
    return roots


def test_distill_equals_the_references(stores, tmp_path):
    snap, binary, problems = build_snapshot(stores["port"])
    rsnap, rbinary, rproblems = ref_distill.build_snapshot(stores["ref"])
    assert problems == rproblems == []
    assert snap.kernels() == ["toy_quad", "toy_rastrigin"]
    assert snap.tables == rsnap.tables
    publish(snap, tmp_path / "p", binary_bytes=binary)
    ref_snap.publish(rsnap, tmp_path / "r", binary_bytes=rbinary)
    got = load_binary(tmp_path / "p", load(tmp_path / "p")[0])
    want = ref_distill.load_binary(tmp_path / "r",
                                   ref_snap.load(tmp_path / "r")[0])
    for kernel in want:
        for arch in want[kernel]:
            g, w = got[kernel][arch], want[kernel][arch]
            assert g["configs"] == w["configs"]
            assert g["shapes"] == w["shapes"]
            assert list(g["rows"]) == list(w["rows"])
            assert list(g["objectives"]) == list(w["objectives"])


def test_distill_serves_campaign_best(stores, tmp_path):
    snap, binary, _ = build_snapshot(stores["port"])
    publish(snap, tmp_path, binary_bytes=binary)
    db = port.ServeDB(tmp_path, use_cost_model=False, reload_every_s=0.0)
    store = SessionStore(stores["port"])
    for kernel, arch in TOY_CELLS:
        r = db.lookup(kernel, {}, arch)
        assert r.tier == "exact"
        table = store.tables.get(kernel, arch, r.detail)
        assert r.objective == table.best()[1]
        assert store.load_spec(r.detail[len("session_"):]).arch == arch


def test_binary_export_roundtrips_to_json_configs(stores, tmp_path):
    snap, binary, _ = build_snapshot(stores["port"])
    assert binary is not None
    publish(snap, tmp_path, binary_bytes=binary)
    loaded, problems = load(tmp_path)
    assert problems == [] and loaded.binary is not None
    bins = load_binary(tmp_path, loaded)
    for kernel, archs in loaded.tables.items():
        for arch, group in archs.items():
            got = bins[kernel][arch]
            assert got["configs"] == [e["config"] for e in group["entries"]]
            assert list(got["objectives"]) == \
                [e["objective"] for e in group["entries"]]


def test_distill_keeps_best_across_sessions(tmp_path):
    store = SessionStore(tmp_path / "s", clock=lambda: 0.0)
    for tuner, budget, seed in (("random", 16, 0), ("genetic", 48, 1)):
        spec = SessionSpec(problem="toy_quad", tuner=tuner, arch="h100sxm",
                           budget=budget, seed=seed, workers=2)
        store.create(spec)
        run_session(spec, store=store, mode="thread")
    snap, _, problems = build_snapshot(tmp_path / "s", with_binary=False)
    assert problems == []
    entries = snap.tables["toy_quad"]["h100sxm"]["entries"]
    assert len(entries) == 1
    objs = [store.tables.get(*key).best()[1]
            for key in store.tables.list_tables()]
    assert entries[0]["objective"] == min(objs)


def test_list_tables_inverts_the_naming_scheme(stores):
    store = SessionStore(stores["port"])
    keys = store.tables.list_tables()
    assert keys == sorted(keys)
    assert keys == RefStore(stores["ref"]).tables.list_tables()
    for problem, arch, protocol in keys:
        t = store.tables.get(problem, arch, protocol)
        assert (t.problem, t.arch) == (problem, arch)


def test_registry_map_is_the_identity_over_the_ports_problems():
    assert REGISTRY_NAME == {n: n for n in (*PROBLEM_PATHS, "toy_quad",
                                            "toy_rastrigin")}
    assert set(port.STATIC_DEFAULTS) == set(PROBLEM_PATHS)


@pytest.mark.parametrize("device", ["cuda", None], ids=["cuda", "default"])
def test_spec_naming_the_card_distills_on_a_host_without_one(device,
                                                             tmp_path):
    """A session spec whose kwargs name the card (or no device, which is
    the card) resolves on the CPU: its table is distilled, not skipped,
    and nothing touches CUDA."""
    kw = {"shape": {"m": 256, "n": 256, "k": 512}}
    if device is not None:
        kw["device"] = device
    spec = SessionSpec(problem="gemm_h100", tuner="random", arch="h100sxm",
                       budget=12, seed=0, workers=1, problem_kwargs=kw)
    store = SessionStore(tmp_path / "s", clock=lambda: 0.0)
    store.create(spec)
    host = make_problem("gemm_h100", **dict(kw, device="cpu"))
    res = run_session(spec, problem=host, store=store, mode="thread")
    snap, _, problems = build_snapshot(tmp_path / "s")
    assert problems == []
    (entry,) = snap.tables["gemm_h100"]["h100sxm"]["entries"]
    assert entry["shape"] == {"m": 256, "n": 256, "k": 512}
    assert entry["objective"] == res.best.objective
    assert entry["config"] == res.best.config
    assert not torch.cuda.is_initialized()


# --------------------------------------------------------------------- #
# the static floor and the cost-model pick
# --------------------------------------------------------------------- #
OPS = {"gemm_h100": "matmul", "flash_attention_h100": "attention",
       "conv2d_h100": "conv2d", "dedisp_h100": "dedisp",
       "expdist_h100": "expdist", "hotspot_h100": "hotspot",
       "nbody_h100": "nbody", "pnpoly_h100": "pnpoly"}


@pytest.mark.parametrize("kernel", sorted(OPS))
def test_static_default_is_the_ops_default_and_admitted(kernel):
    ops = importlib.import_module(f"repro_torch.kernels.{OPS[kernel]}.ops")
    cfg = port.default_config(kernel)
    assert cfg == ops.DEFAULT_CONFIG
    assert cfg is not port.STATIC_DEFAULTS[kernel]     # a copy each call
    space = make_problem(kernel, device="cpu").space
    assert space.name == kernel
    assert set(cfg) == set(space.param_names)
    space.encode(cfg)
    assert space.satisfies(cfg), f"{kernel} default violates a constraint"
    assert port.default_config("no_such_kernel") == {} \
        == ref.default_config("no_such_kernel")


@pytest.mark.parametrize("arch,model_arch", [
    ("h100", "h100sxm"), ("h100sxm", "h100sxm"), ("h100pcie", "h100pcie"),
    ("cpu", None)])
def test_cost_model_lookup_never_measures_nor_touches_cuda(arch, model_arch,
                                                           tmp_path):
    """A kernel with no table: the lookup asks the cost model over a
    sample of the space, built on the CPU, under the query's model id or
    ``h100sxm`` for the card's ``h100``; no kernel launches and CUDA stays
    uninitialised.  Any other arch gets the static floor."""
    shape = {"h": 512, "w": 512, "fh": 15, "fw": 15}
    before = launch_counts()
    db = port.ServeDB(tmp_path, reload_every_s=0.0)
    r = db.lookup("conv2d_h100", shape, arch)
    assert not torch.cuda.is_initialized()
    assert launch_counts() == before
    if model_arch is None:
        assert (r.tier, r.config) == ("default",
                                      port.STATIC_DEFAULTS["conv2d_h100"])
        return
    prob = make_problem("conv2d_h100", shape=shape, device="cpu")
    best = min((t for t in prob.sampled(256, 0, model_arch) if t.valid),
               key=lambda t: t.objective)
    assert (r.tier, r.detail) == ("heuristic", "heuristic:cost-model")
    assert r.config == best.config
    assert prob.space.satisfies(r.config)


def test_toy_cost_model_pick_is_the_references(tmp_path):
    pdb = port.ServeDB(tmp_path / "p", reload_every_s=0.0)
    rdb = ref.ServeDB(tmp_path / "r", reload_every_s=0.0)
    for arch in ("h100", "v5e"):
        got, want = pdb.lookup("toy_quad", {}, arch), \
            rdb.lookup("toy_quad", {}, arch)
        assert (got.tier, got.detail, got.config) \
            == (want.tier, want.detail, want.config) \
            == ("heuristic", "heuristic:cost-model", want.config)


_LOOKUP_ONLY = """
import json, sys
from repro_torch.servedb import ServeDB
db = ServeDB(sys.argv[1], reload_every_s=0.0)
r = db.lookup("gemm_h100", {"m": 4096, "n": 4096, "k": 4096}, "h100")
bad = sorted(m for m in sys.modules
             if m in ("torch", "jax", "repro")
             or m.startswith(("torch.", "jax.", "repro.")))
print(json.dumps({"tier": r.tier, "config": r.config, "bad": bad}))
"""


def test_a_lookup_from_a_snapshot_loads_neither_torch_nor_jax(tmp_path):
    cfg = dict(port.STATIC_DEFAULTS["gemm_h100"], stages=2)
    snap = port.Snapshot(tables={"gemm_h100": {"h100": {
        "param_names": sorted(cfg), "heuristic": None,
        "entries": [_entry({"m": 4096, "n": 4096, "k": 4096}, cfg)]}}})
    publish(snap, tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _LOOKUP_ONLY, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"tier": "exact", "config": cfg, "bad": []}


# --------------------------------------------------------------------- #
# the shared retry policy
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(base_s=0.01, max_s=0.2, salt="x"),
    dict(base_s=0.01, max_s=0.2, salt="y"),
    dict(base_s=0.01, max_s=0.2, jitter=0.0)])
def test_backoff_delays_are_the_references(kw):
    got = list(port_retry.backoff_delays(6, **kw))
    assert got == list(ref_retry.backoff_delays(6, **kw))
    for d, cap in zip(got, [0.01, 0.02, 0.04, 0.08, 0.16, 0.2]):
        assert cap * 0.5 <= d <= cap


def test_retry_call_budget_and_predicate():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("busy")
        return "ok"

    assert port_retry.retry_call(
        flaky, retries=5, retry_on=lambda e: isinstance(e, TimeoutError),
        sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    with pytest.raises(ValueError):
        port_retry.retry_call(
            lambda: (_ for _ in ()).throw(ValueError("no")), retries=5,
            retry_on=lambda e: False, sleep=slept.append)
    with pytest.raises(port_retry.RetryBudgetExceeded, match="the op"):
        port_retry.retry_call(
            lambda: (_ for _ in ()).throw(TimeoutError("busy")), retries=2,
            retry_on=lambda e: True, what="the op", sleep=lambda s: None)


# --------------------------------------------------------------------- #
# doctor + CLI
# --------------------------------------------------------------------- #
def test_doctor_triages_servedb(stores, tmp_path, capsys):
    snap, binary, _ = build_snapshot(stores["port"])
    publish(snap, tmp_path, binary_bytes=binary)
    assert cli_main(["doctor", "--store", str(stores["port"]),
                     "--servedb", str(tmp_path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["servedb"]["ok"]
    assert report["servedb"]["snapshots"][0]["status"] == "ok"
    p = tmp_path / SNAPSHOT_NAME
    p.write_bytes(p.read_bytes()[:-40])
    assert cli_main(["doctor", "--store", str(stores["port"]),
                     "--servedb", str(tmp_path)]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    assert p.exists()                       # doctor is read-only


def test_cli_servedb_build_query_verify(stores, tmp_path, capsys):
    db = str(tmp_path / "db")
    assert cli_main(["servedb", "build", "--store", str(stores["port"]),
                     "--db", db]) == 0
    capsys.readouterr()
    assert cli_main(["servedb", "query", "--db", db, "--kernel", "toy_quad",
                     "--arch", "h100sxm", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["tier"] == "exact" and res["generation"] == 1
    assert cli_main(["servedb", "verify", "--db", db]) == 0
    capsys.readouterr()
    sp = Path(db) / SNAPSHOT_NAME
    sp.write_bytes(sp.read_bytes()[:80])
    assert cli_main(["servedb", "query", "--db", db, "--kernel", "toy_quad",
                     "--arch", "h100sxm", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["tier"] in port.TIERS and res["tier"] != "exact"
    assert cli_main(["servedb", "verify", "--db", db]) == 1
    capsys.readouterr()
    assert cli_main(["servedb", "build", "--db", db]) == 2
    assert cli_main(["servedb", "query", "--db", db]) == 2


# --------------------------------------------------------------------- #
# chip_smoke.py's servedb phase, rehearsed on the host
# --------------------------------------------------------------------- #
def test_chip_smoke_servedb_phase_on_the_host(tmp_path, monkeypatch):
    """The phase's steps at small shapes on the CPU, the measured arch the
    host's ``cpu``: each config's measured time the cost model's and each
    call of its runner a launch, so the checks are exact.  Every check
    passes but one the host cannot meet: the warm-started submit's
    measuring process runs the plain version, which counts no launch."""
    import importlib.util

    from repro_torch.core.results import ResultTable
    from repro_torch.kernels.attention.space import AttentionProblem
    from repro_torch.kernels.common import admits
    from repro_torch.kernels.conv2d.space import Conv2dProblem
    from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem
    from repro_torch.servedb import lookup as lookup_mod

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = {"gemm": 0, "flash_attention": 0, "conv2d": 0}

    def measured_as_the_model(prob, name):
        def build(cfg):
            def call():
                launches[name] += 1
            call.seconds = prob.evaluate(cfg, "h100sxm").objective
            return call

        def seconds(fn):
            for _ in range(prob.warmup + prob.repeats):
                fn()
            return [fn.seconds] * prob.repeats
        monkeypatch.setattr(prob, "build", build)
        monkeypatch.setattr(prob, "_seconds", seconds)
        return prob

    gemm = measured_as_the_model(
        GemmProblem(shape=SMALL_SHAPE, device="cpu"), "gemm")
    attn = measured_as_the_model(AttentionProblem(
        shape=AttentionProblem.small_shape, device="cpu"), "flash_attention")
    conv = Conv2dProblem(shape=Conv2dProblem.small_shape, device="cpu")
    # the orchestrator phase's store: GEMM's session, attention's grid and
    # a campaign over the measured arch and the model's
    store = SessionStore(tmp_path / "store")
    n_valid = attn.space.compiled().n_valid
    runs = [(gemm, "random", "cpu", 12), (attn, "grid", "cpu", n_valid)] + [
        (attn, t, a, 12) for t in ("random", "genetic")
        for a in ("cpu", "h100sxm", "h100pcie")]
    for prob, tuner, arch, budget in runs:
        s = SessionSpec(problem=prob.name, tuner=tuner, arch=arch,
                        budget=budget, seed=0, workers=1, problem_kwargs={
                            "shape": dict(prob.shape), "device": "cpu"})
        store.create(s)
        run_session(s, problem=prob, store=store, mode="thread")
    served = []

    def serve(kernel, cfg, shape):
        prob = {"gemm_h100": gemm, "flash_attention_h100": attn,
                "conv2d_h100": conv}[kernel]
        if shape != prob.shape:
            prob = make_problem(kernel, shape=shape, device="cpu")
        served.append((kernel, admits(prob.space, cfg)))
        return served[-1][1]

    monkeypatch.setattr(lookup_mod, "DEFAULT_ARCH", "cpu")
    trials = [gemm.evaluate(c) for c in gemm.space.sample_distinct(16, 1)]
    table = ResultTable.from_trials(conv, "cpu", conv.exhaustive("h100sxm"),
                                    "exhaustive")
    failures: list[str] = []
    out = smoke.servedb_check(
        {"store": str(tmp_path / "store")}, tmp_path, gemm, attn, conv,
        table, trials, min(t.objective for t in trials), serve,
        lambda: dict(launches), failures,
        problem_args=("--device", "cpu", "--problem-kwargs",
                      json.dumps({"shape": dict(gemm.shape)})))
    assert failures == ["servedb warm start: launches {}"]
    assert out["build"]["entries"] == {
        "gemm_h100": {"cpu": 1},
        "flash_attention_h100": {"cpu": 1, "h100sxm": 1, "h100pcie": 1}}
    assert {q: r["tier"] for q, r in out["lookups"].items()} == {
        "gemm_exact": "exact", "gemm_nearest": "nearest",
        "attention_exact": "exact", "conv2d": "heuristic",
        "unknown": "default"}
    assert [k for k, _ in served] == ["gemm_h100", "gemm_h100",
                                      "flash_attention_h100", "conv2d_h100"]
    per = gemm.warmup + gemm.repeats
    assert out["screen"]["launches"] == out["screen"]["measured"] * per > 0
    assert out["screen"]["estimated"] > 0
    assert out["surrogate"]["measured_rows"] == len(table)
    assert len(out["warm_start"]["rows"]) == smoke.WARM_TOP
    assert not torch.cuda.is_initialized()
