"""The port's dry run (``repro_torch.launch.dryrun``) and the planner in
``launch/steps.py``: the JAX package's ``test_multidevice::
test_dryrun_cell_on_8_devices`` (a reduced granite-moe ``train_4k`` cell
planned and traced on a 4x2 mesh, here of a fake process group), the
planner's specs against the JAX planner's, the CLI's JSON keys against
the JAX dry run's, and ``chip_smoke.py``'s ``dist`` phase rehearsed on the
host.  Each traced case runs in a subprocess with a timeout (a fake or
gloo process group lives in it alone)."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

REPO = Path(__file__).resolve().parents[1]


def _run(body: str, timeout: int = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}:"
               f"{os.environ.get('PYTHONPATH', '')}", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


CELLS = """
import dataclasses, json, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.steps import lower_cell, plan_cell
from repro_torch.roofline import analyze_trace
torch.set_num_threads(1)
fake_world(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
out = {}
for arch, shape in (("granite-moe-3b-a800m", "train_4k"),
                    ("granite-moe-3b-a800m", "decode_32k"),
                    ("qwen3-8b", "prefill_32k"),
                    ("qwen3-8b", "decode_32k")):
    cfg = reduce_config(ARCHS[arch])
    if shape == "decode_32k" and cfg.n_experts:
        # one group of 128 tokens: a dim the data axis does not divide
        cfg = dataclasses.replace(cfg, moe_group=128)
    plan = plan_cell(cfg, shape, mesh, microbatches=1)
    trace = lower_cell(plan, mesh)
    rep = analyze_trace(trace, chips=8, arch=arch, shape=shape, mesh="4x2",
                        model_flops_value=1.0)
    out[f"{arch}.{shape}"] = dict(rep.to_dict(),
                                  resident=trace.resident_bytes,
                                  ops=trace.ops)

# on (2, 4): the opt plan's attention over the sequence (4 heads, 2 kv
# heads, no repeat), audited
from repro_torch.launch.steps import optimize_config
from repro_torch.roofline.trace import count_shard_moves
mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(optimize_config(reduce_config(
    ARCHS["deepseek-coder-33b"]), mesh24), kv_repeat=1)
with count_shard_moves() as moves:
    trace = lower_cell(plan_cell(cfg, "train_4k", mesh24, microbatches=1),
                       mesh24)
out["seq.audit"] = {"coll": trace.coll_by_op,
                    "dtensor": trace.dtensor_coll_by_op,
                    "moves": sum(moves.values())}

# the probe: the opt plan's terms with the flash kernel's attention
from repro_torch.roofline.probe import corrected_report
cfg = optimize_config(reduce_config(ARCHS["qwen3-8b"]), mesh)
rep, res = corrected_report(cfg, "train_4k", mesh, arch="qwen3-8b",
                           mesh_name="4x2.opt", model_flops_value=1.0,
                           verbose=False)
out["probe"] = {"report": rep.to_dict(), "microbatches": res[
    "microbatches_deploy"], "breakdown": {
        k: [v.flops, v.hbm, v.coll] for k, v in res["breakdown"].items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    return _run(CELLS)


def test_dryrun_cell_on_a_fake_4x2_mesh(cells):
    """The JAX package's ``test_dryrun_cell_on_8_devices`` on the port:
    reduced granite-moe's ``train_4k`` planned and traced; its experts'
    products and the FSDP x TP collectives are counted per chip."""
    rep = cells["granite-moe-3b-a800m.train_4k"]
    assert rep["flops_per_chip"] > 0 and rep["hbm_bytes_per_chip"] > 0
    assert rep["peak_memory_per_chip"] >= rep["resident"] > 0
    assert {"all-gather", "all-reduce"} <= set(rep["coll_by_op"])
    assert rep["bound"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("cell", ["qwen3-8b.prefill_32k",
                                  "qwen3-8b.decode_32k",
                                  "granite-moe-3b-a800m.decode_32k"])
def test_prefill_and_decode_cells_trace(cells, cell):
    rep = cells[cell]
    assert rep["flops_per_chip"] > 0 and rep["t_total_overlap"] > 0


def test_the_probe_swaps_plain_attention_for_the_flash_kernel(cells):
    """Under ``opt_attn`` at 4096 tokens the probe replaces each layer's
    traced plain attention (its (tq x tk) scores in HBM) by the flash
    kernel's cost features: bytes fall, and the totals are the step's
    trace plus that delta (``mb_extra`` reported beside, not added)."""
    p = cells["probe"]
    b = p["breakdown"]
    swap = b["sdpa_swap_wNone"]
    assert swap[1] < 0                                   # HBM bytes fall
    step = b["step"]
    rep = p["report"]
    assert rep["hbm_bytes_per_chip"] == pytest.approx(step[1] + swap[1])
    assert rep["flops_per_chip"] == pytest.approx(step[0] + swap[0])
    assert set(b) == {"step", "sdpa_swap_wNone", "mb_extra"}
    assert rep["mesh"] == "4x2.opt" and p["microbatches"] >= 1


def test_the_opt_plans_sequence_sharded_attention_issues_its_own_collectives(
        cells):
    """The reduced deepseek-coder-33b's ``train_4k`` cell under the
    ``--opt`` plan without the kv-head repeat on a fake (2, 4) mesh: 4
    heads, 2 kv heads, so q is sharded over the sequence and each rank
    runs its rows' chunks (4096 tokens: the chunked route) in one region,
    k and v gathered as they enter it.  Every collective is the port's
    own: ``--audit``'s two counts are empty and zero (before, DTensor
    sliced the sequence-sharded q for the chunks and gathered it)."""
    got = cells["seq.audit"]
    assert got["dtensor"] == {} and got["moves"] == 0
    assert got["coll"]["all-gather"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_the_plan_holds_the_jax_plans_specs(shape):
    """``plan_cell``'s specs of the batch (and the decode cache) and
    ``_opt_shardings`` against the JAX planner's on a fake 16x16 mesh."""
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import ARCHS as JARCHS
    from repro.launch.steps import plan_cell as jplan
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.steps import plan_cell
    devs = np.array([jax.devices("cpu")[0]] * 256,
                    dtype=object).reshape(16, 16)
    jm = Mesh(devs, ("data", "model"))
    want = jplan(JARCHS["qwen3-8b"], shape, jm)
    got = plan_cell(ARCHS["qwen3-8b"], shape,
                    AbstractMesh((16, 16), ("data", "model")))
    assert got.kind == want.kind and got.microbatches == want.microbatches
    jb, pb = want.in_shardings[-1], got.in_shardings[-1]
    for k in ("tokens", "labels", "token"):
        if k in jb:
            assert pb[k] == tuple(jb[k].spec)
    if shape == "decode_32k":
        def specs(tree, stacked):
            return {tuple(s.spec)[stacked:] for s in jax.tree.leaves(
                tree, is_leaf=lambda s: hasattr(s, "spec"))}
        # the JAX cache stacks its groups' layers on a leading axis
        want_c = specs(jb["cache"]["groups"], 1) | specs(
            jb["cache"]["rest"], 0)
        assert want_c == {tuple(s) for s in jax.tree.leaves(
            pb["cache"], is_leaf=lambda s: isinstance(s, tuple))}
    if shape == "train_4k":
        o = got.in_shardings[1]
        assert o["step"] == () and o["m"] == got.in_shardings[0] \
            == o["v"] == o["master"]


def test_the_clis_json_has_the_jax_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes
    ``{arch}.{shape}.{mesh}.json`` with the JAX dry run's keys, and
    ``torch_version`` where it writes ``jax_version``; a depth cut is in
    the name (``.L1``), so ``--skip-existing`` never takes it for the
    whole cell."""
    from repro.roofline import CellReport as JCellReport
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "train_4k", "--aspect", "2x2", "--layers",
         "1", "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    path = tmp_path / "qwen3-8b.train_4k.2x2.L1.json"
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    got = json.loads(path.read_text())
    report = {f.name for f in dataclasses.fields(JCellReport)} | {
        "bound", "t_total_overlap", "useful_flops_ratio", "mfu"}
    jax_keys = report | {"microbatches", "lower_s", "compile_s",
                         "memory_analysis", "devices", "jax_version"}
    assert set(got) - {"n_layers", "ops"} \
        == (jax_keys - {"jax_version"}) | {"torch_version"}
    assert set(got["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
    assert got["devices"] == got["chips"] == 4 and got["n_layers"] == 1
    assert got["mesh"] == "2x2" and got["flops_per_chip"] > 0


@pytest.mark.parametrize("jobs", [1, 2])
def test_all_passes_audit_and_the_plan_to_every_cell(monkeypatch, tmp_path,
                                                     jobs):
    """``--all --audit --opt --layers 1`` runs every cell of ``all_cells``
    with the audit, the ``--opt`` plan and the depth cut: in this process
    (``--jobs 1``: ``run_cell(..., audit=True, optimized=True,
    layers=1)``) and in one subprocess a cell (``--jobs 2``: each command
    line with ``--audit``, ``--opt`` and ``--layers 1``)."""
    from repro_torch.launch import dryrun
    ran, cmds = [], []

    def run_cell(arch, shape, multi_pod, out_dir, **kw):
        ran.append(((arch, shape, multi_pod), kw))

    class Popen:
        returncode = 0

        def __init__(self, cmd):
            cmds.append(cmd)

        def poll(self):
            return 0

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    monkeypatch.setattr(dryrun.subprocess, "Popen", Popen)
    monkeypatch.setattr(dryrun.time, "sleep", lambda s: None)
    dryrun.main(["--all", "--audit", "--opt", "--layers", "1", "--jobs",
                 str(jobs), "--out", str(tmp_path)])
    cells = [(a, s, False) for a, s in dryrun.all_cells()]
    if jobs == 1:
        assert cmds == [] and [c for c, _ in ran] == cells
        for _, kw in ran:
            assert kw["audit"] is True and kw["optimized"] is True
            assert kw["layers"] == 1
    else:
        assert ran == [] and len(cmds) == len(cells)
        for cmd, (arch, shape, _) in zip(cmds, cells):
            assert cmd[cmd.index("--arch") + 1] == arch
            assert cmd[cmd.index("--shape") + 1] == shape
            assert "--audit" in cmd and "--opt" in cmd
            assert cmd[cmd.index("--layers") + 1] == "1"


def test_chip_smokes_dist_phase_on_the_host():
    """``chip_smoke.dist_check`` on the CPU (gloo's one-rank mesh, the
    reduced qwen3-8b, plain attention; (b)'s prefill and two decode steps
    under the ``--opt`` plan within ``LM_TOL`` of the unsharded plain
    model's; the dry run at one layer, and its six other cells,
    deepseek-coder-33b's ``train_4k --opt``, deepseek-v2-236b's
    ``train_4k`` and ``decode_32k``, qwen3-8b's ``decode_32k --opt``,
    rwkv6-1.6b's ``long_500k --multi-pod`` and ``prefill_32k``, audited
    clean)."""
    out = _run("""
    import dataclasses, json
    import chip_smoke as cs
    from repro_torch.configs import ARCHS, reduce_config
    cfg = reduce_config(ARCHS["qwen3-8b"])
    fails = []
    res = cs.dist_check("smi", lambda: {"flash_attention": 0},
                        lambda: None, fails, cfg=cfg, device="cpu",
                        step_seq=64, prefill_seq=64,
                        roof_cfg=dataclasses.replace(cfg, n_layers=2),
                        roof_batch=4, roof_micro=2,
                        train={"step_ms_median": 100.0,
                               "bound": {"bound_ms": 10.0}},
                        dryruns=cs.start_dry_runs(
                            [(cs.DRYRUN_ARGS, 1), *cs.DRYRUN_MORE]))
    print(json.dumps({"fails": fails, "backend": res["backend"],
                      "step": res["step"], "prefill": res["prefill"],
                      "opt": res["opt_decode"], "tol": cs.LM_TOL,
                      "dry": res["dryrun"]["json"]["mesh"],
                      "more": [(r["json"]["arch"], r["json"]["mesh"],
                                r["json"]["collective_audit"])
                               for r in res["dryrun_more"]],
                      "roof": res["roofline"]["t_collective"]}))
    """, timeout=400)
    assert out["fails"] == []
    assert out["backend"] == "gloo" and out["dry"] == "16x16"
    assert out["more"] == [
        [arch, mesh, {"dtensor_coll_by_op": {}, "shard_dim_alltoall": 0}]
        for arch, mesh in (("deepseek-coder-33b", "16x16.opt"),
                           ("deepseek-v2-236b", "16x16"),
                           ("qwen3-8b", "16x16.opt"),
                           ("deepseek-v2-236b", "16x16"),
                           ("rwkv6-1.6b", "2x16x16"),
                           ("rwkv6-1.6b", "16x16"))]
    assert out["opt"]["steps"] == 2 and len(out["opt"]["decode_rel_l2"]) == 2
    assert max(out["opt"]["decode_rel_l2"]) <= out["tol"]
    assert out["opt"]["prefill_rel_l2"] <= out["tol"]
    assert out["opt"]["launches"] == {"flash_attention": 0}
    assert out["step"]["loss_rel"] <= 1e-6
    assert out["step"]["routes"] == {"plain": 2}
    assert out["prefill"]["launches"] == {"flash_attention": 0}
    assert out["roof"] == 0.0
