"""The port's dry run swept over every cell: each ``(arch, shape)`` of
``configs.cells_for`` traced without a raise, and with every collective
of the step issued by the port itself (``collective_audit`` empty:
nothing in DTensor's own ``dtensor_coll_by_op``, no call of its
``shard_dim_alltoall``).

* *Reduced.*  Every cell on the reduced configs, each cut to one period
  of its layer pattern (every kind of block once), on a fake 4x2 (data,
  model) and a fake 2x2x2 (pod, data, model) mesh, under the plain and the
  ``--opt`` plan (``optimize_config``).
* *Full width.*  One layer at the full widths on the fake 16x16 mesh, for
  the cells whose faults showed at full width only: qwen3-8b's
  ``decode_32k`` under both plans (the cache write and the scatter write
  on a sharded cache), deepseek-v2-236b's ``decode_32k`` (MLA's cache
  write and its scores), recurrentgemma-9b's ``long_500k`` (batch 1, which
  the data axis does not divide), and rwkv6-1.6b's ``long_500k`` on the
  2x16x16 mesh (its one-token recurrence), through ``dryrun.run_cell``
  with ``audit=True``.

Each group of cells is traced in a subprocess of its own with a timeout
(a fake process group lives in it alone); the module's fixture starts them
all at once.  A cell that raises is recorded with its error, so every
other cell is still checked.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS, cells_for  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PLANS = ("plain", "opt")
#: the full-width cells at one layer: (arch, shape, multi_pod, opt)
FULL = [("qwen3-8b", "decode_32k", False, False),
        ("qwen3-8b", "decode_32k", False, True),
        ("deepseek-v2-236b", "decode_32k", False, False),
        ("recurrentgemma-9b", "long_500k", False, False),
        ("rwkv6-1.6b", "long_500k", True, False)]

_REDUCED = """
import dataclasses, json, sys, time, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, cells_for, reduce_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.steps import lower_cell, optimize_config, plan_cell
from repro_torch.roofline.trace import count_shard_moves
torch.set_num_threads(1)
shape, names, plan_name = json.loads(sys.argv[1])
fake_world(8)
mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
out = {}
for arch in ARCHS:
    cfg = reduce_config(ARCHS[arch])
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    if plan_name == "opt":
        cfg = optimize_config(cfg, mesh)
    for cell in cells_for(arch):
        t0 = time.perf_counter()
        try:
            with count_shard_moves() as moves:
                trace = lower_cell(plan_cell(cfg, cell, mesh), mesh)
            out[f"{arch}.{cell}"] = {
                "dtensor_coll_by_op": trace.dtensor_coll_by_op,
                "shard_dim_alltoall": sum(moves.values()),
                "coll_by_op": trace.coll_by_op, "flops": trace.flops}
        except Exception as e:              # noqa: BLE001 - record it
            out[f"{arch}.{cell}"] = {"error": repr(e)[:2000]}
        out[f"{arch}.{cell}"]["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""

_FULL = """
import json, sys, tempfile, time, torch
from pathlib import Path
from repro_torch.launch.dryrun import run_cell
torch.set_num_threads(1)
out = {}
with tempfile.TemporaryDirectory() as d:
    for arch, shape, multi_pod, opt in json.loads(sys.argv[1]):
        t0 = time.perf_counter()
        key = f"{arch}.{shape}.{multi_pod}.{opt}"
        try:
            r = run_cell(arch, shape, multi_pod, Path(d), optimized=opt,
                         layers=1, audit=True)
            out[key] = dict(r["collective_audit"], coll_by_op=r["coll_by_op"],
                            flops=r["flops_per_chip"], chips=r["chips"])
        except Exception as e:              # noqa: BLE001 - record it
            out[key] = {"error": repr(e)[:2000]}
        out[key]["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def _cells():
    return [(a, s) for a in ARCHS for s in cells_for(a)]


@pytest.fixture(scope="module")
def sweep():
    """Every group's cells, traced in subprocesses started at once:
    ``{(mesh, plan): {"arch.shape": result}, "full": {...}}``."""
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:"
               f"{os.environ.get('PYTHONPATH', '')}", OMP_NUM_THREADS="1")

    def start(body, arg):
        return subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(body), json.dumps(arg)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    procs = {(m, p): start(_REDUCED, [*MESHES[m], p])
             for m in MESHES for p in PLANS}
    procs["full"] = start(_FULL, FULL)
    out = {}
    try:
        for key, proc in procs.items():
            so, se = proc.communicate(timeout=900)
            assert proc.returncode == 0, (key, se[-4000:])
            out[key] = json.loads(so.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _clean(res: dict) -> None:
    assert "error" not in res, res["error"]
    assert res["dtensor_coll_by_op"] == {}, res
    assert res["shard_dim_alltoall"] == 0, res
    assert res["flops"] > 0


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_every_reduced_cell_traces_with_its_own_collectives(
        sweep, arch, shape, mesh, plan):
    """The reduced cell traces on the fake mesh under the plan, and every
    collective of it is the port's own; on these meshes every cell has
    some."""
    res = sweep[mesh, plan][f"{arch}.{shape}"]
    _clean(res)
    assert sum(res["coll_by_op"].values()) > 0


@pytest.mark.parametrize("arch,shape,multi_pod,opt", FULL)
def test_full_width_cells_trace_with_their_own_collectives(
        sweep, arch, shape, multi_pod, opt):
    """One layer at the full widths through ``run_cell(..., audit=True)``
    on 256 (or 512) fake ranks: no raise, an empty audit."""
    res = sweep["full"][f"{arch}.{shape}.{multi_pod}.{opt}"]
    _clean(res)
    assert res["chips"] == (512 if multi_pod else 256)


def test_the_sweep_covers_every_cell(sweep):
    """Each reduced group traced every cell of ``cells_for`` (the opt
    decode of every attention arch among them), and the cells are the
    dry run's ``--all``."""
    from repro_torch.launch.dryrun import all_cells
    assert sorted(_cells()) == sorted(all_cells())
    for mesh in MESHES:
        for plan in PLANS:
            assert sorted(sweep[mesh, plan]) == sorted(
                f"{a}.{s}" for a, s in _cells())
