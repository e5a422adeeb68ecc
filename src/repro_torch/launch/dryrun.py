"""Multi-pod dry run: plan and trace every (arch × shape × mesh) cell.

The port of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles each cell on 512 placeholder host devices, the port builds the
mesh on a fake process group of 256 or 512 ranks in this one process
(``torch.testing._internal.distributed.fake_pg``, started by
:func:`run_cell`, never at import) and traces one step as rank 0 sees it,
on fake tensors: nothing is allocated on any device, and there is no
``--device``.

Per cell the dry run:
  1. builds the model + sharding plan (launch.steps.plan_cell),
  2. traces one step of it on the fake mesh (launch.steps.lower_cell: each
     rank's local shards placed by the plan, DTensor's collectives
     recorded),
  3. extracts the three roofline terms (repro_torch.roofline) and writes
     one JSON per cell, ``{arch}.{shape}.{mesh}.json``, under
     ``experiments/dryrun_torch/``, with the JAX package's keys.  Three
     cannot mean the same: ``torch_version`` stands for ``jax_version``;
     ``lower_s`` is the planning's seconds and ``compile_s`` the trace's;
     ``memory_analysis`` holds the trace's resident bytes as
     ``argument_bytes`` and its peak above them as ``temp_bytes``
     (``output_bytes`` and ``alias_bytes`` 0: the step updates in place).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every assigned cell
    python -m repro_torch.launch.dryrun --all --jobs 8   # subprocess per cell

``--layers N`` cuts the depth (the roofline terms then cover N layers) and
names the file ``{arch}.{shape}.{mesh}.L{N}.json``, so a cut cell never
stands for the whole one under ``--skip-existing``;
``--aspect DxM`` plans a (data, model) mesh of another shape, e.g. 32x8,
which keeps TP inside an 8-GPU NVLink node.
``--audit`` also records, under ``collective_audit``, the collective
bytes by opcode that DTensor's own op strategies issued in the trace
(``dtensor_coll_by_op``) and the calls of DTensor's own Shard-to-Shard
step (``shard_dim_alltoall``): the port issues every collective of the
step itself, so both are empty, on any torch version.  ``--all`` passes
``--audit``, ``--opt`` and ``--layers`` on to every cell.
"""

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def cell_path(out_dir: Path, arch: str, shape: str, mesh_name: str,
              layers: int | None = None) -> Path:
    """Where a cell's JSON goes: the depth cut, if any, is in the name."""
    cut = f".L{layers}" if layers else ""
    return Path(out_dir) / f"{arch}.{shape}.{mesh_name}{cut}.json"


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks, this process rank 0 (one
    of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process "
                               "group; a real one is initialised")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, probe: bool = False,
             optimized: bool = False, aspect: str | None = None,
             layers: int | None = None, audit: bool = False) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from ..configs import ARCHS, SHAPES
    from ..roofline import analyze_trace, model_flops, roofline_report
    from ..roofline.trace import count_shard_moves
    from .mesh import PRODUCTION, make_production_mesh
    from .steps import lower_cell, optimize_config, plan_cell

    cfg = ARCHS[arch]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if aspect:          # §Perf: DPxTP aspect is itself a sharding tunable
        d, m = (int(x) for x in aspect.split("x"))
        fake_world(d * m)
        mesh = init_device_mesh("cpu", (d, m),
                                mesh_dim_names=("data", "model"))
        mesh_name = f"{d}x{m}"
    else:
        dims = PRODUCTION[multi_pod][0]
        fake_world(math.prod(dims))
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "x".join(map(str, dims))
    if optimized:
        cfg = optimize_config(cfg, mesh)
        mesh_name += ".opt"
    chips = mesh.size()

    t0 = time.perf_counter()
    plan = plan_cell(cfg, shape, mesh, **(overrides or {}))
    t_lower = time.perf_counter() - t0
    with count_shard_moves() as moves:
        trace = lower_cell(plan, mesh)
    t_compile = trace.seconds

    mf = model_flops(cfg, SHAPES[shape], microbatches=plan.microbatches)
    report = analyze_trace(trace, chips=chips, arch=arch, shape=shape,
                           mesh=mesh_name, model_flops_value=mf)
    out = {
        **report.to_dict(),
        "microbatches": plan.microbatches,
        "lower_s": t_lower,
        "compile_s": t_compile,
        "memory_analysis": {
            "argument_bytes": trace.resident_bytes,
            "output_bytes": 0,
            "temp_bytes": trace.peak_bytes - trace.resident_bytes,
            "alias_bytes": 0,
        },
        "devices": chips,
        "torch_version": torch.__version__,
        "n_layers": cfg.n_layers,
        "ops": trace.ops,
    }
    if audit:
        out["collective_audit"] = {
            "dtensor_coll_by_op": trace.dtensor_coll_by_op,
            "shard_dim_alltoall": sum(moves.values())}

    if probe:                     # corrected roofline terms (§Roofline)
        from ..roofline.probe import corrected_report
        t0 = time.perf_counter()
        corr, res = corrected_report(cfg, shape, mesh, arch=arch,
                                     mesh_name=mesh_name,
                                     model_flops_value=mf)
        corr.peak_memory_per_chip = report.peak_memory_per_chip
        out["corrected"] = corr.to_dict()
        out["probe_breakdown"] = {
            k: {"flops": v.flops, "hbm": v.hbm, "coll": v.coll}
            for k, v in res["breakdown"].items()}
        out["probe_s"] = time.perf_counter() - t0
        print(roofline_report(corr))
    else:
        print(roofline_report(report))

    out_dir.mkdir(parents=True, exist_ok=True)
    path = cell_path(out_dir, arch, shape, mesh_name, layers)
    path.write_text(json.dumps(out, indent=1))
    print(f"  plan {t_lower:.1f}s  trace {t_compile:.1f}s  -> {path}")
    return out


def all_cells() -> list[tuple[str, str]]:
    from ..configs import ARCHS, cells_for
    return [(a, s) for a in ARCHS for s in cells_for(a)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch × shape) cell")
    ap.add_argument("--both-meshes", action="store_true",
                    help="with --all: run single-pod AND multi-pod")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: concurrent subprocesses")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="add the corrected roofline terms (single-pod)")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper SPMD optimizations (writes *.opt.json)")
    ap.add_argument("--aspect", default=None,
                    help="override single-pod mesh aspect, e.g. 32x8")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--audit", action="store_true",
                    help="record the collectives DTensor issued on its "
                         "own (collective_audit)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                 probe=args.probe, optimized=args.opt, aspect=args.aspect,
                 layers=args.layers, audit=args.audit)
        return

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a, s in all_cells() for mp in meshes]
    if args.skip_existing:
        cells = [(a, s, mp) for a, s, mp in cells
                 if not cell_path(out_dir, a, s,
                                  ("2x16x16" if mp else "16x16")
                                  + (".opt" if args.opt else ""),
                                  args.layers).exists()]
    print(f"{len(cells)} cells to run", flush=True)
    if args.jobs <= 1:
        failures = []
        for a, s, mp in cells:
            try:
                run_cell(a, s, mp, out_dir, probe=(args.probe and not mp),
                         optimized=args.opt, layers=args.layers,
                         audit=args.audit)
            except Exception as e:           # noqa: BLE001 — report & continue
                failures.append((a, s, mp, repr(e)))
                print(f"FAIL {a} {s} multi_pod={mp}: {e!r}", flush=True)
        if failures:
            sys.exit(f"{len(failures)} cells failed: {failures}")
        return

    # subprocess per cell: isolates trace memory, enables parallelism
    procs: list[tuple[subprocess.Popen, tuple]] = []
    pending = list(cells)
    failures = []
    while pending or procs:
        while pending and len(procs) < args.jobs:
            a, s, mp = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--out", str(out_dir)]
            if mp:
                cmd.append("--multi-pod")
            elif args.probe:
                cmd.append("--probe")
            if args.opt:
                cmd.append("--opt")
            if args.layers:
                cmd += ["--layers", str(args.layers)]
            if args.audit:
                cmd.append("--audit")
            procs.append((subprocess.Popen(cmd), (a, s, mp)))
        still = []
        for p, cell in procs:
            if p.poll() is None:
                still.append((p, cell))
            elif p.returncode != 0:
                failures.append(cell)
                print(f"FAIL {cell}", flush=True)
        procs = still
        time.sleep(0.5)
    if failures:
        sys.exit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
