#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py [--budget N] [--samples S] [--json PATH]

Phases, each timed:

1. probe     — the card must be sm_90 (Hopper); prints ``nvidia-smi``'s name
               and power limit.
2. build     — builds every kernel of the port from ``src/repro_torch/csrc``
               with nvcc, all sources and variants at once, and checks that
               no compiled tile spills, that every tile launches the
               largest block its space admits, that the GEMM and
               attention libraries' SASS issues wgmma and TMA loads and no
               mma.sync (printing what ptxas said of wgmma and setmaxnreg),
               and that no conv2d tile's SASS touches local memory (LDL,
               STL); it counts every conv2d tile's tap loop (FFMA or bf16
               HMUL2 + HADD2, LDS by width, LDC, ULDC, the rest) and
               prints the default's and the tuned tile's counts in the
               timing phase.
3. parity    — each kernel against its plain PyTorch version on the card, on
               configs that together take every value of every parameter at
               small shapes (GEMM 256x256x512, every compiled tile at every
               stage count; attention 4 q heads, 2 kv heads, 256 x 256, d
               64, causal and full, and 128 x 256, and every compiled
               (d, block_kv, warpgroups) at 8 q heads, 2 kv heads
               and d 64 and 128, 256 x 256 causal and full and 128 x 256;
               N-body 512 and 4096 bodies; pnpoly 1536 points and a
               17-gon; conv2d 48 x 160 with a 5 x 5 filter, and every
               compiled tile at filters of 5 and 15 on outputs no block
               divides, with rows of a multiple of 4 floats and without
               (``space.TILE_SHAPES``); hotspot 48 x 144 with 4 sweeps
               and 224 x 324 with 12, and every compiled tile on 224 x
               324 and on 30 x 30
               (smaller than a tile); expdist 384 x 320 and 5000 x 3000
               points; dedisp 12 channels x 24 DMs and 96 x 160, and every
               compiled tile at the two shapes that reach them all, on the
               problem's delay table, one where a channel's DMs share one
               delay and one where all differ), and on three configs at the
               full shapes (GEMM: six, both layouts, split-k and a bf16
               accumulator among them); within the JAX package's tolerance and the
               tighter ``kernel.PLAIN_TOL``, with a bf16-vs-f32 control for
               every kernel with a bf16 option.  pnpoly and dedisp (both
               acc_dtypes) and hotspot and conv2d in bf16 are held exactly
               (0 mismatching outputs; hotspot on the whole domain), and
               pnpoly's twelve method variants must agree point for point
               at the full shape.
4. main      — the GEMM path, ``repro_torch.quickstart.main``: random search
               and a genetic algorithm over ``gemm_h100`` at 4096^3, every
               config timed on the card through the kernel, the winner
               checked, a sampled table and its speedup over the median.
5. paths     — for ``flash_attention_h100`` (32 q heads, 8 kv heads, 4096 x
               4096, d 128, causal), ``nbody_h100`` (131 072 bodies),
               ``pnpoly_h100`` (2 000 000 points, a 600-gon),
               ``conv2d_h100`` (4096 x 4096, 15 x 15), ``hotspot_h100``
               (600 sweeps of 3248 x 3248), ``expdist_h100`` (65 536 x
               65 536 points) and ``dedisp_h100`` (1536 channels, 2048 DMs,
               4096 of 12 288 samples): the same quickstart, then
               ``repro_torch.landscape.main``, which measures the whole
               space (attention, nbody, pnpoly, conv2d) or, for the three
               sampled problems, ``--samples`` distinct random configs
               (default 1000; hotspot at most ``HOTSPOT_SAMPLES``; dedisp's
               space, 336 configs at its shape, is measured whole), and
               prints the paper's five landscape results on the table.
               Each path's launch counts are set to 0 just before it and
               read just after; its kernel must have launched, no admitted
               config may be invalid, and the winner must hold against the
               oracle (nbody's and expdist's against an f64 oracle too).
6. timing    — per kernel at its full shape: the default config, the plain
               version and, where one exists, one PyTorch library call
               computing the same function (``torch.addmm``;
               ``scaled_dot_product_attention``; ``F.conv2d``), a yardstick
               the port never calls; each the median of cold-L2 CUDA-event
               repeats; GEMM's tuned config also at each ring depth, with
               B's other layout and a bf16 accumulator, and a 128 x 128
               tile on one and two consumer warpgroups; attention's tuned
               config also with skip_masked and acc_dtype flipped, and at
               every (block_q, block_h) of the group (one or two consumer
               warpgroups), each with its TFLOP/s and share of the bound;
               hotspot's tuned tile at tt 1, 4 and 10 and power_smem 0
               and 1; dedisp's tuned config on a table where a channel's
               DMs share one delay, one where all differ, and the real one;
               conv2d's tuned config with col_chunk 1, row_chunk 1, the
               filter's other home, each unroll_fh and the other
               accumulator (each the admitted config nearest to it), and
               the times in its whole table of the configs nearest to the
               27 that formed the earlier design's 13.6 ms cliff, beside
               the table's worst over its median.
               No single PyTorch call computes nbody, pnpoly, hotspot
               (600 dependent sweeps), expdist or dedisp (each several
               ops), so their ``library_ms`` is null.
7. costmodel — the Hopper cost model (``core/costmodel.py``, arch
               ``h100sxm``) against the table each path just measured
               (GEMM's: the distinct configs its tuners and sample timed):
               Spearman's rho on all rows and on those outside the model's
               fit set (``core/h100_rows.json``), the model's whole-space
               pick measured now as a share of the table's best, the
               model over the measurement at ``DEFAULT_CONFIG``, and the
               host's microseconds a config of ``objectives_for_rows``
               over the whole space; for the three problems not measured
               whole (GEMM, hotspot, expdist), rho on ``HOLDOUT`` configs
               measured now that no path of the run measured, drawn with
               a seed of their own from outside the fit set; then Fig 5, the portability matrix
               over (h100, h100sxm, h100pcie), for the five problems
               measured whole.  A config the model cannot run, or a pick
               that fails, fails the run.

Prints the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  A kernel's ``launches`` counts its wrapper's calls on its path;
``device_launches`` counts the CUDA kernels those calls issued (hotspot
ceil(600 / tt) a call, expdist two, conv2d two where a bf16 filter is first
packed for constant memory, the others one).  Any failure exits non-zero
without the ``ok`` line, as does a host with no CUDA device or a directory
without the rest of the repository.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: the bound's peak rates: the H100 SXM row of the port's cost model
#: (``core/costmodel.py``, the data sheet's dense peaks), so that the bound
#: and the model share one source: 989e12 bf16 FLOP/s on the tensor cores;
#: 3.35e12 bytes/s; f32 instructions outside the tensor cores, 128 per
#: clock per SM x 132 SMs x 1.98 GHz, an add, a multiply and a fused
#: multiply-add one each (the data sheet's 67 TFLOP/s counts an FMA as
#: two); the special-function units (MUFU: ex2, rcp, rsqrt), 16 results
#: per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
#: throughput, cc 9.0) x 132 SMs x 1.98 GHz
SPEC_ARCH = "h100sxm"
#: configs the hotspot path's landscape measures at most: the register
#: design's configs cost about 0.2 s each to measure (seven calls of 8 to
#: 70 ms), so it takes the 1000 that expdist takes (PERF.md section 4)
HOTSPOT_SAMPLES = 1000
#: the costmodel phase's held-out configs a problem not measured whole, and
#: the seed of their draw: configs outside the path's trials, which the
#: model's terms were never checked against
HOLDOUT, HOLDOUT_SEED = 64, 1
#: the 27 configs (acc_dtype, row_chunk, block_h, block_w) that formed the
#: conv2d cliff of the design before register blocking, 13.2-13.7 ms, each
#: with unroll_fh 1, unroll_fw 15 and the filter in constant memory: every
#: block of 32 to 128 threads at row_chunk 1 (both acc_dtypes) and 2 (f32)
#: (PERF.md section 6)
CONV2D_CLIFF = tuple(
    (acc, rc, bh, bw) for acc, rcs in (("f32", (1, 2)), ("bf16", (1,)))
    for rc in rcs for bh in (1, 2, 4, 8, 16) for bw in (16, 32, 64, 128)
    if bh % rc == 0 and 32 <= bw * bh // rc <= 128)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def covering_configs(space, n: int, seed: int) -> list[dict]:
    """``n`` seeded distinct configs, plus more until every value of every
    parameter appears in at least one."""
    cfgs = space.sample_distinct(n, seed)
    pool = space.sample_distinct(min(len(space.compiled().valid_rows), 512),
                                 seed + 1)
    for p in space.params:
        for v in p.values:
            if not any(c[p.name] == v for c in cfgs):
                cfgs.append(next(c for c in pool if c[p.name] == v))
    return cfgs


def dedisp_tables(delays, span: int) -> dict:
    """Three delay tables of ``delays``' shape: the problem's; one where
    every DM of a channel shares one delay (a window read serves all of a
    thread's DMs); one where all differ (a read each)."""
    import torch
    c, d = delays.shape
    return {"real": delays,
            "equal": torch.full_like(delays, span // 3),
            "distinct": (torch.arange(d, device=delays.device,
                                      dtype=torch.int32) % (span + 1))
            .expand(c, d).contiguous()}


def holdout_rows(space, seen, n: int, seed: int):
    """``n`` admitted rows of ``space`` outside ``seen`` (flat indices),
    drawn with ``seed``, in ascending order."""
    import numpy as np
    comp = space.compiled()
    pool = np.setdiff1d(comp.valid_rows,
                        np.fromiter(seen, dtype=np.int64, count=len(seen)))
    pick = np.random.default_rng(seed).choice(len(pool), min(n, len(pool)),
                                              replace=False)
    return np.sort(pool[pick])


def bound(flops: float, f32_inst: float, nbytes: float,
          sfu_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    (tensor-core FLOPs, the f32 instructions beside them with an FMA
    counted once, and the special-function results) over their peak rates
    and the bytes over the memory rate."""
    from repro_torch.core.costmodel import GPU_GENERATIONS
    peak = GPU_GENERATIONS[SPEC_ARCH]
    ops_s = max(flops / peak.peak_tc_bf16, f32_inst / peak.f32_inst,
                sfu_ops / peak.sfu)
    bytes_s = nbytes / peak.hbm_bw
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def cuobjdump_sass(lib) -> str:
    """A library's SASS, as ``cuobjdump -sass`` prints it."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout


def sass_check(name: str, built, failures: list[str]) -> dict:
    """Count a tensor-core kernel's libraries' tensor-core and TMA
    instructions in their SASS (``cuobjdump``): each must issue wgmma
    (HGMMA) and TMA loads (UTMALDG), and none the older mma.sync (HMMA).
    Also print what ptxas said about wgmma or setmaxnreg in each build
    log."""
    out = {}
    for variant, lib in built.libs.items():
        sass = cuobjdump_sass(lib)
        ops_ = re.findall(r"\b(HGMMA|HMMA|UTMALDG)\b", sass)
        n = {op: ops_.count(op) for op in ("HGMMA", "HMMA", "UTMALDG")}
        log = (lib.parent / f"{variant}.log").read_text()
        notes = sorted({line.strip() for line in log.splitlines()
                        if "wgmma" in line or "setmaxnreg" in line})
        print(f"  {name} {variant}: SASS HGMMA {n['HGMMA']}, HMMA "
              f"{n['HMMA']}, UTMALDG {n['UTMALDG']}; ptxas on "
              f"wgmma/setmaxnreg: {notes or 'nothing'}")
        if not n["HGMMA"] or not n["UTMALDG"] or n["HMMA"]:
            failures.append(f"{name} {variant}: expected wgmma and TMA and "
                            f"no mma.sync in its SASS, counted {n}")
        out[variant] = dict(n, ptxas=notes)
    return out


def sass_functions(lib) -> dict[str, list[str]]:
    """Each function of a library's SASS: its mangled name and its
    instructions' opcodes, in order."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", cuobjdump_sass(lib))[1:]:
        name = fn.split("\n", 1)[0].strip()
        out[name] = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
    return out


def conv2d_sass(built, failures: list[str]) -> dict:
    """Counts of every compiled conv2d tile's SASS, keyed (f, unroll_fh,
    acc_dtype, row_chunk, col_chunk, unroll_fw, filter_smem): over the tap
    loop (from the last barrier to the first store) the tap instructions
    (FFMA, or bf16 HMUL2 and HADD2), shared loads by width, constant loads
    (LDC, ULDC), local memory (LDL, STL) and all others, and the kernel's
    whole size.  Any LDL or STL fails the run."""
    out = {}
    for variant, lib in built.libs.items():
        f, u, acc = variant[1:].split("_")[:3]
        for name, ops_ in sass_functions(lib).items():
            m = re.search(r"conv_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                          name)
            if not m:
                continue
            rc, cc, ufw, fs = map(int, m.groups())
            bar = max((i for i, o in enumerate(ops_) if o.startswith("BAR")),
                      default=0)
            end = next((i for i, o in enumerate(ops_)
                        if i > bar and o.startswith("STG")), len(ops_))
            loop = ops_[bar + 1:end]
            base = [o.split(".")[0] for o in loop]
            taps = sum(o == "FFMA" or (o.startswith(("HMUL2", "HADD2"))
                                       and ".MMA" not in o) for o in loop)
            lds = {w: sum(o == f"LDS{w}" for o in loop)
                   for w in ("", ".64", ".128")}
            n = {"taps": taps, "lds32": lds[""], "lds64": lds[".64"],
                 "lds128": lds[".128"],
                 "ldc": sum(b == "LDC" for b in base),
                 "uldc": sum(b == "ULDC" for b in base),
                 "local": sum(b in ("LDL", "STL") for b in ops_),
                 "loop": len(loop), "bytes": 16 * len(ops_)}
            n["other"] = n["loop"] - taps - sum(lds.values()) - n["ldc"] \
                - n["uldc"]
            n["other_per_tap"] = (n["loop"] - taps) / max(taps, 1)
            key = (int(f), int(u[1:]), acc, rc, cc, ufw, fs)
            out[key] = n
            if n["local"]:
                failures.append(f"conv2d tile {key} uses local memory "
                                f"(LDL/STL) in its SASS")
    return out


def gemm_parity_configs(space, kernel) -> list[dict]:
    """Every compiled (rhs_layout, block_k, tile, warps) at each of the
    three ``stages``, the other parameters cycled so that each of their
    values appears: the small-shape parity set."""
    cfgs = []
    for i, (lay, bk, (bm, bn, w), st) in enumerate(
            (lay, bk, tile, st) for lay in ("kn", "nk")
            for bk in kernel.BLOCK_K for tile in kernel.TILES
            for st in kernel.STAGES):
        cfg = {"block_m": bm, "block_n": bn, "block_k": bk,
               "unroll_k": 1 + (i // 4) % 2, "warps": w, "stages": st,
               "grid_order": ("mn", "nm")[i % 2],
               "split_k": (1, 2, 4, 8)[(i // 2) % 4],
               "acc_dtype": ("f32", "bf16")[(i // 3) % 2], "rhs_layout": lay}
        if not space.satisfies(cfg):
            cfg["unroll_k"] = 1
        cfgs.append(cfg)
    return cfgs


def attention_parity_configs(kernel) -> list[dict]:
    """Every compiled (block_kv, warpgroups) of the attention menu, with (block_q, block_h) cycled through the GQA group of 4's
    blocks of that many rows and skip_masked and acc_dtype cycled, so that
    each of their values appears: one head dim's small-shape parity set."""
    pairs = {rows: [(bq, bh) for bh in (1, 2, 4) for bq in kernel.BLOCK_Q
                    if bq * bh == rows] for rows in kernel.ROWS}
    cfgs = []
    for i, (bkv, wg) in enumerate(kernel.TILES):
        choice = pairs[wg * kernel.ROWS_PER_WARPGROUP]
        bq, bh = choice[i % len(choice)]
        cfgs.append({"block_q": bq, "block_kv": bkv, "block_h": bh,
                     "skip_masked": (i // 2) % 2,
                     "acc_dtype": ("f32", "bf16")[(i // 3) % 2]})
    return cfgs


def kernel_table() -> dict:
    """A row per kernel of the port: its kernel module (``SOURCE``,
    ``VARIANTS``, ``PLAIN_TOL``) and its public op, which counts its
    launches.  Needs ``src`` on the path."""
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.conv2d import kernel as ckernel
    from repro_torch.kernels.conv2d import ops as cops
    from repro_torch.kernels.dedisp import kernel as dkernel
    from repro_torch.kernels.dedisp import ops as dops
    from repro_torch.kernels.expdist import kernel as ekernel
    from repro_torch.kernels.expdist import ops as eops
    from repro_torch.kernels.hotspot import kernel as hkernel
    from repro_torch.kernels.hotspot import ops as hops
    from repro_torch.kernels.matmul import kernel, ops
    from repro_torch.kernels.nbody import kernel as nkernel
    from repro_torch.kernels.nbody import ops as nops
    from repro_torch.kernels.pnpoly import kernel as pkernel
    from repro_torch.kernels.pnpoly import ops as pops
    return {"gemm": (kernel, ops.gemm),
            "flash_attention": (fkernel, fops.attention),
            "nbody": (nkernel, nops.nbody),
            "pnpoly": (pkernel, pops.pnpoly),
            "conv2d": (ckernel, cops.conv2d),
            "hotspot": (hkernel, hops.hotspot),
            "expdist": (ekernel, eops.expdist),
            "dedisp": (dkernel, dops.dedisp)}


def model_check(paths: dict, gemm_trials, defaults: dict, default_s: dict,
                failures: list[str]) -> dict:
    """The Hopper cost model (``h100sxm``) against the table each path of
    this run measured (``paths``: name -> (problem, what ``run_path``
    returned, or None for GEMM, whose table is the distinct configs of
    ``gemm_trials``)): Spearman's rho on all rows and on those outside the
    fit set, the model's whole-space pick measured now as a share of the
    table's best, the model over the measurement at the default config
    (``defaults``, measured as ``default_s``), the host's microseconds a
    config; where the table is not the whole space, rho on
    :func:`holdout_rows` measured now; then Fig 5 over (h100, h100sxm, h100pcie) for the five problems
    measured whole.  What fails goes to ``failures``."""
    import numpy as np

    from repro_torch import calibrate, landscape
    fit_rows = calibrate.load_rows()["problems"]
    cm = {}
    for name, (prob, path) in paths.items():
        try:
            if path is None:
                seen = {prob.space.flat_index(t.config): t.objective
                        for t in gemm_trials if t.ok}
                rows = np.array(sorted(seen), dtype=np.int64)
                meas = np.array([seen[r] for r in rows.tolist()])
                tried = set(seen)
            else:
                rows = np.array([prob.space.flat_index(c)
                                 for c in path["configs"]], dtype=np.int64)
                meas = np.array(path["land"]["table"].objectives)
                res = path["res"]
                tried = set(rows.tolist()) | {
                    prob.space.flat_index(t.config) for t in
                    [t for r in res["runs"].values() for t in r.trials]
                    + list(res["sampled"])}
            comp = prob.space.compiled()
            t0 = time.perf_counter()
            whole = prob.objectives_for_rows(comp.valid_rows,
                                             calibrate.FIT_ARCH)
            host_us = (time.perf_counter() - t0) / len(whole) * 1e6
            model = prob.objectives_for_rows(rows, calibrate.FIT_ARCH)
            if not (np.isfinite(model).all() and np.isfinite(whole).all()):
                failures.append(f"costmodel {name}: the model gives inf to "
                                f"an admitted config")
                continue
            fitset = {r for r, _ in fit_rows[prob.name]}
            out = np.array([r not in fitset for r in rows.tolist()])
            rho = calibrate.spearman(model, meas)
            rho_out = calibrate.spearman(model[out], meas[out]) \
                if out.sum() > 2 else float("nan")
            pick = prob.space.from_flat_index(
                int(comp.valid_rows[int(np.argmin(whole))]))
            got = prob.evaluate(pick)
            if not got.ok:
                failures.append(f"costmodel {name}: its pick {pick} failed: "
                                f"{got.info}")
                continue
            share = float(meas.min()) / got.objective
            ratio = prob.evaluate(defaults[name], calibrate.FIT_ARCH) \
                .objective / default_s[name]
            held = holdout_rows(prob.space, tried | fitset, HOLDOUT,
                                HOLDOUT_SEED) \
                if len(rows) < comp.n_valid else np.empty(0, np.int64)
            held_s = np.array([prob.evaluate(
                prob.space.from_flat_index(int(r))).objective
                for r in held.tolist()])
            if not np.isfinite(held_s).all():
                failures.append(f"costmodel {name}: a held-out config "
                                f"failed to run")
                continue
            rho_held = calibrate.spearman(
                prob.objectives_for_rows(held, calibrate.FIT_ARCH), held_s) \
                if len(held) > 2 else float("nan")
            cm[name] = {"rho": rho, "rho_outside_fit": rho_out,
                        "rho_holdout": rho_held, "holdout": held.tolist(),
                        "holdout_s": held_s.tolist(),
                        "rows": len(rows), "outside_fit": int(out.sum()),
                        "pick": pick, "pick_ms": got.objective * 1e3,
                        "best_ms": float(meas.min()) * 1e3,
                        "pick_share": share,
                        "default_model_over_measured": ratio,
                        "host_us_per_config": host_us}
            print(f"  {name}: rho {rho:.3f} ({rho_out:.3f} on "
                  f"{int(out.sum())} of {len(rows)} rows outside the fit); "
                  f"pick {got.objective * 1e3:.4f} ms = {share:.1%} of the "
                  f"best {meas.min() * 1e3:.4f}; model/measured at the "
                  f"default {ratio:.3f}; {host_us:.2f} us a config on the "
                  f"host" + (f"; rho {rho_held:.3f} on {len(held)} held-out "
                             f"configs" if len(held) else ""))
        except Exception as e:          # the phase's failure, reported
            failures.append(f"costmodel {name}: {e!r}")
    fig5 = {}
    for name in ("flash_attention", "nbody", "pnpoly", "conv2d", "dedisp"):
        prob, path = paths[name]
        land = path["land"]
        if land["table"].protocol != "exhaustive":
            failures.append(f"costmodel {name}: Fig 5 needs the whole table, "
                            f"got {land['table'].protocol}")
            continue
        print(f"  {name}:", end=" ")
        try:
            fig5[name] = landscape.fig5(
                prob, land["trials"], {prob.arch: land["table"]})
        except Exception as e:
            failures.append(f"costmodel {name} Fig 5: {e!r}")
    return {"problems": cm, "portability": fig5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on a card")
    ap.add_argument("--budget", type=int, default=100,
                    help="evaluations per tuner in the GEMM path (>= 40)")
    ap.add_argument("--samples", type=int, default=1000,
                    help="configs landscape.main measures of each sampled "
                         "space, hotspot's at most HOTSPOT_SAMPLES (the "
                         "paper's is 10 000)")
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch import _build, landscape, quickstart
    from repro_torch import device as devmod
    from repro_torch.core.problem import L2_FLUSH_BYTES, cuda_event_seconds
    from repro_torch.kernels.common import admits, fitting_config
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.space import (AttentionProblem,
                                                     inputs_from_numpy,
                                                     numpy_inputs)
    from repro_torch.kernels.conv2d import kernel as ckernel
    from repro_torch.kernels.conv2d import ops as cops
    from repro_torch.kernels.conv2d.space import TILE_SHAPES as \
        CONV2D_TILE_SHAPES
    from repro_torch.kernels.conv2d.space import Conv2dProblem
    from repro_torch.kernels.conv2d.space import numpy_inputs as conv2d_inputs
    from repro_torch.kernels.conv2d.space import \
        tile_configs as conv2d_tile_configs
    from repro_torch.kernels.dedisp import kernel as dkernel
    from repro_torch.kernels.dedisp import ops as dops
    from repro_torch.kernels.dedisp.space import TILE_SHAPES as DEDISP_TILE_SHAPES
    from repro_torch.kernels.dedisp.space import DedispProblem
    from repro_torch.kernels.dedisp.space import numpy_inputs as dedisp_inputs
    from repro_torch.kernels.dedisp.space import \
        tile_configs as dedisp_tile_configs
    from repro_torch.kernels.expdist import kernel as ekernel
    from repro_torch.kernels.expdist import ops as eops
    from repro_torch.kernels.expdist.ref import expdist_reference
    from repro_torch.kernels.expdist.space import ExpdistProblem
    from repro_torch.kernels.hotspot import kernel as hkernel
    from repro_torch.kernels.hotspot import ops as hops
    from repro_torch.kernels.hotspot.space import HotspotProblem
    from repro_torch.kernels.hotspot.space import \
        numpy_inputs as hotspot_inputs
    from repro_torch.kernels.matmul import kernel, ops
    from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem
    from repro_torch.kernels.nbody import kernel as nkernel
    from repro_torch.kernels.nbody import ops as nops
    from repro_torch.kernels.nbody.ref import nbody_reference
    from repro_torch.kernels.nbody.space import NbodyProblem
    from repro_torch.kernels.pnpoly import kernel as pkernel
    from repro_torch.kernels.pnpoly import ops as pops
    from repro_torch.kernels.pnpoly.ref import pnpoly_reference
    from repro_torch.kernels.pnpoly.space import PnpolyProblem, laid_out
    from repro_torch.telemetry import trace

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    failures: list[str] = []     # checks that fail the run at its end

    KERNELS = kernel_table()

    def counts() -> dict:
        return {name: op.launches for name, (_, op) in KERNELS.items()}

    def device_counts() -> dict:
        return {name: op.device_launches for name, (_, op) in KERNELS.items()}

    def zero_counts() -> None:
        for _, op in KERNELS.values():
            op.launches = op.device_launches = 0

    with phase("probe"):
        info = devmod.probe("cuda")
        smi = nvidia_smi_line()
        print(f"device: {info}")
        print(f"nvidia-smi: {smi}")
        if not info.hopper:
            raise SystemExit(f"chip_smoke: needs sm_90, got {info.capability}")
        record["device"] = {"name": info.name, "nvidia_smi": smi,
                            "sm_count": info.sm_count}

    small = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    full = GemmProblem(device="cuda")
    fsmall = AttentionProblem(shape=AttentionProblem.small_shape,
                              device="cuda")
    ffull = AttentionProblem(device="cuda")
    nfull = NbodyProblem(device="cuda")
    pfull = PnpolyProblem(device="cuda")
    cfull = Conv2dProblem(device="cuda")
    hfull = HotspotProblem(device="cuda")
    efull = ExpdistProblem(device="cuda")
    dfull = DedispProblem(device="cuda")
    with phase("build"):
        built = _build.build_all({m.SOURCE: m.VARIANTS
                                  for m, _ in KERNELS.values()})
        build_s = max(b.seconds for b in built.values())
        kernel.libraries()
        fkernel.libraries()
        nkernel.library()
        pkernel.libraries()
        ckernel.libraries()
        hkernel.library()
        ekernel.library()
        dkernel.library()
        n_nvcc = sum(len(m.VARIANTS) for m, _ in KERNELS.values())
        print(f"build: {build_s:.1f} s ({n_nvcc} nvcc processes in "
              f"parallel, {len(built)} sources)")
        finished = sorted(((t, f"{src}[{v}]") for src, b in built.items()
                           for v, t in b.finished.items()), reverse=True)
        print("  the last nvcc to finish: " + ", ".join(
            f"{name} at {t:.1f} s" for t, name in finished[:4]))
        record["build_finished_s"] = {name: t for t, name in finished}
        tiles = {
            "gemm": {t: kernel.tile_attributes(*t) for t in sorted(
                {(c["rhs_layout"], c["block_m"], c["block_n"], c["block_k"],
                  c["warps"], c["stages"])
                 for c in full.space.valid_configs()})},
            # every compiled attention tile: d 128 runs the full shape, d 64
            # the small one
            "flash_attention": {(d, bkv, wg): fkernel.tile_attributes(
                d, bkv, wg) for d in fkernel.HEAD_DIMS
                for bkv, wg in fkernel.TILES},
            # every compiled tile of the three f32 kernels
            "nbody": {(u, m, d): nkernel.tile_attributes(u, m, d)
                      for u in nkernel.UNROLL_J
                      for m in ("exact", "approx") for d in ("f32", "bf16")},
            "pnpoly": {(b, u, r, pre, t): pkernel.tile_attributes(
                b, u, r, pre, t)
                for b in pkernel.BETWEEN_METHODS
                for u in pkernel.USE_METHODS for r in pkernel.UNROLL_V
                for pre in (0, 1) for t in sorted(
                    {pkernel.points_per_thread(bp)
                     for bp in pkernel.BLOCK_POINTS})},
            "conv2d": {(f, ufh, rc, cc, ufw, a, fs): ckernel.tile_attributes(
                f, ufh, rc, cc, ufw, a, fs)
                for f in ckernel.FILTER_SIZES
                for ufh in sorted({ckernel.snap_unroll(u, f)
                                   for u in ckernel.UNROLL})
                for ufw in sorted({ckernel.snap_unroll(u, f)
                                   for u in ckernel.UNROLL})
                for rc, cc in ckernel.TILES for a in ("f32", "bf16")
                for fs in (0, 1)},
            # every compiled tile of the three kernels of the sampled spaces
            "hotspot": {t: hkernel.tile_attributes(*t)
                        for t in hkernel.tiles()},
            "expdist": {(u, e, d): ekernel.tile_attributes(u, e, d)
                        for u in ekernel.UNROLL_J for e in ("exp", "exp2")
                        for d in ("f32", "bf16")},
            "dedisp": {(u, st, a): dkernel.tile_attributes(u, st, a)
                       for u, st in dkernel.tiles() for a in ("f32", "bf16")},
        }
        for name, attrs in tiles.items():
            spills = [(t, a) for t, a in attrs.items() if a["local_bytes"]]
            regs = [a["regs"] for a in attrs.values()]
            print(f"{name}: {len(attrs)} tiles, registers "
                  f"{min(regs)}..{max(regs)}, spilling: {spills or 'none'}")
            if spills:
                failures.append(f"{name} tiles spill: {spills}")
            # the six f32 kernels' spaces admit blocks of MAX_THREADS
            # (hotspot's per columns a lane, conv2d's per tile)
            most = getattr(KERNELS[name][0], "MAX_THREADS", None)

            def expect(t):
                if name == "conv2d":
                    return int(ckernel.max_threads(t[2], t[3], t[5]))
                return most[t[0]] if isinstance(most, dict) else most
            short = [t for t, a in attrs.items()
                     if most and a["max_threads"] < expect(t)]
            if short:
                failures.append(f"{name} tiles cannot launch {most} threads: "
                                f"{short}")
        for (d, bkv, wg), a in tiles["flash_attention"].items():
            print(f"  attention d={d} block_kv={bkv} warpgroups={wg}: "
                  f"{a['regs']} registers at entry, {a['local_bytes']} B "
                  f"local, {a['smem_bytes']} B shared")
        for (c, u, acc, ps), a in tiles["hotspot"].items():
            print(f"  hotspot {c} columns a lane, unroll_t {u}, {acc}, "
                  f"power_smem {ps}: {a['regs']} registers, "
                  f"{hkernel.MAX_THREADS[c]} threads at most")
        for t, a in tiles["gemm"].items():
            if t[-1] == max(kernel.STAGES):
                print(f"  gemm {t[0]} {t[1]}x{t[2]}x{t[3]} warps={t[4]}: "
                      f"{a['regs']} registers at entry, {a['smem_bytes']} B "
                      f"shared with {t[5]} stages")
        record["sass"] = {
            name: sass_check(name, built[KERNELS[name][0].SOURCE], failures)
            for name in ("gemm", "flash_attention")}
        # every compiled conv2d tile's SASS: no local memory, and the tap
        # loop's instruction counts against the shared reads it should issue
        csass = conv2d_sass(built[ckernel.SOURCE], failures)
        record["conv2d_sass"] = {str(k): v for k, v in csass.items()}
        big = max(csass.items(), key=lambda kv: kv[1]["bytes"])
        print(f"  conv2d SASS: {len(csass)} compiled tiles, "
              f"{sum(n['local'] for n in csass.values())} LDL/STL; largest "
              f"{big[1]['bytes']} B of code, {big[0]}")
        record["build_s"] = build_s

    def conv2d_sass_line(label: str, cfg: dict) -> None:
        """The SASS counts of ``cfg``'s tile beside the shared words a tap
        should read (``kernel.loads_per_fma``)."""
        f = cfull.shape["fh"]
        key = (f, ckernel.snap_unroll(cfg["unroll_fh"], f), cfg["acc_dtype"],
               cfg["row_chunk"], cfg["col_chunk"],
               ckernel.snap_unroll(cfg["unroll_fw"], f), cfg["filter_smem"])
        n = csass[key]
        print(f"  conv2d SASS of the {label} tile {key}: tap loop {n['loop']} "
              f"instructions, {n['taps']} taps (FFMA or bf16 HMUL2 + "
              f"HADD2), LDS.32/64/128 {n['lds32']}/{n['lds64']}/"
              f"{n['lds128']}, LDC {n['ldc']}, ULDC {n['uldc']}, LDL/STL "
              f"{n['local']}, other {n['other']}; non-tap per tap "
              f"{n['other_per_tap']:.4f}; {n['bytes']} B of code; design "
              f"{ckernel.loads_per_fma(cfg, f):.4f} shared words an FMA")
        record.setdefault("conv2d_sass_lines", {})[label] = dict(
            n, key=str(key), loads_per_fma=ckernel.loads_per_fma(cfg, f))

    worst = {k: {"rel_l2": 0.0, "max_abs_err": 0.0, "controls": 0,
                 "calls": 0, "mismatches": 0} for k in KERNELS}

    def hold(name: str, problem: str, cfg: dict, got, want, f32_plain,
             label: str) -> None:
        """``got`` (the kernel) against ``want`` (its plain version): within
        the JAX package's tolerance and within the kernel's ``PLAIN_TOL``.
        ``f32_plain``, when given, computes the plain version with an f32
        accumulator: the control that the kernel is nearer the bf16 one, or
        the tight check could not tell the two apart."""
        w = worst[name]
        plain_tol = KERNELS[name][0].PLAIN_TOL
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: bad {name} output for {cfg}")
        err = quickstart.rel_l2(got, want)
        mae = float((got.float() - want.float()).abs().max())
        tol = min(quickstart.tolerance(problem, cfg), plain_tol)
        note = ""
        if f32_plain is not None:
            far = quickstart.rel_l2(got, f32_plain())
            note = f" vs f32-acc plain {far:.2e}"
            w["controls"] += 1
            if not far > err:
                failures.append(f"{name}: bf16 not told apart "
                                f"from f32: {far:.3e} <= {err:.3e} for {cfg}")
        print(f"  rel_l2 {err:.2e} max_abs {mae:.3g} (tol {tol:g}){note} "
              f"{label}{cfg}")
        if not err <= tol:
            failures.append(f"{name} disagrees with its plain version: "
                            f"rel_l2 {err:.3e} > {tol:g} for {label}{cfg}")
        w["rel_l2"] = max(w["rel_l2"], err)
        w["max_abs_err"] = max(w["max_abs_err"], mae)
        w["calls"] += 1

    def launched_once(op, before: int) -> None:
        torch.cuda.synchronize()
        if op.launches != before + 1:
            raise SystemExit("chip_smoke: launch counter did not rise by 1")

    def gemm_parity(cfg: dict, x: dict, b_nk) -> None:
        b = x["b"] if cfg["rhs_layout"] == "kn" else b_nk
        before = ops.gemm.launches
        got = ops.gemm(x["a"], b, x["c"], x["alpha"], x["beta"], cfg)
        launched_once(ops.gemm, before)
        args = dict(alpha=x["alpha"], beta=x["beta"])
        control = None
        if cfg["acc_dtype"] == "bf16" \
                and x["a"].shape[1] // cfg["split_k"] > cfg["block_k"]:
            def control():
                return kernel.gemm_plain(x["a"], b, x["c"], **args,
                                         **dict(cfg, acc_dtype="f32"))
        hold("gemm", "gemm_h100", cfg, got,
             kernel.gemm_plain(x["a"], b, x["c"], **args, **cfg), control, "")

    def attention_parity(cfg: dict, x: dict, causal: bool) -> None:
        q, k, v = x["q"], x["k"], x["v"]
        before = fops.attention.launches
        got = fops.attention(q, k, v, causal=causal, config=cfg)
        launched_once(fops.attention, before)
        control = None
        if cfg["acc_dtype"] == "bf16" and k.shape[1] > cfg["block_kv"]:
            def control():
                return fkernel.flash_attention_plain(
                    q, k, v, causal=causal, **dict(cfg, acc_dtype="f32"))
        hold("flash_attention", "flash_attention_h100", cfg, got,
             fkernel.flash_attention_plain(q, k, v, causal=causal, **cfg),
             control, f"{tuple(q.shape)}x{tuple(k.shape)} causal={causal} ")

    def nbody_parity(cfg: dict, x: dict) -> None:
        soa = cfg["layout"] == "soa"
        pos = x["pos"] if soa else nkernel.to_aos(x["pos"], x["mass"])
        mass = x["mass"] if soa else None
        before = nops.nbody.launches
        got = nops.nbody(pos, mass, cfg)
        launched_once(nops.nbody, before)
        control = None
        if cfg["compute_dtype"] == "bf16":
            def control():
                return nkernel.nbody_plain(pos, mass,
                                           **dict(cfg, compute_dtype="f32"))
        hold("nbody", "nbody_h100", cfg, got,
             nkernel.nbody_plain(pos, mass, **cfg), control,
             f"n={x['pos'].shape[1]} ")

    def conv2d_parity(cfg: dict, x: dict) -> None:
        """Exactly in bf16, within ``PLAIN_TOL`` in f32."""
        image, filt = x["image"], x["filt"]
        before = cops.conv2d.launches
        got = cops.conv2d(image, filt, cfg)
        launched_once(cops.conv2d, before)
        want = ckernel.conv2d_plain(image, filt, **cfg)
        label = f"{tuple(image.shape)}*{tuple(filt.shape)} "
        if cfg["acc_dtype"] == "bf16":
            exact("conv2d", cfg, got, want,
                  lambda: ckernel.conv2d_plain(image, filt,
                                               **dict(cfg, acc_dtype="f32")),
                  label)
        else:
            hold("conv2d", "conv2d_h100", cfg, got, want, None, label)

    def pnpoly_parity(cfg: dict, x: dict) -> torch.Tensor:
        """The kernel against its plain version, point for point: any
        mismatching point fails the run."""
        pts = laid_out(x["points"], cfg)
        before = pops.pnpoly.launches
        got = pops.pnpoly(pts, x["poly"], cfg)
        launched_once(pops.pnpoly, before)
        if got.dtype != torch.int32:
            raise SystemExit(f"chip_smoke: bad pnpoly output for {cfg}")
        exact("pnpoly", cfg, got, pkernel.pnpoly_plain(pts, x["poly"], **cfg),
              None, f"{tuple(x['poly'].shape)} ")
        return got

    def exact(name: str, cfg: dict, got, want, f32_plain, label: str) -> None:
        """``got`` (the kernel) against ``want`` (its plain version), output
        for output: any mismatching output fails the run.  ``f32_plain``,
        when given, computes the plain version with an f32 accumulator: the
        control that the bf16 result is not the f32 one."""
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: bad {name} output for {cfg}")
        bad = int((got != want).sum())
        w = worst[name]
        w["mismatches"] += bad
        w["max_abs_err"] = max(w["max_abs_err"],
                               float((got - want).abs().max()))
        w["rel_l2"] = max(w["rel_l2"], quickstart.rel_l2(got, want))
        w["calls"] += 1
        note = ""
        if f32_plain is not None:
            far = int((got != f32_plain()).sum())
            note = f" vs f32-acc plain {far} differ"
            w["controls"] += 1
            if not far:
                failures.append(f"{name}: bf16 not told apart from f32 for "
                                f"{cfg}")
        print(f"  mismatches {bad} of {got.numel()} (tol 0){note} "
              f"{label}{cfg}")
        if bad:
            failures.append(f"{name} disagrees with its plain version on "
                            f"{bad} outputs for {label}{cfg}")

    def hotspot_parity(cfg: dict, x: dict) -> None:
        """On the whole domain: exactly in bf16, within ``PLAIN_TOL`` in
        f32."""
        temp, power, n = x["temp"], x["power"], x["n_sweeps"]
        before = hops.hotspot.launches
        got = hops.hotspot(temp, power, n, cfg)
        launched_once(hops.hotspot, before)
        want = hkernel.hotspot_plain(temp, power, n, **cfg)
        label = f"{tuple(temp.shape)} x{n} sweeps "
        if cfg["acc_dtype"] == "bf16":
            exact("hotspot", cfg, got, want,
                  lambda: hkernel.hotspot_plain(
                      temp, power, n, **dict(cfg, acc_dtype="f32")), label)
        else:
            hold("hotspot", "hotspot_h100", cfg, got, want, None, label)

    def expdist_parity(cfg: dict, x: dict) -> None:
        a, b, sa, sb = x["a"], x["b"], x["sa"], x["sb"]
        before = eops.expdist.launches
        got = eops.expdist(a, b, sa, sb, cfg)
        launched_once(eops.expdist, before)
        control = None
        if cfg["compute_dtype"] == "bf16":
            def control():
                return ekernel.expdist_plain(
                    a, b, sa, sb, **dict(cfg, compute_dtype="f32"))
        hold("expdist", "expdist_h100", cfg, got,
             ekernel.expdist_plain(a, b, sa, sb, **cfg), control,
             f"{a.shape[1]}x{b.shape[1]} ")

    def dedisp_parity(cfg: dict, x: dict) -> None:
        """Output for output, in both acc_dtypes."""
        xx, dl, t_out = x["x"], x["delays"], x["t_out"]
        before = dops.dedisp.launches
        got = dops.dedisp(xx, dl, t_out, cfg)
        launched_once(dops.dedisp, before)
        control = None
        if cfg["acc_dtype"] == "bf16":
            def control():
                return dkernel.dedisp_plain(xx, dl, t_out,
                                            **dict(cfg, acc_dtype="f32"))
        exact("dedisp", cfg, got, dkernel.dedisp_plain(xx, dl, t_out, **cfg),
              control, f"{tuple(xx.shape)} -> {tuple(got.shape)} ")

    with phase("parity"):
        x = small.make_inputs(seed=3, small=True)
        x_nk = x["b"].t().contiguous()
        cfgs = gemm_parity_configs(small.space, kernel)
        print(f"gemm: {len(cfgs)} configs at {SMALL_SHAPE}, alpha 0.75, "
              f"beta 0.5: every compiled tile at every stage count")
        for cfg in cfgs:
            gemm_parity(cfg, x, x_nk)
        xf = full.make_inputs(seed=4, small=False)
        xf_nk = xf["b"].t().contiguous()
        dflt = dict(ops.DEFAULT_CONFIG)
        big = [dflt, dict(dflt, rhs_layout="nk", stages=2),
               dict(dflt, split_k=4, stages=3),
               dict(dflt, acc_dtype="bf16", unroll_k=2)] \
            + full.space.sample_distinct(2, 9)
        print(f"gemm: {len(big)} configs at {full.shape}")
        for cfg in big:
            gemm_parity(cfg, xf, xf_nk)

        acfgs = covering_configs(fsmall.space, 12, seed=5)
        print(f"attention: {len(acfgs)} configs at {fsmall.shape}, causal "
              f"and full, and at tq=128, tk=256")
        xa = fsmall.make_inputs(seed=3, small=True)
        xr = inputs_from_numpy(numpy_inputs(7, 4, 2, 128, 256, 64), "cuda")
        for cfg in acfgs:
            attention_parity(cfg, xa, True)
            attention_parity(cfg, xa, False)
            attention_parity(cfg, xr, True)
        menu = attention_parity_configs(fkernel)
        print(f"attention: every compiled (d, block_kv, warpgroups), "
              f"{len(menu)} a head dim, at 8 q heads and 2 kv heads, 256 x "
              f"256 causal and full and 128 x 256")
        for dh in fkernel.HEAD_DIMS:
            xg = inputs_from_numpy(numpy_inputs(5, 8, 2, 256, 256, dh),
                                   "cuda")
            xgr = inputs_from_numpy(numpy_inputs(6, 8, 2, 128, 256, dh),
                                    "cuda")
            for cfg in menu:
                attention_parity(cfg, xg, True)
                attention_parity(cfg, xg, False)
                attention_parity(cfg, xgr, True)
        xaf = ffull.make_inputs(seed=4, small=False)
        abig = [dict(fops.DEFAULT_CONFIG)] + ffull.space.sample_distinct(2, 9)
        print(f"attention: {len(abig)} configs at {ffull.shape}")
        for cfg in abig:
            attention_parity(cfg, xaf, True)

        for shape in (NbodyProblem.small_shape, {"n": 4096}):
            prob = NbodyProblem(shape=shape, device="cuda")
            ncfgs = covering_configs(prob.space, 8, seed=5)
            print(f"nbody: {len(ncfgs)} configs at {shape}")
            xn = prob.make_inputs(seed=3, small=False)
            for cfg in ncfgs:
                nbody_parity(cfg, xn)
        xnf = nfull.make_inputs(seed=4, small=False)
        nbig = [dict(nops.DEFAULT_CONFIG)] + nfull.space.sample_distinct(2, 9)
        print(f"nbody: {len(nbig)} configs at {nfull.shape}")
        for cfg in nbig:
            nbody_parity(cfg, xnf)

        psmall = PnpolyProblem(shape=PnpolyProblem.small_shape, device="cuda")
        pcfgs = covering_configs(psmall.space, 12, seed=5)
        print(f"pnpoly: {len(pcfgs)} configs at {psmall.shape}")
        xp = psmall.make_inputs(seed=3, small=True)
        for cfg in pcfgs:
            pnpoly_parity(cfg, xp)
        # the full shape, on the inputs the quickstart checks its winner
        # with (seed 0): three configs, then all twelve method variants,
        # which must agree with each other and with the oracle point for
        # point
        xpf = pfull.make_inputs(seed=0, small=False)
        pbig = [dict(pops.DEFAULT_CONFIG)] + pfull.space.sample_distinct(2, 9)
        print(f"pnpoly: {len(pbig)} configs at {pfull.shape}")
        for cfg in pbig:
            pnpoly_parity(cfg, xpf)
        oracle = pnpoly_reference(xpf["points"], xpf["poly"])
        variants = {(b, u): pnpoly_parity(
            dict(pops.DEFAULT_CONFIG, between_method=b, use_method=u), xpf)
            for b in pkernel.BETWEEN_METHODS for u in pkernel.USE_METHODS}
        off = {k: int((v != oracle).sum()) for k, v in variants.items()}
        # points exactly level with a vertex, and how many of them the
        # reference's own between_method 1, (y1 - py) * (y2 - py) < 0
        # alone, would call wrongly (the port's method 1 does not)
        poly = xpf["poly"]
        level = torch.isin(xpf["points"][1], poly[1])
        px, py = (xpf["points"][:, level][i][None, :] for i in (0, 1))
        x1, y1 = poly[0][:, None], poly[1][:, None]
        x2, y2 = torch.roll(x1, -1, 0), torch.roll(y1, -1, 0)
        den = y2 - y1
        slope = (x2 - x1) / torch.where(den == 0, torch.ones_like(den), den)
        ref_m1 = (((y1 - py) * (y2 - py) < 0)
                  & (px < slope * (py - y1) + x1)).sum(0) % 2
        flips = int((ref_m1 != oracle[level]).sum())
        print(f"pnpoly: the twelve variants at {pfull.shape}: points off "
              f"the oracle {off}; {int(level.sum())} points level with a "
              f"vertex, {flips} of them wrong under the reference's "
              f"between_method 1")
        if any(off.values()):
            failures.append(f"pnpoly variants disagree with the oracle: {off}")
        record["pnpoly_variants"] = {"off_oracle": {f"b{b}u{u}": v for (b, u),
                                                    v in off.items()},
                                     "level_points": int(level.sum()),
                                     "reference_m1_flips": flips}

        prob = Conv2dProblem(shape=Conv2dProblem.small_shape, device="cuda")
        ccfgs = covering_configs(prob.space, 12, seed=5)
        print(f"conv2d: {len(ccfgs)} configs at {prob.shape}")
        xc = prob.make_inputs(seed=3, small=False)
        for cfg in ccfgs:
            conv2d_parity(cfg, xc)
        # every compiled tile at both filter sizes, on shapes no block
        # divides, one with rows of a multiple of 4 floats (cp.async
        # staging) and one without (plain loads)
        for shape in CONV2D_TILE_SHAPES:
            tcfgs = conv2d_tile_configs(*shape)
            print(f"conv2d: every compiled tile ({len(tcfgs)}) at {shape}")
            xt = inputs_from_numpy(conv2d_inputs(2, *shape), "cuda",
                                   dtype=torch.float32)
            for cfg in tcfgs:
                conv2d_parity(cfg, xt)
        xcf = cfull.make_inputs(seed=4, small=False)
        cbig = [dict(cops.DEFAULT_CONFIG)] + cfull.space.sample_distinct(2, 9)
        print(f"conv2d: {len(cbig)} configs at {cfull.shape}")
        for cfg in cbig:
            conv2d_parity(cfg, xcf)

        for prob_cls, shapes, parity, full_prob in (
                (HotspotProblem, ({"h": 200, "w": 300, "n_total": 12},),
                 hotspot_parity, hfull),
                (ExpdistProblem, ({"ka": 5000, "kb": 3000},), expdist_parity,
                 efull),
                (DedispProblem, ({"c": 96, "d": 160, "t_out": 1024,
                                  "t_in": 2048, "dm_step": 0.5},),
                 dedisp_parity, dfull)):
            for shape in (prob_cls.small_shape,) + shapes:
                prob = prob_cls(shape=shape, device="cuda")
                cfgs = covering_configs(prob.space, 12, seed=5)
                print(f"{prob.name}: {len(cfgs)} configs at {prob.shape}")
                xs = prob.make_inputs(seed=3, small=False)
                for cfg in cfgs:
                    parity(cfg, xs)
        # every compiled hotspot tile, 12 sweeps in launches of 4, on a
        # domain larger than its tile and on one smaller (the EDGE path)
        print(f"hotspot: every compiled tile ({len(hkernel.tiles())}) on "
              f"224 x 324 and 30 x 30, 12 sweeps")
        for h, w in ((200, 300), (6, 6)):
            xt = inputs_from_numpy(hotspot_inputs(1, h, w, 12), "cuda",
                                   dtype=torch.float32)
            for cfg in hkernel.tile_configs():
                hotspot_parity(cfg, xt)
        # every compiled dedisp tile in both acc_dtypes, on the problem's
        # table, one where a channel's DMs share one delay, one where all
        # differ
        print(f"dedisp: every compiled tile ({len(dkernel.tiles())}) x "
              f"acc_dtype at {DEDISP_TILE_SHAPES}, three delay tables")
        for c_, d_, to_, ti_, step_ in DEDISP_TILE_SHAPES:
            xt = inputs_from_numpy(dedisp_inputs(2, c_, d_, to_, ti_, step_),
                                   "cuda", dtype=torch.float32)
            for table in dedisp_tables(xt["delays"], ti_ - to_).values():
                xtt = dict(xt, delays=table)
                for cfg in dedisp_tile_configs(c_, d_, to_, ti_).values():
                    for acc in ("f32", "bf16"):
                        dedisp_parity(dict(cfg, acc_dtype=acc), xtt)
        xhf = hfull.make_inputs(seed=4, small=False)
        xef = efull.make_inputs(seed=4, small=False)
        xdf = dfull.make_inputs(seed=4, small=False)
        for prob, parity, xs, dcfg in (
                (hfull, hotspot_parity, xhf, hops.DEFAULT_CONFIG),
                (efull, expdist_parity, xef, eops.DEFAULT_CONFIG),
                (dfull, dedisp_parity, xdf, dops.DEFAULT_CONFIG)):
            big = [dict(dcfg)] + prob.space.sample_distinct(2, 9)
            print(f"{prob.name}: {len(big)} configs at {prob.shape}")
            for cfg in big:
                parity(cfg, xs)

        for name, w in worst.items():
            if name != "pnpoly" and not w["controls"]:
                failures.append(f"{name}: no bf16 config ran the control")
        record["parity"] = worst

    with phase("main"):
        zero_counts()
        t0 = time.perf_counter()
        with trace.tracing():        # host spans; device times are events
            res = quickstart.main(device="cuda", budget=args.budget,
                                  sample=64)
        main_s = time.perf_counter() - t0
        launched = counts()
        launches, gemm_issued = launched["gemm"], device_counts()["gemm"]
        trials = [t for r in res["runs"].values() for t in r.trials] \
            + list(res["sampled"])
        bad = [(t.config, t.info) for t in trials if not t.ok]
        print(f"kernel launches in the GEMM path: {launched}; "
              f"{len(trials)} trials, {len(bad)} invalid")
        if launches <= 0:
            raise SystemExit("chip_smoke: the GEMM path launched no kernel")
        if bad:
            raise SystemExit(f"chip_smoke: admitted configs were invalid: "
                             f"{bad[:5]}")
        spans = trace.summarize()
        for sp in spans:
            print(f"  span {sp['name']:15s} x{sp['count']:4d} "
                  f"{sp['total_ms']:9.1f} ms")
        print(f"  GEMM path {main_s:.2f} s on the host clock, "
              f"{main_s / len(trials) * 1e3:.1f} ms per measured config")
        record["spans"] = spans
        record["main_s"] = main_s
        best = res["best"]
        gemm_parity(best.config, xf, xf_nk)      # the winner at 4096^3
        record["trials"] = [{"config": t.config, "info": t.info}
                            for t in trials]
        gemm_trials = trials

    def run_path(problem: str, name: str, prob, winner_parity,
                 samples: int | None = None) -> dict:
        """One problem's path: the quickstart (random search and GA, budget
        60 each, 64 sampled configs), then ``landscape.main`` over the
        whole space, or ``samples`` configs of a sampled one, with the counts
        set to 0 just before and read just after; then the winner against
        its plain version."""
        zero_counts()
        t0 = time.perf_counter()
        with trace.tracing():
            res = quickstart.main(problem=problem, device="cuda", budget=60,
                                  sample=64)
            land = landscape.main(problem=problem, device="cuda",
                                  samples=samples)
        path_s = time.perf_counter() - t0
        launched, issued = counts(), device_counts()
        trials = [t for r in res["runs"].values() for t in r.trials] \
            + list(res["sampled"]) + list(land["trials"])
        bad = [(t.config, t.info) for t in trials if not t.ok]
        print(f"kernel launches in the {name} path: {launched}; CUDA "
              f"kernels issued: {issued}; {len(trials)} trials, {len(bad)} "
              f"invalid "
              f"({land['invalid']} of {len(land['trials'])} in the "
              f"{land['table'].protocol} table)")
        if launched[name] <= 0:
            raise SystemExit(f"chip_smoke: the {name} path launched no "
                             f"kernel")
        if bad:
            raise SystemExit(f"chip_smoke: admitted {name} configs were "
                             f"invalid: {bad[:5]}")
        spans = trace.summarize()
        for sp in spans:
            print(f"  span {sp['name']:15s} x{sp['count']:4d} "
                  f"{sp['total_ms']:9.1f} ms")
        print(f"  {name} path {path_s:.2f} s on the host clock, "
              f"{path_s / len(trials) * 1e3:.1f} ms per measured config")
        best = res["best"]
        winner_parity(best.config)          # the winner, full shape
        table = land["table"]
        ex_best_enc, table_best_s = table.best()
        cfgs_t = [prob.space.decode(c) for c in table.configs]
        print(f"  {table.protocol} table's best {table_best_s * 1e3:.4f} ms "
              f"{prob.space.decode(ex_best_enc)}; tuners' best "
              f"{best.objective * 1e3:.4f} ms")
        record[name] = {
            "spans": spans, "path_s": path_s, "landscape": {
                k: land[k] for k in ("speedup", "n90", "n99", "centrality",
                                     "pfi", "r2", "pfi_sum", "table8",
                                     "best_config", "invalid", "seconds",
                                     "analyse_seconds")},
            "table": [{"config": c, "seconds": o}
                      for c, o in zip(cfgs_t, table.objectives)],
            "trials": [{"config": t.config, "info": t.info}
                       for t in trials]}
        return {"res": res, "land": land, "launches": launched[name],
                "device_launches": issued[name],
                "best": best, "table_best_s": table_best_s, "configs": cfgs_t,
                "protocol": table.protocol}

    with phase("attention"):
        apath = run_path("flash_attention_h100", "flash_attention", ffull,
                         lambda c: attention_parity(c, xaf, True))
        abest, alaunches = apath["best"], apath["launches"]
        aissued = apath["device_launches"]
        table_best_s = apath["table_best_s"]
        cfgs_t, objs = apath["configs"], apath["land"]["table"].objectives
        f32_h1 = min((o, i) for i, (c, o) in enumerate(zip(cfgs_t, objs))
                     if c["acc_dtype"] == "f32" and c["block_h"] == 1)
        print(f"  fastest f32 attention config with block_h 1 "
              f"{f32_h1[0] * 1e3:.4f} ms {cfgs_t[f32_h1[1]]}")

    with phase("nbody"):
        npath = run_path("nbody_h100", "nbody", nfull,
                         lambda c: nbody_parity(c, xnf))
        # the winner's distance to the oracle in f32 (the quickstart's
        # check) and in f64
        x0 = nfull.make_inputs(seed=0, small=False)
        got = nfull.run_kernel(npath["best"].config, x0)
        f64 = nbody_reference(x0["pos"].double(), x0["mass"].double())
        n_f64 = quickstart.rel_l2(got, f64)
        print(f"  nbody winner vs the f32 oracle {npath['res']['rel_l2']:.3e}"
              f", vs an f64 oracle {n_f64:.3e} (tolerance "
              f"{quickstart.tolerance('nbody_h100', npath['best'].config):g})")
        record["nbody"]["winner_rel_l2"] = {"f32": npath["res"]["rel_l2"],
                                            "f64": n_f64}
        del x0, got, f64

    with phase("pnpoly"):
        ppath = run_path("pnpoly_h100", "pnpoly", pfull,
                         lambda c: pnpoly_parity(c, xpf))

    with phase("conv2d"):
        cpath = run_path("conv2d_h100", "conv2d", cfull,
                         lambda c: conv2d_parity(c, xcf))

    with phase("hotspot"):
        hpath = run_path("hotspot_h100", "hotspot", hfull,
                         lambda c: hotspot_parity(c, xhf),
                         min(args.samples, HOTSPOT_SAMPLES))

    with phase("expdist"):
        epath = run_path("expdist_h100", "expdist", efull,
                         lambda c: expdist_parity(c, xef), args.samples)
        # the winner's distance to the oracle in f32 (the quickstart's
        # check) and in f64, which must hold too
        x0 = efull.make_inputs(seed=0, small=False)
        got = efull.run_kernel(epath["best"].config, x0)
        f64 = expdist_reference(*(x0[k].double()
                                  for k in ("a", "b", "sa", "sb")))
        e_f64 = quickstart.rel_l2(got, f64)
        e_tol = quickstart.tolerance("expdist_h100", epath["best"].config)
        print(f"  expdist winner vs the f32 oracle "
              f"{epath['res']['rel_l2']:.3e}, vs an f64 oracle {e_f64:.3e} "
              f"(tolerance {e_tol:g})")
        if not e_f64 <= e_tol:
            failures.append(f"expdist winner misses the f64 oracle: "
                            f"{e_f64:.3e} > {e_tol:g}")
        record["expdist"]["winner_rel_l2"] = {"f32": epath["res"]["rel_l2"],
                                              "f64": e_f64}
        del x0, got, f64

    with phase("dedisp"):
        dpath = run_path("dedisp_h100", "dedisp", dfull,
                         lambda c: dedisp_parity(c, xdf), args.samples)

    # Operations are counted from the reference's expression as the card
    # issues them: an f32 add, multiply or fused multiply-add is one
    # instruction, the expression's multiply-then-add pairs fused
    m, n, k = (full.shape[d] for d in "mnk")
    flops = 2.0 * m * n * k
    # A, B, C read once and the output written once, bf16; the epilogue's
    # alpha * acc + beta * c (a multiply and a multiply-add an output) runs
    # beside the tensor cores
    bound_s, bound_by = bound(flops, 2.0 * m * n,
                              2.0 * (m * k + k * n + m * n + m * n))
    hq, hkv, tq, tk, d = (ffull.shape[s] for s in
                          ("hq", "hkv", "tq", "tk", "d"))
    # the visible (row, column) pairs of the causal mask: QK^T and PV take
    # 2 * d FLOP each on the tensor cores; scale, mask, max, the exponent's
    # shift and the sum about 5 f32 instructions and the exponential one
    # special-function result; q, k, v read and the output written once
    pairs = hq * sum(min(tk, max(0, r + tk - tq + 1)) for r in range(tq))
    abound_s, abound_by = bound(4.0 * d * pairs, 5.0 * pairs,
                                2.0 * d * (2 * hq * tq + 2 * hkv * tk),
                                sfu_ops=float(pairs))
    # the six f32 kernels use no tensor core.  nbody: N^2 pairs at 17 f32
    # instructions each with rsqrt_method approx, the cheaper (three
    # differences; r^2's multiply, two multiply-adds and the softening add;
    # the Newton step's three multiplies and a multiply-add; inv^3's two
    # multiplies; the mass's multiply; three multiply-adds into the sums)
    # and one rsqrt; pos and mass read once, the (3, N) output written once
    nb = nfull.shape["n"]
    nbound_s, nbound_by = bound(0.0, 17.0 * nb * nb, 4.0 * (4 * nb + 3 * nb),
                                sfu_ops=float(nb) * nb)
    # pnpoly: N x V point-edge pairs at 6 instructions each (the two
    # comparisons with the point's y and their xor, two; the crossing's
    # subtract and multiply-add; its comparison; the parity update); the
    # points and polygon read once, the int32 flags written once
    pn, pv = pfull.shape["n"], pfull.shape["v"]
    pbound_s, pbound_by = bound(0.0, 6.0 * pn * pv,
                                4.0 * (2 * pn + 2 * pv + pn))
    # conv2d: every output takes F^2 multiply-adds; the image and filter
    # read once, the output written once
    ch, cw, cf = cfull.shape["h"], cfull.shape["w"], cfull.shape["fh"]
    coh, cow = ch - cf + 1, cw - cf + 1
    cbound_s, cbound_by = bound(0.0, 1.0 * coh * cow * cf * cf,
                                4.0 * (ch * cw + cf * cf + coh * cow))
    # hotspot: every cell of the padded domain takes 9 f32 instructions a
    # sweep (the two second differences, an add and a multiply-add each;
    # amb - t; the three weighted terms, three multiply-adds; the step, one
    # multiply-add); temp and power read once, the domain written once
    hh, hw = xhf["temp"].shape
    hn = xhf["n_sweeps"]
    hbound_s, hbound_by = bound(0.0, 9.0 * hh * hw * hn, 4.0 * 3 * hh * hw)
    # expdist: every pair takes 10 f32 instructions (two differences; r^2's
    # multiply and multiply-add; sa^2 + sb^2 and its doubling; the
    # division's two refining multiply-adds; the exponent's scaling by
    # log2(e); the running sum) and two special-function results (the
    # division's reciprocal and the exponential's exp2); a, b, sa, sb read
    # once and the scalar written once
    eka, ekb = efull.shape["ka"], efull.shape["kb"]
    epairs = float(eka) * ekb
    ebound_s, ebound_by = bound(0.0, 10.0 * epairs,
                                4.0 * (3 * eka + 3 * ekb + 1),
                                sfu_ops=2.0 * epairs)
    # dedisp: one add per channel, DM and sample out; x and the delays read
    # once, the output written once
    (dc, dt_in), (_, dd) = xdf["x"].shape, xdf["delays"].shape
    dto = xdf["t_out"]
    dbound_s, dbound_by = bound(0.0, float(dc) * dd * dto,
                                4.0 * (dc * dt_in + dc * dd + dd * dto))

    with phase("timing"):
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                            device="cuda")
        default = full.evaluate(ops.DEFAULT_CONFIG)
        if not default.ok:
            raise SystemExit(f"chip_smoke: default config failed: "
                             f"{default.info}")
        a, b, c = xf["a"], xf["b"], xf["c"]
        plain_s = statistics.median(cuda_event_seconds(
            lambda: kernel.gemm_plain(a, b, c, alpha=0.75, beta=0.5,
                                      **ops.DEFAULT_CONFIG),
            repeats=3, warmup=1, flush=flush))
        lib_s = statistics.median(cuda_event_seconds(
            lambda: torch.addmm(c, a, b, beta=0.5, alpha=0.75),
            repeats=10, warmup=3, flush=flush))
        t_best = best.objective
        print(f"gemm best config {best.config}")
        print(f"  median {t_best * 1e3:.4f} ms = {flops / t_best / 1e12:.1f} "
              f"TFLOP/s = {bound_s / t_best:.1%} of the {bound_s * 1e3:.4f} "
              f"ms bound ({bound_by}) = {t_best / lib_s:.3f}x library_ms")
        print(f"gemm default config {default.objective * 1e3:.4f} ms; plain "
              f"version {plain_s * 1e3:.3f} ms; library_ms (torch.addmm) "
              f"{lib_s * 1e3:.4f} ms")
        # the tuned config at each ring depth, with B's other layout and a
        # bf16 accumulator, and a 128 x 128 tile on one and on two
        # consumer warpgroups
        sweep = {}
        other = {"kn": "nk", "nk": "kn"}[best.config["rhs_layout"]]
        for change in ([{"stages": st} for st in kernel.STAGES]
                       + [{"rhs_layout": other}, {"acc_dtype": "bf16"}]
                       + [{"block_m": 128, "block_n": 128, "warps": w}
                          for w in kernel.WARPS]):
            cfg = dict(best.config, **change)
            if cfg == best.config or not full.space.satisfies(cfg):
                continue
            t_s = full.evaluate(cfg).objective
            label = " ".join(f"{k}={v}" for k, v in change.items())
            sweep[label] = t_s * 1e3
            print(f"  tuned with {label}: {t_s * 1e3:.4f} ms")
        record["gemm_sweep_ms"] = sweep
        print(f"gemm speedup over median: {res['speedup']:.3f}x over "
              f"{len(res['table'])} sampled configs")

        adefault = ffull.evaluate(fops.DEFAULT_CONFIG)
        if not adefault.ok:
            raise SystemExit(f"chip_smoke: attention default config "
                             f"failed: {adefault.info}")
        q, kk, v = xaf["q"], xaf["k"], xaf["v"]
        aplain_s = statistics.median(cuda_event_seconds(
            lambda: fkernel.flash_attention_plain(q, kk, v,
                                                  **fops.DEFAULT_CONFIG),
            repeats=3, warmup=1, flush=flush))
        # SDPA aligns its causal mask to the top left: the same function
        # only where tq == tk, which the default shape has
        alib_s = None
        if tq == tk:
            q4, k4, v4 = q[None], kk[None], v[None]
            alib_s = statistics.median(cuda_event_seconds(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True),
                repeats=10, warmup=3, flush=flush))
            sdpa = F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True)[0]
            print(f"attention kernel vs scaled_dot_product_attention rel_l2 "
                  f"{quickstart.rel_l2(fops.attention(q, kk, v), sdpa):.2e}")
        at_best = abest.objective
        print(f"attention tuned config {abest.config}")
        print(f"  median {at_best * 1e3:.4f} ms = "
              f"{4.0 * d * pairs / at_best / 1e12:.1f} TFLOP/s = "
              f"{abound_s / at_best:.1%} of the {abound_s * 1e3:.4f} ms "
              f"bound ({abound_by})"
              + ("" if alib_s is None else
                 f" = {at_best / alib_s:.3f}x library_ms"))
        print(f"attention default config {adefault.objective * 1e3:.4f} ms; "
              f"plain version {aplain_s * 1e3:.3f} ms; library_ms "
              f"(scaled_dot_product_attention) "
              f"{'n/a' if alib_s is None else f'{alib_s * 1e3:.4f}'} ms")
        # the tuned config with skip_masked and acc_dtype flipped, and at
        # every (block_q, block_h) of the group: one consumer warpgroup (64
        # rows) or two (128)
        asweep = {}
        achanges = [{"skip_masked": 1 - abest.config["skip_masked"]},
                    {"acc_dtype": {"f32": "bf16", "bf16": "f32"}[
                        abest.config["acc_dtype"]]}] \
            + [{"block_q": bq, "block_h": bh}
               for bh in ffull.space.param("block_h").values
               for bq in fkernel.BLOCK_Q if bq * bh in fkernel.ROWS]
        for change in achanges:
            cfg = dict(abest.config, **change)
            if cfg == abest.config or not ffull.space.satisfies(cfg):
                continue
            t_s = ffull.evaluate(cfg).objective
            label = " ".join(f"{k}={v}" for k, v in change.items())
            asweep[label] = t_s * 1e3
            wgs = fkernel.warpgroups(cfg["block_q"], cfg["block_h"])
            print(f"  tuned with {label} ({wgs} consumer warpgroups): "
                  f"{t_s * 1e3:.4f} ms = "
                  f"{4.0 * d * pairs / t_s / 1e12:.1f} TFLOP/s = "
                  f"{abound_s / t_s:.1%} of the bound")
        print(f"  (the products it issues are 1.5x the bound's, P as bf16 hi "
              f"+ lo: their floor is {1.5 * abound_s * 1e3:.4f} ms)")
        record["attention_sweep_ms"] = asweep

        default_s = {"gemm": default.objective,
                     "flash_attention": adefault.objective}
        f32_lines = []
        torch.backends.cudnn.benchmark = True
        for name, prob, path, dcfg, plain, lib, (b_s, b_by), replaces in (
                ("nbody", nfull, npath, nops.DEFAULT_CONFIG,
                 lambda: nkernel.nbody_plain(xnf["pos"], xnf["mass"],
                                             **nops.DEFAULT_CONFIG),
                 None, (nbound_s, nbound_by), "nbody/kernel.py:81"),
                ("pnpoly", pfull, ppath, pops.DEFAULT_CONFIG,
                 lambda: pkernel.pnpoly_plain(xpf["points"], xpf["poly"],
                                              **pops.DEFAULT_CONFIG),
                 None, (pbound_s, pbound_by), "pnpoly/kernel.py:122"),
                ("conv2d", cfull, cpath, cops.DEFAULT_CONFIG,
                 lambda: ckernel.conv2d_plain(xcf["image"], xcf["filt"],
                                              **cops.DEFAULT_CONFIG),
                 # cuDNN, with TF32 off (set above): the f32 products, by
                 # the fastest algorithm its benchmark mode finds in the
                 # warm-up
                 lambda: F.conv2d(xcf["image"][None, None],
                                  xcf["filt"][None, None]),
                 (cbound_s, cbound_by), "conv2d/kernel.py:86"),
                ("hotspot", hfull, hpath, hops.DEFAULT_CONFIG,
                 lambda: hkernel.hotspot_plain(xhf["temp"], xhf["power"],
                                               xhf["n_sweeps"],
                                               **hops.DEFAULT_CONFIG),
                 None, (hbound_s, hbound_by), "hotspot/kernel.py:70"),
                ("expdist", efull, epath, eops.DEFAULT_CONFIG,
                 lambda: ekernel.expdist_plain(xef["a"], xef["b"], xef["sa"],
                                               xef["sb"],
                                               **eops.DEFAULT_CONFIG),
                 None, (ebound_s, ebound_by), "expdist/kernel.py:71"),
                ("dedisp", dfull, dpath, dops.DEFAULT_CONFIG,
                 lambda: dkernel.dedisp_plain(xdf["x"], xdf["delays"],
                                              xdf["t_out"],
                                              **dops.DEFAULT_CONFIG),
                 None, (dbound_s, dbound_by), "dedisp/kernel.py:73")):
            dflt = prob.evaluate(dcfg)
            default_s[name] = dflt.objective
            if not dflt.ok:
                raise SystemExit(f"chip_smoke: {name} default config "
                                 f"failed: {dflt.info}")
            plain_t = statistics.median(cuda_event_seconds(
                plain, repeats=3, warmup=1, flush=flush))
            lib_t = None if lib is None else statistics.median(
                cuda_event_seconds(lib, repeats=10, warmup=3, flush=flush))
            tuned = path["best"]
            kind = "exhaustive" if path["protocol"] == "exhaustive" \
                else "sampled"
            print(f"{name} tuned config {tuned.config}")
            print(f"  median {tuned.objective * 1e3:.4f} ms = "
                  f"{b_s / tuned.objective:.1%} of the {b_s * 1e3:.4f} ms "
                  f"bound ({b_by}); {path['protocol']} table's best "
                  f"{path['table_best_s'] * 1e3:.4f} ms")
            print(f"{name} default config {dflt.objective * 1e3:.4f} ms; "
                  f"plain version {plain_t * 1e3:.3f} ms; library_ms "
                  f"{'n/a' if lib_t is None else f'{lib_t * 1e3:.4f}'} ms")
            f32_lines.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": path["launches"],
                "device_launches": path["device_launches"],
                "max_abs_err": worst[name]["max_abs_err"],
                "ms": dflt.objective * 1e3, "plain_ms": plain_t * 1e3,
                "bound_ms": b_s * 1e3, "bound_by": b_by,
                "library_ms": None if lib_t is None else lib_t * 1e3,
                "rel_l2": worst[name]["rel_l2"],
                "mismatches": worst[name]["mismatches"],
                "shape": list(prob.shape.values()), "default_config": dcfg,
                "tuned_ms": tuned.objective * 1e3,
                "tuned_config": tuned.config,
                f"{kind}_best_ms": path["table_best_s"] * 1e3,
                "protocol": path["protocol"], "build_s": build_s})

        # conv2d: the SASS counts of the default and the tuned tile; the
        # tuned config with no column reuse (col_chunk 1), one row a thread
        # (row_chunk 1), the filter's other home, each unroll_fh (the code
        # size) and the other accumulator, each as the admitted config
        # nearest to it that keeps the change
        cbest = cpath["best"].config
        conv2d_sass_line("default", cops.DEFAULT_CONFIG)
        conv2d_sass_line("tuned", cbest)
        ckeep = ("row_chunk", "col_chunk", "unroll_fh", "unroll_fw",
                 "acc_dtype", "filter_smem")
        csplit = {}
        for change in ([{"col_chunk": 1}, {"row_chunk": 1},
                        {"filter_smem": 1 - cbest["filter_smem"]}]
                       + [{"unroll_fh": u}
                          for u in cfull.space.param("unroll_fh").values]
                       + [{"acc_dtype": {"f32": "bf16", "bf16": "f32"}[
                           cbest["acc_dtype"]]}]):
            cfg = fitting_config(cfull.space, dict(cbest, **change), ckeep)
            label = " ".join(f"{k}={v}" for k, v in change.items())
            if cfg is None:
                print(f"  conv2d tuned with {label}: none admitted")
                continue
            t_s = cfull.evaluate(cfg).objective
            key = (cf, ckernel.snap_unroll(cfg["unroll_fh"], cf),
                   cfg["acc_dtype"], cfg["row_chunk"], cfg["col_chunk"],
                   ckernel.snap_unroll(cfg["unroll_fw"], cf),
                   cfg["filter_smem"])
            csplit[label] = {"ms": t_s * 1e3, "config": cfg,
                             "code_bytes": csass[key]["bytes"],
                             "loads_per_fma": ckernel.loads_per_fma(cfg, cf)}
            moved = {k: v for k, v in cfg.items()
                     if v != cbest[k] and k not in change}
            print(f"  conv2d tuned with {label}{f' {moved}' if moved else ''}"
                  f": {t_s * 1e3:.4f} ms = {cbound_s / t_s:.1%} of the "
                  f"bound; {csass[key]['bytes']} B of code, "
                  f"{ckernel.loads_per_fma(cfg, cf):.4f} shared words an FMA")
        record["conv2d_splits"] = csplit
        # the earlier design's cliff in this one: each of its 27 configs as the
        # admitted config nearest to it with one column a thread, its time
        # in the exhaustive table; and the table's worst over its median
        ctable = {tuple(sorted(c.items())): o for c, o in zip(
            cpath["configs"], cpath["land"]["table"].objectives)}
        cobjs = sorted(ctable.values())
        cmed = statistics.median(cobjs)
        cliff = {}
        for acc, rc, bh, bw in CONV2D_CLIFF:
            old = {"block_h": bh, "block_w": bw, "row_chunk": rc,
                   "col_chunk": 1, "unroll_fh": 1, "unroll_fw": 15,
                   "acc_dtype": acc, "filter_smem": 0}
            near = fitting_config(cfull.space, old, ckeep)
            cliff[f"{acc} rc{rc} {bh}x{bw}"] = {
                "config": near, "ms": ctable[tuple(sorted(near.items()))]
                * 1e3}
        cliff_ms = [v["ms"] for v in cliff.values()]
        distinct = len({str(v["config"]) for v in cliff.values()})
        print(f"  conv2d: the 27 cliff configs of the earlier design, nearest "
              f"admitted with col_chunk 1 ({distinct} distinct): "
              f"{min(cliff_ms):.4f}..{max(cliff_ms):.4f} ms, median "
              f"{statistics.median(cliff_ms):.4f} (13.2..13.7 in the earlier "
              f"design); the table's median {cmed * 1e3:.4f} ms, worst "
              f"{cobjs[-1] * 1e3:.4f} ms = {cobjs[-1] / cmed:.2f}x the median")
        record["conv2d_cliff"] = {"configs": cliff, "median_ms": cmed * 1e3,
                                  "worst_ms": cobjs[-1] * 1e3}

        # hotspot's tuned tile at tt 1, 4 and 10 and power_smem 0 and 1:
        # small tt pays device memory (each launch re-reads the domain),
        # large tt halo work; power_smem 0 reads power through L1 at every
        # sweep, 1 holds it in registers
        hbest = hpath["best"].config
        hsplit = {}
        for tt in (1, 4, 10):
            for ps in (0, 1):
                cfg = dict(hbest, tt=tt, power_smem=ps)
                if tt % cfg["unroll_t"]:
                    cfg["unroll_t"] = 1
                label = f"tt={tt} power_smem={ps}"
                if not admits(hfull.space, cfg):
                    print(f"  hotspot tuned tile with {label}: not admitted "
                          f"{cfg}")
                    continue
                t_s = hfull.evaluate(cfg).objective
                hsplit[label] = t_s * 1e3
                print(f"  hotspot tuned tile with {label}: "
                      f"{t_s * 1e3:.4f} ms = {hbound_s / t_s:.1%} of the "
                      f"bound ({-(-hn // tt)} launches)")
        record["hotspot_sweep_ms"] = hsplit
        # dedisp's tuned config on the three tables: what the reads a
        # distinct delay saves
        dbest = dpath["best"].config
        dsplit = {}
        for tname, table in dedisp_tables(xdf["delays"], dt_in - dto).items():
            t_s = statistics.median(cuda_event_seconds(
                lambda: dops.dedisp(xdf["x"], table, dto, dbest),
                repeats=5, warmup=2, flush=flush))
            reads = dkernel.reads_per_add(table.cpu().numpy(),
                                          dbest["unroll_d"])
            dsplit[tname] = {"ms": t_s * 1e3, "reads_per_add": reads}
            print(f"  dedisp tuned config on the {tname} delay table: "
                  f"{t_s * 1e3:.4f} ms, {reads:.4f} window reads a "
                  f"sample-add")
        record["dedisp_tables_ms"] = dsplit

    with phase("costmodel"):
        record["costmodel"] = model_check(
            {"gemm": (full, None), "flash_attention": (ffull, apath),
             "nbody": (nfull, npath), "pnpoly": (pfull, ppath),
             "conv2d": (cfull, cpath), "hotspot": (hfull, hpath),
             "expdist": (efull, epath), "dedisp": (dfull, dpath)},
            gemm_trials,
            {"gemm": ops.DEFAULT_CONFIG,
             "flash_attention": fops.DEFAULT_CONFIG,
             "nbody": nops.DEFAULT_CONFIG, "pnpoly": pops.DEFAULT_CONFIG,
             "conv2d": cops.DEFAULT_CONFIG, "hotspot": hops.DEFAULT_CONFIG,
             "expdist": eops.DEFAULT_CONFIG, "dedisp": dops.DEFAULT_CONFIG},
            default_s, failures)

    lines = [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm.cu",
         "replaces": "src/repro/kernels/matmul/kernel.py:71",
         "launches": launches, "device_launches": gemm_issued,
         "max_abs_err": worst["gemm"]["max_abs_err"],
         "ms": default.objective * 1e3, "plain_ms": plain_s * 1e3,
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": lib_s * 1e3,
         "rel_l2": worst["gemm"]["rel_l2"], "shape": [m, n, k],
         "default_config": ops.DEFAULT_CONFIG,
         "tuned_ms": t_best * 1e3, "tuned_config": best.config,
         "build_s": build_s},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:93",
         "launches": alaunches, "device_launches": aissued,
         "max_abs_err": worst["flash_attention"]["max_abs_err"],
         "ms": adefault.objective * 1e3, "plain_ms": aplain_s * 1e3,
         "bound_ms": abound_s * 1e3, "bound_by": abound_by,
         "library_ms": None if alib_s is None else alib_s * 1e3,
         "rel_l2": worst["flash_attention"]["rel_l2"],
         "shape": [hq, hkv, tq, tk, d],
         "default_config": fops.DEFAULT_CONFIG,
         "tuned_ms": at_best * 1e3, "tuned_config": abest.config,
         "exhaustive_best_ms": table_best_s * 1e3, "build_s": build_s},
    ] + f32_lines
    record["kernels"] = lines
    record["speedup_over_median"] = res["speedup"]
    record["failures"] = failures
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1, default=str))

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
