#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py [--budget N] [--samples S] [--json PATH]
    python3 chip_smoke.py --start-probe T     # one start probe, see phase 8

Phases, each timed:

1. probe     — the card must be sm_90 (Hopper); prints ``nvidia-smi``'s name
               and power limit.
2. build     — builds every kernel of the port from ``src/repro_torch/csrc``
               with nvcc, all sources and variants at once (conv2d's, the
               longest, go on while phase 3 holds the other kernels, and
               its checks and parity come last there), and checks that
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
               space (attention, pnpoly, conv2d) or, for the three
               sampled problems, ``--samples`` distinct random configs
               (default 400; hotspot at most ``HOTSPOT_SAMPLES``; dedisp's
               space, 336 configs at its shape, is measured whole), and
               prints the paper's five landscape results on the table;
               nbody, which ``landscape.main`` measures whole, is cut in
               depth to ``NBODY_SAMPLES`` random configs by the same
               sampled protocol (:func:`sampled_landscape`).
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
               whole (GEMM, nbody, hotspot, expdist), rho on ``HOLDOUT`` configs
               measured now that no path of the run measured, drawn with
               a seed of their own from outside the fit set; then Fig 5, the portability matrix
               over (h100, h100sxm, h100pcie), for the four problems
               measured whole.  A config the model cannot run, or a pick
               that fails, fails the run.
8. orchestrator — the session layer, each step a run of its entry point
               ``python -m repro_torch.orchestrator`` with one temporary
               store (kept for phase 10) and ``--trace``
               (``orchestrator_check``): a GEMM random
               search (seed 0, budget 60, 4 workers asked) stopped at the
               first batch boundary past 30 and resumed (interrupted, then
               done; a journal line a trial; the resumed run measures only
               what the journal lacks; one measuring process on the one
               card; the configs the ``main`` phase's random search asked,
               in order, and their medians within 5 % of that phase's);
               flash attention's 72 admitted configs by grid search across
               two calls (a published table of all 72, none invalid, its
               best within 3 % of the landscape's); a campaign of random
               search and GA over ``h100``, ``h100sxm`` and ``h100pcie``
               (six sessions done, measured trials only under ``h100``,
               each row they asked measured once).  Its kernel launches
               happen in the measuring processes, whose spans carry them
               back (``orchestrator_launches`` in the ``kernels`` line).
               A CLI call that measures starts its measuring process
               before it imports torch itself, and the pool adopts it
               (``workers.start_early``: each call's "adopted" line).
               Then one measuring process's start, split by the start probe
               (``--start-probe``, :func:`start_probe`): interpreter,
               ``import torch``, the kernel modules, the CUDA context, the
               problem's inputs at 4096^3, the first config, the exit.
9. tuners    — the five tuners the port took last (local search, simulated
               annealing, differential evolution, particle swarm and
               surrogate BO), each run live in this process over
               ``gemm_h100`` at 4096^3 (seed 0, budget 40): 40 trials, none
               invalid, GEMM's launches up by exactly 7 a config, the
               winner against the oracle and the plain version, and a
               replay over the recorded objectives asking the same rows in
               the same order; then all eight tuners over the whole
               conv2d and pnpoly tables the path phases measured
               (``landscape.compare_tuners``: budget 200, seeds 0-4;
               surrogate BO 128, seeds 0-2), nothing timed again:
               evaluations to 90 % and 99 % of the table's best and the
               share reached at the budget (``tuners_launches`` in GEMM's
               line of the ``kernels`` line).
10. servedb  — the serving layer and the surrogate over this run's own
               tables (``servedb_check``, no new landscape): ``servedb
               build`` and ``servedb verify`` over phase 8's store (entries
               per kernel and arch); lookups under ``h100``: GEMM at
               4096^3 (exact, the session's best), at 2048^3 (nearest),
               attention at its shape (exact, its sessions' best), conv2d
               (no session: the cost model's pick, the lookup launching
               nothing) and an unknown name (``{}``), each answer the
               space admits at its shape launched there and held against
               its plain version (the exact GEMM answer's median within 5 %
               of the session's); the surrogate on conv2d (its measured
               table beside the cost model's whole tables under h100sxm
               and h100pcie: fitted with h100 held out, Spearman's rho and
               the measured best of its top 8 as a share of the table's
               best; refitted on all rows into a model store that
               verifies); a screened GEMM session (genetic, seed 0, budget
               40, a quarter measured; its model on GEMM's cost-model
               tables and phase 4's measured trials): GEMM's launches up
               by exactly 7 a measured trial and none an estimated one, its
               harvest taking no estimated row; and ``submit --warm-start
               M --warm-top 8 --budget 16``, whose first 8 journal rows are
               the model's top 8 (``servedb_launches``,
               ``screen_launches`` and ``warm_start_launches`` in the
               ``kernels`` line).
11. lm       — the LM stack's serving path (``lm_check``): qwen3-8b at full
               width and depth (36 layers, d 4096, 32/8 heads of 128,
               vocab 151 936; random weights made on the card from seed 0)
               served by ``ServingEngine`` (4 slots, 4096 positions,
               greedy), planned from phase 10's find-DB (tier exact: the
               model's attention shape is the flash problem's default);
               six requests of 512, 1024, 2048, 3968, 100 and 777 tokens,
               32 new tokens each.  Every kernel's count is set to 0 just
               before and read just after: attention exactly 36 x 4 (the
               four prompts its space admits), nothing else, the plain
               route 36 x 2.  Then the 2048-token prompt's last logits by
               the kernel route against the plain one (``LM_TOL``).
               Prints parameter and KV-cache GiB, the peak allocation,
               init seconds, each prefill's milliseconds and route, the
               median decode step and tokens/s (``lm_launches`` in
               attention's line of the ``kernels`` line).
12. train    — the training path (``train_check``): qwen3-8b at its
               published widths cut to 8 of 36 layers (2.166 B
               parameters; remat on), 4 steps of ``make_train_step`` over
               4 sequences of 4096 tokens in 4 microbatches, from the
               synthetic pipeline, with ``OptimizerConfig(total_steps=4,
               warmup_steps=1)``.  Every kernel's count is set to 0 just
               before the steps and read just after: nothing may launch
               (training attention runs the plain route: the kernel has
               no backward), the plain route 8 x 4 x 2 a step (forward and
               remat's recompute).  Losses and grad norms finite, the
               first nll not below ln(151 936) - 1 and the last 1 nat
               below the first (``TRAIN_DROP``), the master weights
               moved; each step's loss, nll, grad norm, lr and ms, the
               median step's tokens/s against the step's FLOP bound
               (``train_bound``), parameter / optimizer-state / peak GiB,
               a step split into data, forward, backward with recompute
               and the optimizer; one block's gradients with remat
               against those without (``REMAT_TOL``).  Then the
               launcher's drill at the reduced config
               (``python -m repro_torch.launch.train --reduced``: a run
               sent SIGTERM after step 6 checkpoints and exits 0, its
               rerun resumes and matches an uninterrupted run at step 16,
               ``DRILL_TOL``), and the reduced step on the card against
               the CPU (``CARD_LOSS_TOL``, ``CARD_GRAD_TOL``)
               (``train_launches`` in attention's line).
13. dist     — distribution, the roofline and the dry run (``dist_check``):
               on a one-rank NCCL mesh (``launch.mesh.make_host_mesh``;
               a failed init fails the run), (a) one train step of
               qwen3-8b at its published widths cut to 2 layers over one
               4096-token sequence with its parameters placed by
               ``param_shardings``, against the same step unsharded (loss
               1e-3, grads and updated masters 5e-2 rel-L2, phase 12's
               bounds; nothing launched), (b) a prefill at 4 layers of a
               2048-token prompt whose attention runs the flash kernel on
               each rank's local shards (exactly 4 launches, logits within
               ``LM_TOL`` of the unsharded model's), and the same prefill
               under the ``--opt`` plan (``optimize_config``) followed by
               two decode steps whose cache rows the scatter route writes
               through a local region (exactly 4 launches again; each
               step's logits within ``LM_TOL`` of the unsharded plain
               model's); (c) the roofline of
               phase 12's exact step traced on fake tensors: its three
               terms, bound, useful-FLOPs ratio and phase 12's measured
               median step over the ideal overlapped time, beside phase
               12's hand-reckoned bound; (d) ``python -m
               repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
               --layers 2`` on its fake 16 x 16 process group, and beside
               it, at one layer, deepseek-coder-33b's ``train_4k --opt``,
               deepseek-v2-236b's ``train_4k`` and ``decode_32k``,
               qwen3-8b's ``decode_32k --opt``, rwkv6-1.6b's ``long_500k
               --multi-pod`` and ``prefill_32k`` (its recurrence traced a
               chunk for all), all seven ``--audit`` at once, each JSON
               read back (terms, all-reduce bytes, mfu, peak GiB per chip,
               seconds; none may hold a collective DTensor issued on its
               own); they need no card,
               so main starts them before phase 5's nbody path, whose
               host waits on the card, and this phase collects them
               (``start_dry_runs``)
               (``dist_launches`` and ``dist_opt_launches`` in
               attention's line).
14. families — the nine other model families (``families_check``,
               ``FAMILIES``), each at its published widths, cut in depth
               only: (a) served by ``ServingEngine`` (4 slots, 8 new
               tokens a request) at granite-moe-3b-a800m 32 layers,
               deepseek-v2-236b 2, deepseek-coder-33b, qwen3-14b and
               internvl2-26b 4, gemma3-27b 6, recurrentgemma-9b 3,
               rwkv6-1.6b 4 and whisper-medium 24 + 24, each family's
               counts set to 0 just before and read just after: the flash
               kernel once a layer for each prompt it takes (512 and 2048
               tokens at GQA groups 3, 7, 5, 6 and 1), nothing else, the
               plain route as ``attention_routes`` says; the 2048-token
               prompt's logits by both routes within ``LM_TOL``; and
               internvl2's vision prefix (256 patches, 1792 tokens) by
               ``Model.forward(make_cache=True)`` on the kernel; (b) one
               ``make_train_step`` of one 2048-position sequence with remat
               (whisper's frames, internvl2's patches) at 8, 2, 2, 2, 1, 3,
               4 and 24 + 24 layers (deepseek-v2-236b none: one layer's
               state is 67 GiB): no launch, loss and grad norm finite, the
               first nll not below ln V - 1; (d) every arch's reduced
               config, a prefill, two decode steps fed the host's greedy
               tokens and a train step, card against host on the same
               weights and inputs, in f32 (``torch.bfloat16`` aliased in a
               process of its own; the host's runs started beside the dry
               runs) within ``REDUCED_F32_TOL`` and in bf16 within
               ``ROUND_FACTOR`` x the host's bf16-to-f32 distance +
               ``ROUND_TOL`` (``families_launches`` in attention's line).

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
import atexit
import collections
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

#: when this process began running the script (its interpreter and the
#: standard modules above are up): the start probe's first stamp
STARTED = time.time()
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
#: design's configs cost about 0.21 s each to measure (seven calls of 8 to
#: 70 ms); 400 of them took 84 s, and the whole script 1085 s of its 1200 s
#: limit, too near it (PERF.md section 5); 150 left the script at 911 s on
#: the slowest host seen, still past two thirds of the limit, so the path
#: takes 64
HOTSPOT_SAMPLES = 64
#: configs of nbody's 960 the nbody path's table takes: each costs about
#: 0.22 s to measure at 131 072 bodies, and the whole space took 209 s of
#: the script's 1085 s; a sixth of it (160) still left the script at 911 s
#: on the slowest host seen, so the path samples 64
NBODY_SAMPLES = 64
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
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout


def sass_of(libs: dict) -> dict:
    """``cuobjdump_sass`` of each library of ``libs`` (variant -> path),
    the dumps run at once, one thread each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return dict(zip(libs, pool.map(cuobjdump_sass, libs.values())))


def sass_check(name: str, built, failures: list[str]) -> dict:
    """Count a tensor-core kernel's libraries' tensor-core and TMA
    instructions in their SASS (``cuobjdump``): each must issue wgmma
    (HGMMA) and TMA loads (UTMALDG), and none the older mma.sync (HMMA).
    Also print what ptxas said about wgmma or setmaxnreg in each build
    log."""
    out = {}
    dumps = sass_of(built.libs)
    for variant, lib in built.libs.items():
        sass = dumps[variant]
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


def sass_functions(sass: str) -> dict[str, list[str]]:
    """Each function of a library's SASS (``cuobjdump_sass``'s text): its
    mangled name and its instructions' opcodes, in order."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
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
    dumps = sass_of(built.libs)
    for variant in built.libs:
        f, u, acc = variant[1:].split("_")[:3]
        for name, ops_ in sass_functions(dumps[variant]).items():
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
    :func:`holdout_rows` measured now; then Fig 5 over (h100, h100sxm,
    h100pcie) for the four problems measured whole.  What fails goes to ``failures``."""
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
    for name in ("flash_attention", "pnpoly", "conv2d", "dedisp"):
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


def sampled_landscape(problem: str, samples: int) -> dict:
    """``landscape.main``'s sampled protocol on a problem it measures whole,
    for a path cut in depth: ``samples`` distinct random configs (seed 0)
    of the admitted space timed on the card, published as a
    ``sampled:N:0`` table, and the paper's five results on it (Fig 5,
    which needs the whole table, is left out).  Returns what
    ``landscape.main`` returns."""
    from repro_torch import landscape
    from repro_torch.core.results import ResultTable
    from repro_torch.kernels import BENCHMARKS
    prob = BENCHMARKS[problem](device="cuda")
    n = prob.space.compiled().n_valid
    print(f"problem: {prob.name} {prob.shape} on {prob.device} (arch "
          f"{prob.arch}, measured)  |space| = {prob.space.cardinality:,}, "
          f"{n} admitted; cut in depth to {samples}")
    t0 = time.perf_counter()
    trials = prob.sampled(samples, seed=0, arch=prob.arch)
    seconds = time.perf_counter() - t0
    protocol = f"sampled:{samples}:0"
    invalid = sum(not t.ok for t in trials)
    table = ResultTable.from_trials(prob, prob.arch, trials, protocol)
    print(f"measured {len(trials)} configs ({protocol}) in {seconds:.2f} s; "
          f"{invalid} invalid")
    t0 = time.perf_counter()
    out = landscape.analyse(prob, table, trials)
    analyse_s = time.perf_counter() - t0
    print(f"Fig 4  speedup of the best config over the median: "
          f"{out['speedup']:.3f}x (best {table.best()[1] * 1e3:.4f} ms, "
          f"{out['best_config']}); Fig 2 90 % after {out['n90']}, 99 % "
          f"after {out['n99']}; Fig 3 {out['centrality']:.4f}; Fig 6 PFI "
          f"(R^2 {out['r2']:.3f}) " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["pfi"].items())
          + f"; analyses took {analyse_s:.2f} s")
    out.update(problem=prob, table=table, trials=trials, invalid=invalid,
               seconds=seconds, analyse_seconds=analyse_s, arch=prob.arch,
               portability=None)
    return out


def orchestrator_cli(*argv) -> tuple[str, float]:
    """Run ``python -m repro_torch.orchestrator *argv`` to its end: its
    standard output and its seconds; any exit but 0 ends the run."""
    return finish_cli(start_cli(*argv), argv)


def start_cli(*argv) -> tuple[subprocess.Popen, float]:
    """Start ``python -m repro_torch.orchestrator *argv`` with the
    checkout's ``src`` on the path; :func:`finish_cli` waits for it."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.orchestrator", *argv], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return p, time.perf_counter()


def finish_cli(started: tuple[subprocess.Popen, float],
               argv) -> tuple[str, float]:
    p, t0 = started
    try:
        out, err = p.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise SystemExit(f"chip_smoke: orchestrator {' '.join(argv)} "
                         f"timed out")
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        raise SystemExit(f"chip_smoke: orchestrator {' '.join(argv)} "
                         f"exited {p.returncode}:\n{out[-3000:]}\n"
                         f"{err[-6000:]}")
    for line in err.splitlines():
        if line.startswith("worker pool:"):
            print(f"  {argv[0]}: {line}")
    return out, dt


def trace_spans(path: Path) -> list[dict]:
    """The spans of a ``--trace`` JSONL file."""
    return [r for r in map(json.loads, path.read_text().splitlines())
            if "name" in r]


def span_launches(sp: list[dict]) -> dict[str, int]:
    """Kernel launches the measuring processes report in their pool spans
    (``pool.chunk``/``pool.retry``), by kernel."""
    tot: dict[str, int] = {}
    for r in sp:
        if r["name"] in ("pool.chunk", "pool.retry"):
            for k, n in r.get("args", {}).get("launches", {}).items():
                tot[k] = tot.get(k, 0) + n
    return tot


def journal_records(store: Path, sid: str) -> list[dict]:
    lines = (store / sid / "trials.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines if line.strip()]


def session_id(text: str) -> str:
    """The id a ``submit`` printed."""
    return next(line.split()[1] for line in text.splitlines()
                if line.startswith("session "))


def orchestrator_check(gemm, attention, gemm_random,
                       attention_best_s: float, budget: int,
                       failures: list[str], tmp: Path) -> dict:
    """The session layer on the card, each step through the real entry
    point, ``python -m repro_torch.orchestrator``, with one store under
    ``tmp`` that the ``servedb`` phase distills afterwards:

    1. a GEMM random search at 4096^3 stopped at the first batch boundary
       past half its budget and resumed: interrupted then done, one
       journal line a trial, the resumed process measuring only the
       configs the journal lacked, one measuring process on the one card,
       the configs in the order the ``main`` phase's random search (same
       seed) asked them and their medians beside that phase's;
    2. flash attention's whole space by grid search across two calls: the
       published table holds every admitted config, none invalid, and its
       best lies near the ``attention`` phase's landscape best;
    3. a campaign over the card's id and the cost model's two: measured
       trials only in the ``h100`` sessions, none in the model's, and each
       row the ``h100`` sessions asked measured once.

    ``gemm`` and ``attention`` are the full-shape problems the earlier
    phases built, with the CLI's defaults: each measured config launches
    its kernel ``warmup + repeats`` times.  Returns what it measured, with
    the store (``store``) and its sessions (``sessions``: the GEMM
    session, the attention grid, the campaign's six); kernel launches are
    read from the measuring processes' spans (``pool.chunk``/
    ``pool.retry``), which the trace carries back."""
    out: dict = {"steps": {}}
    gemm_space, attention_space = gemm.space, attention.space
    g_per = gemm.warmup + gemm.repeats
    a_per = attention.warmup + attention.repeats

    def measured(sp: list[dict]) -> list[dict]:
        return [r for r in sp if r["name"] == "kernel.measure"]

    def kernel_s(sp: list[dict]) -> float:
        """Seconds the measuring processes spent building and timing
        configs; the rest of a call is process start and set-up."""
        return sum(r["dur"] for r in sp
                   if r["name"] in ("kernel.build", "kernel.measure")) / 1e6

    def status(store: Path) -> dict[str, dict]:
        text, _ = orchestrator_cli("status", "--store", str(store), "--json")
        return {r["session"]: r for r in map(json.loads, text.splitlines())}

    store = tmp / "store"
    # 1. GEMM: stopped, resumed
    b1 = min(60, budget)
    t0 = time.perf_counter()
    text, s_a = orchestrator_cli(
        "submit", "--problem", "gemm_h100", "--tuner", "random", "--seed",
        "0", "--budget", str(b1), "--workers", "4", "--stop-after",
        str(b1 // 2), "--store", str(store), "--trace", str(tmp / "t1.jsonl"))
    sid = session_id(text)
    st1 = status(store)[sid]
    n1 = len(journal_records(store, sid))
    text, s_b = orchestrator_cli("resume", sid, "--store", str(store),
                                 "--trace", str(tmp / "t2.jsonl"))
    st2 = status(store)[sid]
    recs = journal_records(store, sid)
    step1_s = time.perf_counter() - t0
    sp1, sp2 = trace_spans(tmp / "t1.jsonl"), trace_spans(tmp / "t2.jsonl")
    m1, m2 = measured(sp1), measured(sp2)
    pids = [{r["args"]["pid"] for r in m} for m in (m1, m2)]
    devices = {r.get("i", {}).get("device") for r in recs}
    cfgs = [gemm_space.from_flat_index(r["k"]) for r in recs]
    main_cfgs = [t.config for t in gemm_random[:b1]]
    main_s = {json.dumps(t.config, sort_keys=True): t.objective
              for t in gemm_random}
    devs = [abs(r["o"] / main_s[key] - 1.0) for r, c in zip(recs, cfgs)
            if (key := json.dumps(c, sort_keys=True)) in main_s] or [1.0]
    per_cfg_ms = (s_a + s_b) / b1 * 1e3
    g_launch = span_launches(sp1 + sp2)
    print(f"  gemm session {sid}: {st1['status']} "
          f"{st1['evaluated']}/{st1['budget']} ({n1} journal lines), "
          f"then {st2['status']} {st2['evaluated']}/{st2['budget']} "
          f"({len(recs)} lines); configs measured {len(m1)} + {len(m2)}"
          f"; measuring pids {[sorted(p) for p in pids]}, devices "
          f"{sorted(devices, key=str)}; gemm launches {g_launch}")
    k_s = kernel_s(sp1) + kernel_s(sp2)
    print(f"  gemm session medians against the main phase's: median "
          f"|ratio - 1| {statistics.median(devs):.4f}, max "
          f"{max(devs):.4f}; submit {s_a:.1f} s + resume {s_b:.1f} s "
          f"= {per_cfg_ms:.1f} ms of host time a measured config, "
          f"spawns included, of which {k_s:.2f} s building and timing "
          f"configs")
    checks = [
        (st1["status"] == "interrupted"
         and b1 // 2 <= st1["evaluated"] < b1 and n1 == st1["evaluated"],
         f"stopped session: {st1}, {n1} journal lines"),
        (st2["status"] == "done" and st2["evaluated"] == b1
         and len(recs) == b1, f"resumed session: {st2}, "
         f"{len(recs)} journal lines"),
        (len(m1) == st1["evaluated"] and len(m2) == b1 - st1["evaluated"],
         f"configs measured {len(m1)} + {len(m2)}, journal "
         f"{st1['evaluated']} + {b1 - st1['evaluated']}"),
        (all(len(p) == 1 for p in pids) and devices == {0},
         f"measuring processes {pids}, devices {devices}"),
        (cfgs == main_cfgs, "the session's configs are not the main "
         "phase's random search's"),
        (statistics.median(devs) <= 0.05,
         f"session medians off the main phase's by "
         f"{statistics.median(devs):.4f} (median) > 0.05"),
        (g_launch == {"gemm": b1 * g_per},
         f"gemm launches {g_launch}, not {b1} configs x {g_per}")]
    failures.extend(f"orchestrator step 1: {msg}"
                    for ok, msg in checks if not ok)
    out["steps"]["gemm_session"] = {
        "seconds": step1_s, "submit_s": s_a, "resume_s": s_b,
        "stopped_at": st1["evaluated"], "measured": [len(m1), len(m2)],
        "median_dev": statistics.median(devs), "max_dev": max(devs),
        "host_ms_per_config": per_cfg_ms, "kernel_s": k_s,
        "launches": g_launch}

    # 2. attention's whole space across two calls
    n_valid = len(attention_space.compiled().valid_rows)
    t0 = time.perf_counter()
    text, _ = orchestrator_cli(
        "submit", "--problem", "flash_attention_h100", "--tuner", "grid",
        "--budget", str(n_valid), "--stop-after", str(n_valid // 2),
        "--store", str(store), "--trace", str(tmp / "t3.jsonl"))
    sid2 = session_id(text)
    st3 = status(store)[sid2]
    orchestrator_cli("resume", sid2, "--store", str(store), "--trace",
                     str(tmp / "t4.jsonl"))
    step2_s = time.perf_counter() - t0
    from repro_torch.core.results import ResultsDB
    table = ResultsDB(store / "tables").get(
        "flash_attention_h100", "h100", f"session_{sid2}")
    import math
    finite = [o for o in table.objectives if math.isfinite(o)]
    t_best = min(finite) if finite else math.inf
    sp34 = trace_spans(tmp / "t3.jsonl") + trace_spans(tmp / "t4.jsonl")
    a_launch = span_launches(sp34)
    print(f"  attention grid {sid2}: stopped at {st3['evaluated']}, "
          f"table {len(table.configs)} rows ({len(set(table.configs))} "
          f"distinct, {len(finite)} valid of {n_valid} admitted), best "
          f"{t_best * 1e3:.4f} ms against the landscape's "
          f"{attention_best_s * 1e3:.4f} ms; {step2_s:.1f} s, of which "
          f"{kernel_s(sp34):.2f} s building and timing configs")
    checks = [
        (st3["status"] == "interrupted", f"attention stop: {st3}"),
        (len(table.configs) == n_valid == len(set(table.configs))
         == len(finite), f"attention table: {len(table.configs)} rows, "
         f"{len(finite)} valid, {n_valid} admitted"),
        (abs(t_best / attention_best_s - 1.0) <= 0.03,
         f"attention table best {t_best * 1e3:.4f} ms against the "
         f"landscape's {attention_best_s * 1e3:.4f} ms"),
        (a_launch == {"flash_attention": n_valid * a_per},
         f"attention launches {a_launch}, not {n_valid} configs x "
         f"{a_per}")]
    failures.extend(f"orchestrator step 2: {msg}"
                    for ok, msg in checks if not ok)
    out["steps"]["attention_grid"] = {
        "seconds": step2_s, "stopped_at": st3["evaluated"],
        "rows": len(table.configs), "valid": len(finite),
        "best_ms": t_best * 1e3,
        "landscape_best_ms": attention_best_s * 1e3,
        "kernel_s": kernel_s(sp34), "launches": a_launch}

    # 3. a campaign over the card's id and the cost model's
    t0 = time.perf_counter()
    orchestrator_cli(
        "campaign", "--problems", "flash_attention_h100", "--tuners",
        "random,genetic", "--archs", "h100,h100sxm,h100pcie", "--seeds", "0",
        "--budget", "40", "--workers", "1", "--store", str(store), "--trace",
        str(tmp / "t5.jsonl"))
    step3_s = time.perf_counter() - t0
    sts = {k: v for k, v in status(store).items() if k not in (sid, sid2)}
    sp5 = trace_spans(tmp / "t5.jsonl")
    c_launch = span_launches(sp5)
    asked: set[int] = set()
    bad: list[str] = []
    for s, row in sts.items():
        spec_arch = json.loads((store / s / "meta.json").read_text()
                               )["spec"]["arch"]
        recs = journal_records(store, s)
        with_info = [r for r in recs
                     if {"median_s", "repeats"} <= set(r.get("i", {}))]
        if spec_arch == "h100":
            asked |= {r["k"] for r in recs}
            if len(with_info) != len(recs):
                bad.append(f"{s}: {len(recs) - len(with_info)} trials "
                           f"without measured info")
        elif with_info:
            bad.append(f"{s}: {len(with_info)} model trials carry "
                       f"measured info")
    n_meas = len(measured(sp5))
    print(f"  campaign: {len(sts)} sessions "
          f"{sorted(r['status'] for r in sts.values())}; "
          f"{n_meas} configs measured for {len(asked)} distinct rows "
          f"the h100 sessions asked; {step3_s:.1f} s, of which "
          f"{kernel_s(sp5):.2f} s building and timing configs; launches "
          f"{c_launch}")
    checks = [
        (len(sts) == 6 and all(r["status"] == "done"
                               for r in sts.values()),
         f"campaign sessions {[(s, r['status']) for s, r in sts.items()]}"),
        (not bad, "; ".join(bad)),
        (n_meas == len(asked), f"campaign measured {n_meas} configs for "
         f"{len(asked)} distinct h100 rows"),
        (c_launch == {"flash_attention": len(asked) * a_per},
         f"campaign launches {c_launch}, not {len(asked)} rows x "
         f"{a_per}")]
    failures.extend(f"orchestrator step 3: {msg}"
                    for ok, msg in checks if not ok)
    out["steps"]["campaign"] = {
        "seconds": step3_s, "sessions": len(sts), "measured": n_meas,
        "distinct_h100_rows": len(asked), "kernel_s": kernel_s(sp5),
        "launches": c_launch}
    out["launches"] = {k: g_launch.get(k, 0) + a_launch.get(k, 0)
                       + c_launch.get(k, 0)
                       for k in set(g_launch) | set(a_launch) | set(c_launch)}
    out["store"] = str(store)
    out["sessions"] = {"gemm": sid, "attention_grid": sid2,
                       "campaign": sorted(sts)}
    return out


#: the tuners phase: the five tuners that came to the port with the
#: warm-start seam, each run live over GEMM at its full shape with this
#: budget and seed
LIVE_TUNERS = ("local", "annealing", "diffevo", "pso", "surrogate_bo")
LIVE_BUDGET, LIVE_SEED = 40, 0


def start_probe(spawned: float) -> dict:
    """What a measuring process does before it times its first config,
    stamped (``time.time()``): run as ``chip_smoke.py --start-probe T`` by
    :func:`start_split`, where ``T`` is when the parent started it.  The
    steps are those of a GEMM measuring process of the worker pool
    (``orchestrator/workers.py``): ``import torch``; the problem's modules
    (unpickling a ``GemmProblem`` imports its kernel package); the CUDA
    context (the pool's initializer pins the card); the problem and its
    inputs at 4096^3; the first config measured (the kernel's library
    loaded, the L2 flush buffer, 2 warm-ups and 5 repeats)."""
    stamps = {"spawned": spawned, "interpreter": STARTED}
    import torch
    stamps["import_torch"] = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.matmul import ops
    from repro_torch.kernels.matmul.space import GemmProblem
    stamps["import_kernels"] = time.time()
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    stamps["cuda_context"] = time.time()
    prob = GemmProblem(device="cuda")
    prob.make_runner(ops.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    stamps["problem_inputs"] = time.time()
    t = prob.evaluate(ops.DEFAULT_CONFIG)
    stamps["first_config"] = time.time()
    stamps["ok"] = t.ok
    stamps["modules"] = sorted(m for m in sys.modules
                               if m.startswith("repro_torch.kernels."))
    return stamps


def start_split() -> dict:
    """Start one :func:`start_probe` process and split its start into the
    seconds of each step, the exit (its last stamp to the parent seeing it
    end) and the whole."""
    spawned = time.time()
    p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--start-probe", repr(spawned)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    ended = time.time()
    if p.returncode != 0:
        raise SystemExit(f"chip_smoke: the start probe exited "
                         f"{p.returncode}:\n{p.stderr[-4000:]}")
    stamps = json.loads(p.stdout.strip().splitlines()[-1])
    steps = ("spawned", "interpreter", "import_torch", "import_kernels",
             "cuda_context", "problem_inputs", "first_config")
    split = {b: stamps[b] - stamps[a] for a, b in zip(steps, steps[1:])}
    split["exit"] = ended - stamps["first_config"]
    split["total"] = ended - spawned
    return {"seconds": split, "ok": stamps["ok"],
            "kernel_modules": stamps["modules"]}


def tuners_check(gemm, winner_check, tables: dict,
                 failures: list[str]) -> dict:
    """The tuners phase.

    (a) Live: each of ``LIVE_TUNERS`` runs ``run_tuner`` over ``gemm`` (the
    full-shape problem on the card) with ``LIVE_BUDGET`` and ``LIVE_SEED``,
    in this process: exactly ``LIVE_BUDGET`` trials, none invalid; GEMM's
    launch count up by exactly ``warmup + repeats`` a config measured; the
    winner through ``winner_check`` (the oracle and the plain version, as
    the ``main`` phase holds its own); and the same tuner and seed rerun
    over a ``FunctionProblem`` that answers the live run's recorded
    objectives asks the same rows in the same order.

    (b) The paper's comparison: every tuner over each whole table of
    ``tables`` (name -> (problem, table)), answered from the table
    (``landscape.compare_tuners``), no config timed again.

    Returns what it measured; ``launches`` is GEMM's count in (a)."""
    import math

    from repro_torch.core.problem import FunctionProblem
    from repro_torch.core.tuners import TUNERS, run_tuner
    from repro_torch.kernels.matmul import ops
    from repro_torch.landscape import compare_tuners, print_comparison
    sp = gemm.space
    per = gemm.warmup + gemm.repeats
    out: dict = {"live": {}, "compare": {}, "launches": 0}
    for name in LIVE_TUNERS:
        before = ops.gemm.launches
        t0 = time.perf_counter()
        res = run_tuner(TUNERS[name](sp, seed=LIVE_SEED), gemm, LIVE_BUDGET,
                        arch=gemm.arch)
        live_s = time.perf_counter() - t0
        launched = ops.gemm.launches - before
        out["launches"] += launched
        rows = [sp.flat_index(t.config) for t in res.trials]
        recorded = dict(zip(rows, (t.objective for t in res.trials)))
        replay = run_tuner(
            TUNERS[name](sp, seed=LIVE_SEED),
            FunctionProblem(sp, lambda c, a: recorded.get(sp.flat_index(c),
                                                          math.inf),
                            name=gemm.name), LIVE_BUDGET, arch=gemm.arch)
        same = [sp.flat_index(t.config) for t in replay.trials] == rows
        bad = [t.config for t in res.trials if not t.ok]
        best = res.best
        print(f"  {name:13s} {len(res.trials)} configs measured in "
              f"{live_s:.2f} s, {len(bad)} invalid, gemm launches "
              f"{launched}; best {best.objective * 1e3:.4f} ms "
              f"{best.config}; replay over the recorded objectives "
              f"{'asks the same rows' if same else 'DIFFERS'}")
        checks = [
            (len(res.trials) == LIVE_BUDGET and not bad,
             f"{len(res.trials)} trials, {len(bad)} invalid"),
            (launched == len(res.trials) * per,
             f"gemm launches {launched}, not {len(res.trials)} configs x "
             f"{per}"),
            (same, "the replay over the recorded objectives asked other "
             "rows")]
        failures.extend(f"tuners {name}: {msg}" for ok, msg in checks
                        if not ok)
        winner_check(best.config)
        out["live"][name] = {
            "seconds": live_s, "configs": len(res.trials),
            "invalid": len(bad), "launches": launched,
            "best_ms": best.objective * 1e3, "best_config": best.config,
            "replay_same": same,
            "trials": [{"config": t.config, "info": t.info}
                       for t in res.trials]}
    for name, (prob, table) in tables.items():
        t0 = time.perf_counter()
        comp = compare_tuners(prob, table)
        print_comparison(prob.name, comp)
        out["compare"][name] = {"seconds": time.perf_counter() - t0,
                                "best_ms": table.best()[1] * 1e3,
                                "configs": len(table.configs),
                                "tuners": comp}
    return out


#: the servedb phase: the screened GEMM session's tuner, seed, budget and
#: measured share, and the warm-started submit's rows and budget
SCREEN_TUNER, SCREEN_SEED, SCREEN_BUDGET, SCREEN_FRAC = "genetic", 0, 40, 0.25
WARM_TOP, WARM_BUDGET = 8, 16
#: GEMM's shape for the lookup that the 4096^3 entry answers as nearest
NEAREST_GEMM = {"m": 2048, "n": 2048, "k": 2048}


def servedb_check(orch: dict, tmp: Path, gemm, attention, conv2d,
                  conv2d_table, gemm_trials, gemm_best_s: float, serve,
                  counts, failures: list[str],
                  problem_args: tuple = ()) -> dict:
    """The serving layer and the surrogate on the card, over what the run
    measured (no new landscape):

    1. ``servedb build`` over the ``orchestrator`` phase's store (``orch``:
       the GEMM session, attention's grid, the campaign over h100,
       h100sxm and h100pcie), then ``servedb verify``;
    2. lookups in this process under ``h100``: GEMM at its shape (exact:
       the session's best), GEMM at ``NEAREST_GEMM`` (nearest), attention
       at its shape (exact: the best of its sessions), conv2d (no session:
       the cost model's pick, a lookup launching nothing) and an unknown
       name (the floor, ``{}``); each answer the space admits at its shape
       is launched there and held against its plain version (``serve(name,
       config, shape)``, False where the space does not admit it), and the
       exact GEMM answer is timed against the session's median;
    3. the surrogate on conv2d: the path's measured table (``h100``) and
       the cost model's whole tables (``h100sxm``, ``h100pcie``), fitted
       with ``h100`` held out (Spearman's rho on the measured table, the
       measured best of the model's top 8 as a share of the table's best),
       then on all rows and saved to a model store that must verify;
    4. a screened GEMM session in this process (``SCREEN_*``), its model
       fitted on GEMM's cost-model tables and ``gemm_trials``: GEMM's
       launches up by exactly ``warmup + repeats`` a measured trial, none
       for an estimated one, and its harvest taking no estimated row;
    5. ``submit --warm-start`` over that model (``WARM_TOP``,
       ``WARM_BUDGET``): the journal's first rows are the model's top rows.

    The warm-started submit runs while step 3 fits (host arithmetic).  The
    measured arch is ``gemm.arch`` (on the card ``h100``); the harvests'
    vocabulary is it and the cost model's ids.  ``problem_args`` go to
    the submit (on the card none: the card, at the problem's shape).
    Returns what it measured."""
    import math

    import numpy as np

    from repro_torch import calibrate
    from repro_torch.core.costmodel import ARCH_NAMES
    from repro_torch.core.results import ResultsDB
    from repro_torch.core.spacetable import mixed_radix_strides
    from repro_torch.core.surrogate import (ESTIMATED_INFO, Harvest,
                                            KernelSurrogate, ModelStore,
                                            SurrogateScreen)
    from repro_torch.orchestrator import SessionSpec, SessionStore, run_session
    from repro_torch.servedb import ServeDB, load
    t_phase = time.perf_counter()
    store, db_dir, models = Path(orch["store"]), tmp / "servedb", \
        tmp / "models"
    arch = gemm.arch
    vocab = (arch, *ARCH_NAMES)
    per = gemm.warmup + gemm.repeats
    out: dict = {}

    def table_rows(prob, table) -> list[int]:
        codes = np.asarray(table.configs, dtype=np.int64)
        strides = mixed_radix_strides([p.cardinality
                                       for p in prob.space.params])
        return (codes @ strides).tolist()

    def model_tables(h: Harvest, prob) -> None:
        rows = prob.space.compiled().valid_rows
        objs = prob.objectives_for_rows_archs(rows, ARCH_NAMES)
        for a, o in zip(ARCH_NAMES, objs):
            h.add_rows(rows.tolist(), a, o)

    # 1. build (its start is mostly import torch: the GEMM model fits
    # meanwhile, host arithmetic), then verify
    build = start_cli("servedb", "build", "--store", str(store), "--db",
                      str(db_dir), "--json")
    t0 = time.perf_counter()
    gh = Harvest(gemm.name, gemm.space, archs=vocab)
    model_tables(gh, gemm)
    ok = [t for t in gemm_trials if t.ok]
    gh.add_rows([gemm.space.flat_index(t.config) for t in ok], arch,
                [t.objective for t in ok])
    gts = gh.build()
    gmodel = KernelSurrogate.fit(gts)
    ModelStore(models).save(gmodel)
    gfit_s = time.perf_counter() - t0
    text, build_s = finish_cli(build, ("servedb", "build"))
    built = json.loads(text.strip().splitlines()[-1])
    text, verify_s = orchestrator_cli("servedb", "verify", "--db",
                                      str(db_dir), "--json")
    report = json.loads(text.strip().splitlines()[-1])
    snap, _ = load(db_dir)
    entries = {k: {a: len(g["entries"]) for a, g in archs.items()}
               for k, archs in (snap.tables if snap else {}).items()}
    print(f"  servedb build {build_s:.1f} s (generation "
          f"{built['generation']}, {built['entries']} entries, build "
          f"problems {built['build_problems']}), verify {verify_s:.1f} s "
          f"({'ok' if report['ok'] else report['problems']}); entries by "
          f"kernel and arch {entries}")
    failures.extend(f"servedb: {msg}" for ok_, msg in [
        (not built["build_problems"], f"build problems "
         f"{built['build_problems']}"),
        (report["ok"], f"verify: {report['problems']}"),
        (entries == {"gemm_h100": {arch: 1}, "flash_attention_h100": {
            a: 1 for a in vocab}},
         f"entries {entries}")] if not ok_)
    out["build"] = {"seconds": build_s, "verify_s": verify_s,
                    "entries": entries, "generation": built["generation"]}

    # 2. lookups, then each answer at its shape
    tables = ResultsDB(store / "tables")

    def session_best(kernel: str, prob) -> tuple[dict, float]:
        best = min((tables.get(*key).best()[::-1]
                    for key in tables.list_tables()
                    if key[:2] == (kernel, arch)), key=lambda b: b[0])
        return prob.space.decode(best[1]), best[0]

    db = ServeDB(db_dir, reload_every_s=0.0)
    queries = {"gemm_exact": ("gemm_h100", dict(gemm.shape)),
               "gemm_nearest": ("gemm_h100", dict(NEAREST_GEMM)),
               "attention_exact": ("flash_attention_h100",
                                   dict(attention.shape)),
               "conv2d": ("conv2d_h100", dict(conv2d.shape)),
               "unknown": ("no_such_kernel", {})}
    want_tier = {"gemm_exact": ("exact", None),
                 "gemm_nearest": ("nearest", None),
                 "attention_exact": ("exact", None),
                 "conv2d": ("heuristic", "heuristic:cost-model"),
                 "unknown": ("default", "default:static")}
    before = counts()
    answers, lookup_ms = {}, {}
    for q, (kernel, shape) in queries.items():
        t0 = time.perf_counter()
        answers[q] = db.lookup(kernel, shape, arch)
        lookup_ms[q] = (time.perf_counter() - t0) * 1e3
    quiet = counts() == before
    g_cfg, g_s = session_best("gemm_h100", gemm)
    a_cfg, a_s = session_best("flash_attention_h100", attention)
    checks = [(quiet, f"the lookups launched kernels: {before} -> "
               f"{counts()}")]
    for q, r in answers.items():
        tier, detail = want_tier[q]
        print(f"  lookup {q}: {r.kernel} {r.shape} -> {r.tier} "
              f"[{r.detail}] in {lookup_ms[q]:.2f} ms: {r.config}")
        checks.append((r.tier == tier and detail in (None, r.detail),
                       f"{q}: tier {r.tier} [{r.detail}], not {tier}"))
    checks += [
        (answers["gemm_exact"].config == g_cfg
         and answers["gemm_exact"].objective == g_s,
         f"gemm exact {answers['gemm_exact'].config} is not the session's "
         f"best {g_cfg}"),
        (answers["gemm_nearest"].config == g_cfg,
         f"gemm nearest {answers['gemm_nearest'].config}"),
        (answers["attention_exact"].config == a_cfg
         and answers["attention_exact"].objective == a_s,
         f"attention exact {answers['attention_exact'].config} is not the "
         f"sessions' best {a_cfg}"),
        (answers["unknown"].config == {},
         f"unknown name answered {answers['unknown'].config}")]
    before = counts()
    launched_by_tier: dict[str, int] = {}
    refused_by_tier: dict[str, int] = {}
    for q, r in answers.items():
        if not r.config:
            continue
        if serve(r.kernel, r.config, r.shape):
            launched_by_tier[r.tier] = launched_by_tier.get(r.tier, 0) + 1
        else:
            refused_by_tier[r.tier] = refused_by_tier.get(r.tier, 0) + 1
            print(f"  {q}: the space does not admit {r.config} at "
                  f"{r.shape}")
    exact_s = gemm.evaluate(g_cfg).objective
    served = {k: v - before[k] for k, v in counts().items()
              if v != before[k]}
    print(f"  answers launched by tier {launched_by_tier}, not admitted "
          f"{refused_by_tier}; launches {served}; the exact GEMM answer "
          f"{exact_s * 1e3:.4f} ms against the session's "
          f"{g_s * 1e3:.4f} ms")
    checks.append((abs(exact_s / g_s - 1.0) <= 0.05,
                   f"exact GEMM answer {exact_s * 1e3:.4f} ms against the "
                   f"session's {g_s * 1e3:.4f} ms"))
    failures.extend(f"servedb lookups: {msg}" for ok_, msg in checks
                    if not ok_)
    out["lookups"] = {q: {"tier": r.tier, "detail": r.detail,
                          "config": r.config, "ms": lookup_ms[q]}
                      for q, r in answers.items()}
    out["launched_by_tier"], out["refused_by_tier"] = launched_by_tier, \
        refused_by_tier
    out["launches"] = served
    out["exact_gemm_ms"], out["session_gemm_ms"] = exact_s * 1e3, g_s * 1e3

    # 4. the screened GEMM session
    screen = SurrogateScreen(gmodel, gemm.space, arch,
                             measure_frac=SCREEN_FRAC)
    spec = SessionSpec(problem=gemm.name, tuner=SCREEN_TUNER, arch=arch,
                       budget=SCREEN_BUDGET, seed=SCREEN_SEED, workers=1)
    sstore = SessionStore(tmp / "screened")
    sstore.create(spec)
    before = counts()["gemm"]
    t0 = time.perf_counter()
    res = run_session(spec, problem=gemm, store=sstore, mode="thread",
                      screen=screen)
    screen_s = time.perf_counter() - t0
    screen_launches = counts()["gemm"] - before
    meas = [t for t in res.trials if not t.info.get("estimated")]
    est = [t for t in res.trials if t.info.get("estimated")]
    h = Harvest(gemm.name, gemm.space, archs=vocab)
    harvested = h.add_store(sstore)
    best_meas = min((t.objective for t in meas if t.ok), default=math.inf)
    print(f"  screened GEMM session ({SCREEN_TUNER}, seed {SCREEN_SEED}, "
          f"budget {SCREEN_BUDGET}, measure_frac {SCREEN_FRAC}): "
          f"{len(meas)} measured, {len(est)} estimated in {screen_s:.2f} "
          f"s; gemm launches {screen_launches}; harvest took {harvested} "
          f"rows, skipped {h.n_skipped_estimated} estimated; best measured "
          f"{best_meas * 1e3:.4f} ms = {gemm_best_s / best_meas:.1%} of the "
          f"main phase's best {gemm_best_s * 1e3:.4f} ms")
    failures.extend(f"servedb screen: {msg}" for ok_, msg in [
        (len(res.trials) == SCREEN_BUDGET and meas and est,
         f"{len(res.trials)} trials, {len(meas)} measured"),
        (all(t.ok for t in meas), "measured trials invalid: " + "; ".join(
            f"{t.config} {t.info}" for t in meas if not t.ok)[:2000]),
        (all(t.info == ESTIMATED_INFO for t in est),
         "an estimated trial lacks its provenance"),
        (screen_launches == len(meas) * per,
         f"gemm launches {screen_launches}, not {len(meas)} measured x "
         f"{per}"),
        (harvested == len(meas) and h.n_skipped_estimated == len(est),
         f"harvest took {harvested} rows, skipped "
         f"{h.n_skipped_estimated}")] if not ok_)
    out["screen"] = {"seconds": screen_s, "measured": len(meas),
                     "estimated": len(est), "launches": screen_launches,
                     "best_ms": best_meas * 1e3,
                     "share_of_main_best": gemm_best_s / best_meas,
                     "harvested": harvested}

    # 5. the warm-started submit, in the background while 3 fits
    wstore = tmp / "warm"
    top = gmodel.top_rows(gemm.space, arch, k=WARM_TOP)
    warm = start_cli("submit", "--problem", gemm.name, "--tuner",
                     SCREEN_TUNER, "--arch", arch, "--budget",
                     str(WARM_BUDGET), "--warm-start", str(models),
                     "--warm-top", str(WARM_TOP), "--workers", "1",
                     "--store", str(wstore), "--trace",
                     str(tmp / "warm.jsonl"), *problem_args)

    # 3. the surrogate on conv2d
    t0 = time.perf_counter()
    ch = Harvest(conv2d.name, conv2d.space, archs=vocab)
    n_meas = ch.add_table(conv2d_table)
    model_tables(ch, conv2d)
    cts = ch.build()
    rest, held = cts.split_arch(arch)
    cmodel = KernelSurrogate.fit(rest)
    rho = calibrate.spearman(cmodel.predict_log(held.X), held.y)
    measured_s = dict(zip(table_rows(conv2d, conv2d_table),
                          conv2d_table.objectives))
    ctop = cmodel.top_rows(conv2d.space, arch, k=8)
    top_best = min(measured_s[r] for r in ctop)
    table_best = min(measured_s.values())
    full_model = KernelSurrogate.fit(cts)
    ModelStore(models).save(full_model)
    verdict = ModelStore(models).verify_dir()
    conv_s = time.perf_counter() - t0
    print(f"  surrogate on conv2d: {n_meas} measured rows ({arch}) + "
          f"{len(cts) - n_meas} cost-model rows; {arch} held out: rho "
          f"{rho:.3f}, the model's top 8 reach "
          f"{table_best / top_best:.1%} of the table's best "
          f"({top_best * 1e3:.4f} against {table_best * 1e3:.4f} ms); "
          f"fitted on all {len(cts)} rows; models {verdict}; {conv_s:.1f} "
          f"s (GEMM's model: {len(gts)} rows, {gfit_s:.1f} s)")
    failures.extend(f"servedb surrogate: {msg}" for ok_, msg in [
        (n_meas == len(conv2d_table), f"{n_meas} of {len(conv2d_table)} "
         f"measured rows harvested"),
        (verdict == {"ok": ["conv2d_h100", "gemm_h100"], "problems": {}},
         f"model store {verdict}")] if not ok_)
    out["surrogate"] = {"measured_rows": n_meas, "rows": len(cts),
                        "heldout_rho": rho, "top8_share": table_best
                        / top_best, "seconds": conv_s,
                        "gemm_rows": len(gts), "gemm_fit_s": gfit_s}

    text, warm_s = finish_cli(warm, ("submit", "--warm-start"))
    sid = session_id(text)
    recs = journal_records(wstore, sid)
    warm_launches = span_launches(trace_spans(tmp / "warm.jsonl"))
    first = [r["k"] for r in recs[:WARM_TOP]]
    warm_best = min((r["o"] for r in recs if r.get("v")), default=math.inf)
    print(f"  warm-started submit {sid}: {len(recs)} trials in "
          f"{warm_s:.1f} s, first {WARM_TOP} rows "
          f"{'= the model top rows' if first == top else first}; launches "
          f"{warm_launches}; best {warm_best * 1e3:.4f} ms = "
          f"{gemm_best_s / warm_best:.1%} of the main phase's best")
    failures.extend(f"servedb warm start: {msg}" for ok_, msg in [
        (len(recs) == WARM_BUDGET, f"{len(recs)} journal lines"),
        (first == top, f"first rows {first}, the model's top {top}"),
        (warm_launches == {"gemm": WARM_BUDGET * per},
         f"launches {warm_launches}")] if not ok_)
    out["warm_start"] = {"seconds": warm_s, "rows": first,
                         "launches": warm_launches.get("gemm", 0),
                         "best_ms": warm_best * 1e3,
                         "share_of_main_best": gemm_best_s / warm_best}
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: the lm phase: qwen3-8b at full width and depth, served by the engine
#: with 4 slots over 4096 positions, greedy, 32 new tokens a request; the
#: prompts the flash kernel takes (some config of its space fits: a
#: block_q divides the length) and two it does not, which run the plain
#: formulation; the prompt whose last logits the two routes are compared
#: on
LM_ARCH = "qwen3-8b"
LM_SLOTS, LM_MAX_LEN, LM_NEW = 4, 4096, 32
LM_KERNEL_PROMPTS = (512, 1024, 2048, 3968)
LM_PLAIN_PROMPTS = (100, 777)
LM_COMPARE = 2048
#: rel-L2 of that prompt's last-position f32 logits, flash kernel against
#: plain route (the same weights).  The plain route rounds the softmax
#: weights to bf16 before P V (the JAX package's cast); the kernel carries
#: P as bf16 hi + lo.  One attention call of the model's heads at 2048
#: tokens keeps each within a few 1e-3 of the f32 oracle (1.6e-3 the
#: kernel, 2.3e-3 the plain route, PERF.md), so the routes differ by a few
#: 1e-3 in each layer.  Through 36 layers of random weights that grows
#: about tenfold, to 2.1e-2 on an H100 (this phase, PERF.md), as 13
#: reduced layers grow one-ulp flips to 1.1e-2 on the CPU
#: (``tests/test_torch_models.py``).  The bound is more than twice that; a
#: wrong mask, scale or head mapping moves it by order one, and each
#: single call is also held to the JAX package's oracle tolerance.
LM_TOL = 5e-2


def fresh_peak(dev) -> float | None:
    """On the card: the tensors no name holds any more freed (a model's
    parameters can sit in a reference cycle until the collector runs),
    the allocator's cache emptied and its peak reset; returns the GiB
    still allocated, which the next peak includes.  None on the host."""
    import gc

    import torch
    if dev.type != "cuda":
        return None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) / 2.0 ** 30


def attention_routes(cfg, seq: int) -> dict[str, int]:
    """The prefill of a ``seq``-token prompt by ``cfg``: how many of its
    attention calls that :data:`~repro_torch.models.attention.ROUTES`
    counts take the flash kernel and how many the plain route, by
    ``prefill_route``'s rules on the card (a causal self-attention layer
    with no window, a head dim the kernel is built for, and a shape some
    config of the ``flash_attention_h100`` space fits).  The encoder's
    layers (not causal) and the cross-attention (keys of the encoder) run
    plain; MLA's attention and the recurrences are not counted there."""
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.space import build_space
    from repro_torch.kernels.common import config_at
    specs = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    attn = [s for s in specs if s.kind == "attn"]
    fits = cfg.d_head in fkernel.HEAD_DIMS and config_at(
        build_space, {"hq": cfg.n_heads, "hkv": max(1, cfg.n_kv_heads),
                      "tq": seq, "tk": seq, "d": cfg.d_head},
        fops.DEFAULT_CONFIG, fops.SEMANTIC) is not None
    kernel = sum(1 for s in attn if not s.window) if fits else 0
    return {"kernel": kernel, "plain": len(attn) - kernel
            + cfg.n_enc_layers + sum(1 for s in specs if s.cross)}


def lm_check(db_dir, smi: str, counts, zero_counts, failures: list[str], *,
             cfg=None, device: str = "cuda",
             kernel_prompts=LM_KERNEL_PROMPTS, plain_prompts=LM_PLAIN_PROMPTS,
             compare: int | None = LM_COMPARE, max_len: int = LM_MAX_LEN,
             new_tokens: int = LM_NEW, want_tier: str = "exact",
             tag: str = "lm") -> dict:
    """The LM path: ``cfg`` (default ``LM_ARCH`` at full width and depth)
    made on ``device`` from seed 0 (``Model.init``), served by
    ``ServingEngine`` planned from the find-DB at ``db_dir`` (the servedb
    phase's snapshot, whose attention entry is this model's
    ``attention_shape`` at ``max_len``: tier ``want_tier``; None: no DB,
    tier ``default``).  An encoder-decoder's requests carry
    ``ENC_OUT_LEN`` frames, as the launcher's.  The counts (``counts()``:
    each kernel's op launches) are set to 0 just before the requests are
    served and read just after: attention must have launched once a layer
    that takes it (:func:`attention_routes`) for each prompt in
    ``kernel_prompts`` and nothing else any time, and the plain route run
    as :func:`attention_routes` says for every prompt (a prompt of
    ``plain_prompts`` takes no kernel) and once a cross-attention layer a
    decode step.  Every request completes with ``new_tokens`` tokens.
    Then, outside the counts and where ``compare`` names a prompt, that
    prompt's last logits by the kernel route against the plain one,
    within ``LM_TOL``; their argmax agreement is reported, not required
    (random weights give near ties).  Failures are prefixed with ``tag``.
    Prints each number beside ``smi``; returns what it measured."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.attention import ROUTES
    from repro_torch.serve.decode import (ENC_OUT_LEN, FLASH, Request,
                                          ServeConfig, ServingEngine)
    t_phase = time.perf_counter()
    cfg = cfg or ARCHS[LM_ARCH]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    gib = 2.0 ** 30
    base_gib = fresh_peak(dev)
    t0 = time.perf_counter()
    model = build_model(cfg).init(0, dev)
    sync()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, ServeConfig(
        n_slots=LM_SLOTS, max_len=max_len, max_new_tokens=new_tokens,
        servedb=None if db_dir is None else str(db_dir)))
    plan = engine.kernel_plan[FLASH]
    param_gib = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / gib
    kv_gib = sum(t.numel() * t.element_size() for layer in engine.cache
                 for part in layer.values()
                 for t in (part.values() if isinstance(part, dict)
                           else part)) / gib
    n_params = sum(p.numel() for p in model.parameters())
    prompts = (*kernel_prompts, *plain_prompts)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                    .astype(np.int32), frames=rng.standard_normal(
                        (ENC_OUT_LEN, cfg.d_model)).astype(np.float32)
                    if cfg.frontend == "audio" else None)
            for i, n in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    sync()
    zero_counts()
    ROUTES.clear()
    t0 = time.perf_counter()
    done = engine.run()
    sync()
    run_s = time.perf_counter() - t0
    launches, routes = counts(), dict(ROUTES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / gib if cuda else None

    tokens = sum(len(c.tokens) for c in done)
    decode_ms = statistics.median(engine.decode_ms)
    # the kernel takes the kernel prompts on the card; the host runs every
    # prompt on the plain route
    kernel_at = [cuda and i < len(kernel_prompts)
                 for i in range(len(prompts))]
    split = [attention_routes(cfg, n) for n in prompts]
    want = {name: 0 for name in launches}
    want["flash_attention"] = sum(r["kernel"] for r, k in zip(split,
                                                              kernel_at) if k)
    want_plain = sum(r["plain"] + (0 if k else r["kernel"])
                     for r, k in zip(split, kernel_at)) \
        + engine.steps * sum(1 for i in range(cfg.n_layers)
                             if cfg.pattern[i % len(cfg.pattern)].cross)
    routed = [p["route"] for p in sorted(engine.prefills,
                                         key=lambda p: p["uid"])]
    failures.extend(f"{tag}: {msg}" for ok, msg in [
        (sorted(c.uid for c in done) == list(range(len(reqs))),
         f"completed {sorted(c.uid for c in done)} of {len(reqs)}"),
        (all(len(c.tokens) == new_tokens for c in done),
         f"tokens per request {[len(c.tokens) for c in done]}"),
        (launches == want, f"launches {launches}, want {want}"),
        (routes.get("plain", 0) == want_plain,
         f"plain route {routes.get('plain', 0)}, want {want_plain}"),
        (routes.get("kernel:plan", 0) + routes.get("kernel:resolved", 0)
         == want["flash_attention"], f"kernel route {routes}"),
        (routed == ["kernel" if k else "plain" for k in kernel_at],
         f"prefill routes {routed}"),
        (plan.tier == want_tier, f"plan tier {plan.tier}, want {want_tier}"),
    ] if not ok)

    cmp = None if compare is None else compare_routes(
        model, engine.kernel_config(FLASH), reqs[prompts.index(compare)],
        sync, failures, tag)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "param_gib": param_gib, "kv_cache_gib": kv_gib,
        "allocated_before_gib": base_gib,
        "max_memory_allocated_gib": peak_gib, "init_s": init_s,
        "plan_tier": plan.tier, "plan_config": dict(plan.config),
        "prefills": engine.prefills, "decode_steps": engine.steps,
        "decode_ms_median": decode_ms, "generated_tokens": tokens,
        "run_s": run_s, "tokens_per_s": tokens / run_s,
        "launches": launches["flash_attention"], "routes": routes,
        "compare": cmp, "nvidia_smi": smi,
    }
    print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, {param_gib:.2f} GiB; cache "
          f"{kv_gib:.2f} GiB ({LM_SLOTS} slots x {max_len}); allocated "
          f"before {base_gib if base_gib is None else round(base_gib, 2)} "
          f"GiB, max_memory_allocated "
          f"{peak_gib if peak_gib is None else round(peak_gib, 2)} GiB; "
          f"init {init_s:.2f} s ({smi})")
    print(f"  plan {FLASH} at {plan.shape}: tier {plan.tier}, "
          f"{dict(plan.config)}")
    for p in sorted(engine.prefills, key=lambda p: p["uid"]):
        print(f"  prefill {p['prompt_len']:5d} tokens: {p['ms']:.2f} ms, "
              f"{p['route']} route ({smi})")
    print(f"  {len(done)} requests, {tokens} tokens in {engine.steps} decode "
          f"steps: median step {decode_ms:.2f} ms, {tokens / run_s:.1f} "
          f"tokens/s over the run's {run_s:.2f} s ({smi})")
    print(f"  attention launches {launches['flash_attention']} (routes "
          f"{routes})")
    if cmp is not None:
        pin = " with the plain route's experts pinned to the kernel's" \
            if cmp["routing_pinned"] else ""
        control = cmp["control_rel_l2"]
        print(f"  kernel vs plain route at {compare} tokens: rel_l2 "
              f"{cmp['rel_l2']:.3e} under the plan's config{pin}, "
              f"{cmp['rel_l2_unpinned']:.3e} unpinned, "
              f"{cmp['rel_l2_own_config']:.3e} under the op's own "
              f"(tolerance {LM_TOL:g}); the plan's config against its "
              f"other block_kv "
              f"{'not admitted' if control is None else f'{control:.3e}'}"
              + ("; tokens whose experts differ between the routes, by "
                 "layer: " + " ".join(f"{f:.4f}" for f in cmp["expert_flips"])
                 if cmp["expert_flips"] else "") + "; argmax "
              f"{'agrees' if cmp['argmax_agrees'] else 'differs'}; prefill "
              f"{cmp['kernel_prefill_ms']:.2f} / "
              f"{cmp['kernel_own_prefill_ms']:.2f} ms against "
              f"{cmp['plain_prefill_ms']:.2f} ms ({smi})")
        print("  one attention call at that length, rel_l2 to the f32 "
              "oracle: " + ", ".join(
                  f"{k} {v:.3e}"
                  for k, v in cmp["one_call_vs_f32_oracle"].items()))
    del engine, model
    if cuda:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


@contextmanager
def pinned_routing(choices: list):
    """While open, every MoE layer's top-k expert choices (``moe._gates``)
    are appended to ``choices`` where it starts empty, else replaced, call
    by call, by the ones it holds, their gate values then the router's own
    probabilities at those experts, normalised as ``_gates`` does."""
    import torch

    from repro_torch.models import moe
    gates = moe._gates
    replay = list(choices)

    def pinned(logits, top_k):
        probs, vals, idx = gates(logits, top_k)
        if not replay:
            choices.append(idx)
            return probs, vals, idx
        idx = replay.pop(0)
        vals = torch.gather(probs, -1, idx)
        return probs, vals / torch.clamp(vals.sum(-1, keepdim=True),
                                         min=1e-9), idx

    moe._gates = pinned
    try:
        yield
    finally:
        moe._gates = gates


def compare_routes(model, kernel_config: dict, req, sync,
                   failures: list[str], tag: str = "lm") -> dict:
    """``req``'s prompt (and frames) prefilled by ``model`` through the
    kernel route under ``kernel_config`` and under the op's own config,
    and through the plain route: each kernel prefill's last logits within
    ``LM_TOL`` of the plain one's, the plain model's prefill on the plain
    route alone.  Beside them the rounding control: the kernel under
    ``kernel_config`` with its other ``block_kv`` (the same sums in
    another order), against ``kernel_config``'s.  A MoE model's routes are
    held with the plain route's expert choices pinned to the kernel
    route's (:func:`pinned_routing`): a top-k choice is a step function of
    the router's logits, so a rounding-level difference in any layer's
    attention flips some tokens' experts and every layer after compounds
    it, the control as much as the routes (PERF.md section 6, PR 30); the
    unpinned distance is reported.  Then one attention call of the
    model's heads at that length on seeded q, k, v, each route against
    the f32 oracle within the JAX package's tolerance.  Failures are
    prefixed with ``tag``; returns the distances and each prefill's
    milliseconds."""
    import numpy as np
    import torch

    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.ref import mha_reference
    from repro_torch.kernels.attention.space import build_space
    from repro_torch.kernels.common import admits
    from repro_torch.models.attention import (ROUTES, _mask_bias, _sdpa,
                                              admitted_config)
    from repro_torch.quickstart import rel_l2, tolerance
    cfg, dev = model.cfg, model.device
    n = len(req.prompt)
    plain = model.with_attention_impl("plain")
    batch = {"tokens": torch.as_tensor(req.prompt[None].astype(np.int64),
                                       device=dev)}
    if req.frames is not None:
        batch["frames"] = torch.as_tensor(req.frames[None], device=dev)
    plan = dict(fops.DEFAULT_CONFIG, **kernel_config)
    other = dict(plan, block_kv=64 if plan["block_kv"] == 128 else 128)
    if not admits(build_space(cfg.n_heads, cfg.n_kv_heads, n, n,
                              cfg.d_head), other):
        other = None
    moe = bool(cfg.n_experts)
    # each MoE run's expert choices: the kernel's recorded, replayed into
    # the pinned plain run; the plain run's recorded beside them
    choices = {"kernel": [], "plain": [], "plain_pinned": None}
    runs = [("kernel", model, kernel_config),
            ("kernel_own", model, None),
            ("plain", plain, None)]
    if other:
        runs.append(("kernel_other", model, other))
    if moe:
        runs.append(("plain_pinned", plain, None))
        choices["plain_pinned"] = choices["kernel"]
    cmp = {}
    for name, m, kc in runs:
        sync()
        before = ROUTES["plain"]
        t0 = time.perf_counter()
        pin = choices.get(name) if moe else None
        with contextlib.nullcontext() if pin is None else \
                pinned_routing(pin):
            logits, _, _ = m.prefill(batch, kernel_config=kc)
        sync()
        cmp[name] = (logits[0].float(), (time.perf_counter() - t0) * 1e3)
        if name == "plain":
            plain_routed = ROUTES["plain"] - before
    ref = cmp["plain_pinned" if moe else "plain"][0]
    err = rel_l2(cmp["kernel"][0], ref)
    err_own = rel_l2(cmp["kernel_own"][0], cmp["plain"][0])
    unpinned = rel_l2(cmp["kernel"][0], cmp["plain"][0])
    control = rel_l2(cmp["kernel_other"][0], cmp["kernel"][0]) \
        if other else None
    # the share of tokens whose top-k experts differ, kernel against
    # plain route, by layer
    flips = [float((a.sort(-1).values != b.sort(-1).values).any(-1)
                   .float().mean())
             for a, b in zip(choices["kernel"], choices["plain"])]
    agree = int(cmp["kernel"][0].argmax()) == int(cmp["plain"][0].argmax())
    held = [("plan's config", err)] if moe else \
        [("plan's config", err), ("op's own config", err_own)]
    for name, e in held:
        if not e <= LM_TOL:
            failures.append(f"{tag}: kernel ({name}) vs plain route"
                            f"{' (routing pinned)' if moe else ''} rel_l2 "
                            f"{e:.3e} > {LM_TOL:g} at {n} tokens")
    if plain_routed != sum(attention_routes(cfg, n).values()):
        failures.append(f"{tag}: the plain model's prefill took the kernel")
    gen = torch.Generator(dev).manual_seed(7)
    qkv = [torch.randn(h, n, cfg.d_head, generator=gen, device=dev)
           .to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads,
                                         cfg.n_kv_heads)]
    oracle = mha_reference(*(t.float() for t in qkv),
                           scale=cfg.d_head ** -0.5)
    bias = _mask_bias(n, n, 0, None, True, dev)
    one = {"kernel": fops.attention(*qkv, config=admitted_config(
               *qkv, kernel_config)),
           "kernel_own": fops.attention(*qkv),
           "plain": _sdpa(*(t.transpose(0, 1)[None] for t in qkv),
                          bias)[0].transpose(0, 1)}
    one_call = {name: rel_l2(o.float(), oracle) for name, o in one.items()}
    for name, plan_cfg in (("kernel", kernel_config),
                           ("kernel_own", fops.DEFAULT_CONFIG),
                           ("plain", {})):
        tol = tolerance("flash_attention_h100", plan_cfg)
        if not one_call[name] <= tol:
            failures.append(f"{tag}: one attention call by {name} misses "
                            f"the f32 oracle: rel_l2 {one_call[name]:.3e} > "
                            f"{tol:g}")
    return {"prompt": n, "rel_l2": err, "rel_l2_own_config": err_own,
            "tolerance": LM_TOL, "routing_pinned": moe,
            "rel_l2_unpinned": unpinned, "expert_flips": flips,
            "control_config": other,
            "control_rel_l2": control, "argmax_agrees": agree,
            "kernel_prefill_ms": cmp["kernel"][1],
            "kernel_own_prefill_ms": cmp["kernel_own"][1],
            "plain_prefill_ms": cmp["plain"][1],
            "one_call_vs_f32_oracle": one_call}


#: the train phase, part (a): ``TRAIN_ARCH`` at its published widths (d
#: 4096, 32/8 heads of 128, d_ff 12 288, vocab 151 936, remat on as its
#: config says) cut to ``TRAIN_LAYERS`` of its 36 layers, which one card
#: forces: at 16 bytes a parameter (bf16 weight and grad, f32 master, m
#: and v) the 7.57 B parameters of all 36 need 121 GB against the card's
#: 80.  ``train_4k``'s 4096-token sequences, a global batch of
#: ``TRAIN_BATCH`` (the cell's 256 cut for the phase's time) in
#: ``TRAIN_MICRO`` microbatches of one sequence: set, not asked of
#: ``launch.steps.microbatch_count``, which budgets the residuals only and
#: would pick 1, while the plain route keeps a layer's (32, 4096, 4096)
#: f32 scores, 2.1 GB a sequence, for the backward pass.
#: ``TRAIN_STEPS`` steps of ``make_train_step`` on ``SyntheticPipeline``
#: batches, driven directly: through ``TrainLoop`` the final checkpoint
#: would write about 30 GB
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 8, 4096, 4, 4
TRAIN_STEPS = 4
#: nats the last step's nll must lie below the first's: the first is
#: dominated by the tied head's prediction of each position's own token,
#: which the first updates unlearn (31.86 to 12.44 on an H100 80GB HBM3
#: at 700 W, PERF.md section 6)
TRAIN_DROP = 1.0
#: rel-L2 one full-width block's parameter gradients with remat may differ
#: from those without it: the recompute runs the same kernels on the same
#: inputs, so they should be equal to the bit; the bound allows for a
#: library kernel whose summation order is not fixed run to run
REMAT_TOL = 1e-6
#: part (b): the launcher's drill at the reduced config (``--reduced``,
#: 8 sequences of 128 tokens a step); the preempted run is sent SIGTERM
#: once it has logged step ``DRILL_STOP``
DRILL_STEPS, DRILL_CKPT_EVERY, DRILL_STOP = 16, 4, 6
#: the resumed run's step-16 loss and final parameters against the
#: uninterrupted run's, relative (max abs difference over the largest
#: magnitude).  Both runs issue the same kernels on the same inputs, so
#: on one card they should agree to the bit (on the CPU the loop's test
#: requires it); the bound allows for a library kernel whose summation
#: order is not fixed run to run
DRILL_TOL = 1e-3
#: part (c): the reduced step on the card against the CPU, same weights
#: and batch: the loss within ``CARD_LOSS_TOL`` relative, each
#: parameter's gradient within ``CARD_GRAD_TOL`` rel-L2.  The card's
#: products sum their f32 terms in another order than the host's, which
#: flips an occasional bf16 rounding, as the port against the JAX package
#: on the CPU: there the reduced archs' gradients differ by up to 2.6e-2
#: (``tests/torch_train.py``, whose ``GRAD_TOL`` is the same 5e-2)
CARD_LOSS_TOL, CARD_GRAD_TOL = 1e-3, 5e-2


def train_bound(cfg, n_params: int, block_params: int, seq: int,
                batch: int) -> dict:
    """The least time a step of ``batch`` sequences of ``seq`` tokens could
    take at the card's bf16 tensor-core peak (``SPEC_ARCH``'s row of
    ``core/costmodel.py``), every product counted at that rate though the
    plain attention's and the head's run in f32: 6 x parameters x tokens
    (forward 2, backward 4; the tied embedding's share is the head's
    product), plus the plain attention's two products (QK^T and PV, 2 x
    heads x seq^2 x d_head each, over the whole square: the plain route
    computes every entry and masks) a layer and a sequence, forward once,
    backward twice and remat's recompute once, plus remat's recompute of
    each block's own products (2 x the blocks' parameters x tokens)."""
    from repro_torch.core.costmodel import GPU_GENERATIONS
    tokens = seq * batch
    dense = 6.0 * n_params * tokens
    attn_fwd = 2 * 2.0 * cfg.n_heads * seq ** 2 * cfg.d_head \
        * cfg.n_layers * batch
    recompute = (2.0 * block_params * tokens + attn_fwd) if cfg.remat \
        else 0.0
    flops = dense + 3 * attn_fwd + recompute
    peak = GPU_GENERATIONS[SPEC_ARCH].peak_tc_bf16
    return {"flops": flops, "dense_flops": dense,
            "attention_flops": 3 * attn_fwd + (attn_fwd if cfg.remat else 0),
            "remat_block_flops": recompute - (attn_fwd if cfg.remat else 0),
            "peak_flops": peak, "bound_ms": flops / peak * 1e3}


def _drill_cmd(ckpt_dir: Path, metrics: Path, extra) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--reduced", "--steps", str(DRILL_STEPS),
            "--ckpt-every", str(DRILL_CKPT_EVERY), "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir), "--metrics", str(metrics), *extra]


def _summary(stdout: str) -> dict:
    """The launcher's JSON summary: its output from the first line that
    is ``{`` on."""
    lines = stdout.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:]))


def train_drill(tmp: Path, extra=(), env=None, timeout: float = 300.0
                ) -> dict:
    """``python -m repro_torch.launch.train --arch TRAIN_ARCH --reduced
    --steps 16 --ckpt-every 4 --log-every 1`` three times: uninterrupted,
    and at the same time a run sent SIGTERM once it has logged step
    ``DRILL_STOP`` (it finishes its step, checkpoints and exits 0); then
    that run again, which resumes from its checkpoint and finishes.
    Returns the three runs' summaries, exit codes and seconds, and the
    two finished checkpoints' directories."""
    import os
    import signal
    env = dict(os.environ if env is None else env)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    full_dir, pre_dir = tmp / "uninterrupted", tmp / "preempted"
    logs = {name: (tmp / f"{name}.out", tmp / f"{name}.err")
            for name in ("uninterrupted", "preempted")}
    t0 = time.perf_counter()
    with open(logs["uninterrupted"][0], "w") as full_out, \
            open(logs["uninterrupted"][1], "w") as full_err, \
            open(logs["preempted"][1], "w") as pre_err:
        full = subprocess.Popen(
            _drill_cmd(full_dir, tmp / "full.jsonl", extra), cwd=ROOT,
            env=env, stdout=full_out, stderr=full_err)
        pre = subprocess.Popen(
            _drill_cmd(pre_dir, tmp / "pre.jsonl", extra), cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=pre_err, text=True)
        out, signalled = [], None
        try:
            for line in pre.stdout:
                out.append(line.rstrip("\n"))
                if signalled is None and re.match(
                        rf"step\s+{DRILL_STOP}\s", line):
                    pre.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter() - t0
            pre_rc = pre.wait(timeout)
            pre_s = time.perf_counter() - t0
            full.wait(timeout)
            full_s = time.perf_counter() - t0
        finally:
            for p in (pre, full):
                if p.poll() is None:
                    p.kill()
                    p.wait()
            pre.stdout.close()
    full_stdout, full_stderr, pre_stderr = (
        path.read_text() for path in (logs["uninterrupted"][0],
                                      logs["uninterrupted"][1],
                                      logs["preempted"][1]))
    t1 = time.perf_counter()
    resume = subprocess.run(
        _drill_cmd(pre_dir, tmp / "resume.jsonl", extra), cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    resume_s = time.perf_counter() - t1
    runs = {}
    for name, rc, stdout, stderr, secs in (
            ("uninterrupted", full.returncode, full_stdout, full_stderr,
             full_s),
            ("preempted", pre_rc, "\n".join(out), pre_stderr, pre_s),
            ("resumed", resume.returncode, resume.stdout, resume.stderr,
             resume_s)):
        try:
            summary = _summary(stdout)
        except ValueError:
            summary = None
        runs[name] = {"rc": rc, "seconds": secs, "summary": summary,
                      "stderr_tail": stderr[-2000:] if rc else ""}
    return {"runs": runs, "signalled_at_s": signalled,
            "dirs": {"uninterrupted": full_dir, "resumed": pre_dir},
            "metrics": {"uninterrupted": tmp / "full.jsonl",
                        "resumed": tmp / "resume.jsonl"}}


def profile_microbatch(model, mb, sync, top: int = 10) -> dict:
    """One microbatch's ``train_loss`` forward and backward under
    ``torch.profiler`` (CPU and CUDA activity): the wall ms, the device
    kernels' summed ms and the ``top`` kernels by device time (name, ms,
    calls).  ``busy_ms`` 0 where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = model.train_loss(mb)
        loss.backward()
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms,
            "busy_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "top": [{"name": e.key, "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in rows[:top]]}


def train_check(smi: str, counts, zero_counts, failures: list[str], *,
                cfg=None, device: str = "cuda", seq: int = TRAIN_SEQ,
                batch: int = TRAIN_BATCH, micro: int = TRAIN_MICRO,
                steps: int = TRAIN_STEPS, drop: float = TRAIN_DROP,
                drill_args=(), drill_env=None) -> dict:
    """The training path.  (a) ``cfg`` (default ``TRAIN_ARCH`` at
    ``TRAIN_LAYERS`` layers) made on ``device`` from seed 0, ``steps``
    steps of ``make_train_step`` over ``batch`` sequences of ``seq``
    tokens in ``micro`` microbatches: every loss and grad norm finite, the
    first nll not below ln(vocab) - 1 and the last ``drop`` nats below the
    first, the master weights moved by step 1, no kernel launched (``counts()``, set to 0 just before the steps
    and read just after: training attention runs the plain route, the
    kernel having no backward) and the plain route run twice a layer and
    microbatch a step with remat (once without); then a step's time split
    into data, forward, backward with remat's recompute and the
    optimizer, each timed alone, and one block's parameter gradients with
    remat against those without it (``REMAT_TOL``).  (b) The launcher's
    SIGTERM and resume drill (:func:`train_drill`, ``drill_args`` added to
    each command): the resumed run's step-16 loss and final parameters
    against the uninterrupted run's (``DRILL_TOL``; on the CPU exactly),
    the events showing ``preempted`` and ``resumed``.  (c) The reduced
    config's loss and gradients on ``device`` against the CPU's on the
    same weights and batch (``CARD_LOSS_TOL``, ``CARD_GRAD_TOL``).
    Prints each number beside ``smi``; returns what it measured."""
    import copy
    import dataclasses
    import math

    import torch

    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.attention import ROUTES
    from repro_torch.quickstart import rel_l2
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                             init_opt_state)
    t_phase = time.perf_counter()
    cfg = cfg or dataclasses.replace(ARCHS[TRAIN_ARCH],
                                     n_layers=TRAIN_LAYERS)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gib = 2.0 ** 30

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(f"train: {msg}")

    # (a) the step at full width
    base_gib = fresh_peak(dev)
    t0 = time.perf_counter()
    model = build_model(cfg).init(0, dev)
    params = dict(model.named_parameters())
    opt_cfg = OptimizerConfig(total_steps=steps, warmup_steps=1)
    state = init_opt_state(opt_cfg, params)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    block_params = sum(p.numel() for p in model.blocks.parameters())
    param_gib = sum(p.numel() * p.element_size()
                    for p in params.values()) / gib
    opt_gib = sum(t.numel() * t.element_size() for part in ("m", "v",
                                                           "master")
                  for t in state[part].values()) / gib
    pipe = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch))
    t0 = time.perf_counter()
    pipe.batch_at(0)
    data_first_s = time.perf_counter() - t0     # the Markov table's build
    step = make_train_step(model, opt_cfg, micro)
    probe = "blocks.0.attn.wq"
    master0 = state["master"][probe].clone()
    zero_counts()
    ROUTES.clear()
    log, moved = [], None
    for i in range(steps):
        t0 = time.perf_counter()
        host = pipe.batch_at(i)
        data_s = time.perf_counter() - t0
        b = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        sync()
        t0 = time.perf_counter()
        state, m = step(model, state, b)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        log.append(dict({k: float(v) for k, v in m.items()}, ms=ms,
                        data_ms=data_s * 1e3))
        if i == 0:
            moved = not torch.equal(state["master"][probe], master0)
    launches, routes = counts(), dict(ROUTES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / gib if cuda else None
    del master0
    med_ms = statistics.median(r["ms"] for r in log)
    tokens = seq * batch
    bnd = train_bound(cfg, n_params, block_params, seq, batch)
    passes = 2 if cfg.remat else 1
    want_plain = cfg.n_layers * micro * passes * steps
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in log), f"a loss or grad norm is not finite: {log}")
    # the first nll is not near ln(vocab) at this width: the tied head
    # over N(0, 1) embeddings gives each position's own token a logit of
    # about sqrt(d_model) times its share of the final residual, as in the
    # JAX package (``tests/test_torch_train_grads.py::
    # test_initial_nll_grows_with_width_as_in_jax``).  So the first nll
    # must not beat uniform guessing by a nat (nothing is learned yet; a
    # label leak would), and the steps must bring the nll down by a nat
    check(log[0]["nll"] >= math.log(cfg.vocab) - 1.0,
          f"first nll {log[0]['nll']:.4f} below ln({cfg.vocab}) - 1 = "
          f"{math.log(cfg.vocab) - 1.0:.4f}")
    check(log[-1]["nll"] <= log[0]["nll"] - drop,
          f"nll {log[0]['nll']:.4f} at step 1, {log[-1]['nll']:.4f} at "
          f"step {steps}: want {drop:g} nat lower")
    check(bool(moved), "the master weights did not move in step 1")
    check(all(v == 0 for v in launches.values()),
          f"kernels launched while training: {launches}")
    check(routes.get("plain", 0) == want_plain
          and sum(routes.values()) == want_plain,
          f"attention routes {routes}, want plain {want_plain}")

    # a step's time split, each part timed alone (synchronised): data for
    # the batch, then each microbatch's forward and backward (remat's
    # recompute inside it), then the update from the f32 grads
    mbs = [{k: torch.as_tensor(v[j::micro], device=dev)
            for k, v in pipe.batch_at(steps).items()} for j in range(micro)]
    t0 = time.perf_counter()
    pipe.batch_at(steps + 1)
    split = {"data_ms": (time.perf_counter() - t0) * 1e3, "forward_ms": 0.0,
             "backward_ms": 0.0}
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for k, p in params.items()}
    for mb in mbs:
        model.zero_grad(set_to_none=True)
        sync()
        t0 = time.perf_counter()
        loss, _ = model.train_loss(mb)
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        for k, p in params.items():
            acc[k].add_(p.grad)
        split["forward_ms"] += (t1 - t0) * 1e3
        split["backward_ms"] += (t2 - t1) * 1e3
    model.zero_grad(set_to_none=True)
    sync()
    t0 = time.perf_counter()
    for g in acc.values():
        g.div_(micro)
    apply_updates(opt_cfg, params, state, acc)
    sync()
    split["optimizer_ms"] = (time.perf_counter() - t0) * 1e3
    del acc
    kernels = profile_microbatch(model, mbs[0], sync) if cuda else None
    model.zero_grad(set_to_none=True)
    del mbs, loss

    # one block's parameter gradients with remat and without
    plain = copy.copy(model)
    plain.cfg = dataclasses.replace(cfg, remat=False)
    gen = torch.Generator(dev).manual_seed(3)
    x = torch.randn(1, seq, cfg.d_model, generator=gen, device=dev) \
        .to(torch.bfloat16)
    w = torch.randn(1, seq, cfg.d_model, generator=gen, device=dev)
    positions = torch.arange(seq, device=dev)[None]
    block = model.blocks[0]
    grads = {}
    for name, m_ in (("remat", model), ("plain", plain)):
        out, _, _ = m_._block(block, x, m_.pattern[0], positions=positions)
        grads[name] = torch.autograd.grad((out.float() * w).sum(),
                                          list(block.parameters()))
    remat_errs = [rel_l2(a.float(), b.float())
                  for a, b in zip(grads["remat"], grads["plain"])]
    remat_bits = all(torch.equal(a, b)
                     for a, b in zip(grads["remat"], grads["plain"]))
    check(max(remat_errs) <= REMAT_TOL,
          f"one block's grads with remat vs without: rel_l2 "
          f"{max(remat_errs):.3e} > {REMAT_TOL:g}")
    del grads, x, w, plain, model, params, state, step, block
    if cuda:
        torch.cuda.empty_cache()

    # (b) the launcher's drill
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train") as work:
        t0 = time.perf_counter()
        drill = train_drill(Path(work), drill_args, drill_env)
        drill_s = time.perf_counter() - t0
        runs = drill["runs"]
        for name, run in runs.items():
            check(run["rc"] == 0 and run["summary"] is not None,
                  f"drill's {name} run: exit {run['rc']} "
                  f"{run['stderr_tail']}")
        events = {name: (run["summary"] or {}).get("events", [])
                  for name, run in runs.items()}
        stopped = [e["step"] for e in events["preempted"]
                   if e["event"] == "preempted"]
        resumed = [e["step"] for e in events["resumed"]
                   if e["event"] == "resumed"]
        check(len(stopped) == 1 and DRILL_STOP <= stopped[0] < DRILL_STEPS
              and resumed == stopped,
              f"drill events: preempted {stopped}, resumed {resumed}")
        finals = [(run["summary"] or {}).get("final_step")
                  for run in runs.values()]
        check(finals[0] == finals[2] == DRILL_STEPS,
              f"drill final steps {finals}")
        last = {}
        for name in ("uninterrupted", "resumed"):
            path = drill["metrics"][name]
            rows = [json.loads(s) for s in path.read_text().splitlines()] \
                if path.exists() else []
            last[name] = rows[-1] if rows else {}
        rcfg = reduce_config(ARCHS[TRAIN_ARCH])
        trees = {}
        for name, d in drill["dirs"].items():
            m_ = build_model(rcfg).init(0, "cpu")
            tree = {"params": m_.state_dict(),
                    "opt": init_opt_state(OptimizerConfig(),
                                          dict(m_.named_parameters()))}
            try:
                ckpt.restore(d, tree)
                trees[name] = ckpt._flatten(tree)
            except (OSError, ValueError) as e:
                check(False, f"drill's {name} checkpoint: {e}")
        leaf_diff = loss_diff = None
        if len(trees) == 2 and last["uninterrupted"] and last["resumed"]:
            a, b = trees["uninterrupted"], trees["resumed"]
            leaf_diff = max(float((x.double() - y.double()).abs().max()
                                  / max(float(x.double().abs().max()),
                                        1e-30))
                            if x.is_floating_point() else
                            float((x != y).any())
                            for x, y in zip(a, b))
            bits = all(torch.equal(x, y) for x, y in zip(a, b))
            lu, lr = last["uninterrupted"]["loss"], last["resumed"]["loss"]
            loss_diff = abs(lu - lr) / abs(lu)
            tol = 0.0 if not cuda else DRILL_TOL
            check(last["uninterrupted"]["step"] == last["resumed"]["step"]
                  == DRILL_STEPS and loss_diff <= tol and leaf_diff <= tol,
                  f"drill: resumed vs uninterrupted at step {DRILL_STEPS}: "
                  f"loss {lr} vs {lu}, leaves differ by {leaf_diff:.3e} "
                  f"(tolerance {tol:g})")
        else:
            bits = False
            check(False, f"drill: no final metrics or checkpoints {last}")

    # (c) the reduced step on the device against the CPU
    rcfg = reduce_config(ARCHS[TRAIN_ARCH])
    host_model = build_model(rcfg).init(0, "cpu")
    dev_model = build_model(rcfg)
    dev_model.to_empty(device=dev)
    dev_model.load_state_dict(host_model.state_dict())
    rbatch = make_pipeline(DataConfig(vocab=rcfg.vocab, seq_len=128,
                                      global_batch=8)).batch_at(0)
    losses = {}
    for name, m_ in (("host", host_model), ("device", dev_model)):
        loss, _ = m_.train_loss(rbatch)
        loss.backward()
        losses[name] = float(loss.detach())
    card_loss_err = abs(losses["device"] - losses["host"]) \
        / abs(losses["host"])
    card_grad_errs = {n: rel_l2(p.grad.float().cpu(),
                                host_model.get_parameter(n).grad.float())
                      for n, p in dev_model.named_parameters()}
    worst = max(card_grad_errs, key=card_grad_errs.get)
    check(card_loss_err <= CARD_LOSS_TOL,
          f"reduced loss on {device} {losses['device']} vs host "
          f"{losses['host']}: rel {card_loss_err:.3e} > {CARD_LOSS_TOL:g}")
    check(card_grad_errs[worst] <= CARD_GRAD_TOL,
          f"reduced grads on {device} vs host: {worst} rel_l2 "
          f"{card_grad_errs[worst]:.3e} > {CARD_GRAD_TOL:g}")

    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "seq": seq, "batch": batch, "microbatches": micro, "steps": steps,
        "params": n_params, "param_gib": param_gib, "opt_state_gib": opt_gib,
        "allocated_before_gib": base_gib, "max_memory_allocated_gib": peak_gib,
        "init_s": init_s, "data_first_batch_s": data_first_s, "log": log,
        "step_ms_median": med_ms, "tokens_per_s": tokens / med_ms * 1e3,
        "bound": bnd, "share_of_bound": bnd["bound_ms"] / med_ms,
        "split": split, "device_kernels": kernels, "launches": launches,
        "routes": routes,
        "remat": {"rel_l2_max": max(remat_errs), "bit_equal": remat_bits},
        "drill": {"seconds": drill_s, "signalled_at_s":
                  drill["signalled_at_s"], "preempted_at": stopped,
                  "resumed_at": resumed, "loss_rel_diff": loss_diff,
                  "leaf_rel_diff": leaf_diff, "bit_equal": bits,
                  "runs": {k: {"rc": v["rc"], "seconds": v["seconds"],
                               "events": events[k]}
                           for k, v in runs.items()}},
        "card_vs_host": {"loss": losses, "loss_rel": card_loss_err,
                         "grad_rel_l2_max": card_grad_errs[worst],
                         "grad_worst": worst},
        "nvidia_smi": smi,
    }
    print(f"  {cfg.name} at {cfg.n_layers} of its layers, d {cfg.d_model}: "
          f"{n_params / 1e9:.3f} B parameters, {param_gib:.2f} GiB, "
          f"optimizer state {opt_gib:.2f} GiB; init {init_s:.2f} s; "
          f"allocated before {base_gib if base_gib is None else round(base_gib, 2)} "
          f"GiB, peak {peak_gib if peak_gib is None else round(peak_gib, 2)} "
          f"GiB ({smi})")
    for i, r in enumerate(log):
        print(f"  step {i + 1}: loss {r['loss']:.4f} nll {r['nll']:.4f} "
              f"grad_norm {r['grad_norm']:.4f} lr {r['lr']:.3e} "
              f"{r['ms']:.1f} ms (data {r['data_ms']:.1f} ms) ({smi})")
    print(f"  median step {med_ms:.1f} ms, {tokens / med_ms * 1e3:.0f} "
          f"tokens/s; bound {bnd['bound_ms']:.1f} ms ({bnd['flops']:.4e} "
          f"FLOP at {bnd['peak_flops']:.3g}/s: 6 N T {bnd['dense_flops']:.4e}"
          f", plain attention {bnd['attention_flops']:.4e}, remat's blocks "
          f"{bnd['remat_block_flops']:.4e}), share {bnd['bound_ms'] / med_ms:.3f}"
          f" ({smi})")
    print("  a step split, each part timed alone: " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items())
        + f"; the pipeline's first batch (its table) {data_first_s:.2f} s "
        f"({smi})")
    if kernels is None or not kernels["busy_ms"]:
        print("  one microbatch's device kernels: not measured")
    else:
        print(f"  one microbatch's forward and backward under the profiler: "
              f"{kernels['wall_ms']:.1f} ms, device busy "
              f"{kernels['busy_ms']:.1f} ms; by kernel (ms): " + "; ".join(
                  f"{k['name'][:60]} {k['ms']:.1f} x{k['calls']}"
                  for k in kernels["top"]) + f" ({smi})")
    print(f"  kernel launches {sum(launches.values())}, routes {routes} "
          f"(want plain {want_plain}); one block's grads with remat vs "
          f"without: rel_l2 {max(remat_errs):.3e}, "
          f"{'equal' if remat_bits else 'not equal'} to the bit")
    print(f"  drill {drill_s:.1f} s: SIGTERM at {drill['signalled_at_s']} s,"
          f" preempted at {stopped}, resumed at {resumed}; step "
          f"{DRILL_STEPS} loss rel diff {loss_diff}, leaves rel diff "
          f"{leaf_diff}, {'equal' if bits else 'not equal'} to the bit; runs "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in runs.items()))
    print(f"  reduced step on {device} vs host: loss {losses['device']:.6f} "
          f"vs {losses['host']:.6f} (rel {card_loss_err:.3e}), worst grad "
          f"{worst} rel_l2 {card_grad_errs[worst]:.3e} ({smi})")
    del host_model, dev_model
    if cuda:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: phase 13 ``dist`` (``dist_check``): (a) one train step of qwen3-8b at
#: its published widths cut to ``DIST_STEP_LAYERS`` layers over one
#: sequence of ``DIST_STEP_SEQ`` tokens, its parameters placed by
#: ``param_shardings`` on a one-rank (data, model) mesh, against the same
#: step unsharded, within phase 12's card-vs-host bounds (``CARD_LOSS_TOL``,
#: ``CARD_GRAD_TOL``); (b) a prefill at ``DIST_PREFILL_LAYERS`` layers of
#: a ``DIST_PREFILL_SEQ``-token prompt on that mesh, attention on the
#: flash kernel through each rank's local shards (one launch a layer),
#: against the unsharded model's logits (``LM_TOL``), then under the
#: ``--opt`` plan with ``DIST_DECODE_STEPS`` decode steps after it, each
#: step's cache rows written by the scatter route in a local region,
#: against the unsharded plain model's decode (``LM_TOL``)
DIST_STEP_LAYERS, DIST_STEP_SEQ = 2, 4096
DIST_PREFILL_LAYERS, DIST_PREFILL_SEQ = 4, 2048
DIST_DECODE_STEPS = 2
#: (d): the dry run's cell and depth: qwen3-8b's train_4k on the fake 16 x
#: 16 mesh, cut to ``DRYRUN_LAYERS`` of 36 layers for the phase's time
#: (its trace of all 36 layers and 16 microbatches takes minutes), with
#: ``--audit``: the collectives DTensor issued on its own and the calls of
#: its Shard-to-Shard step, which must both be none
DRYRUN_ARGS = ("--arch", "qwen3-8b", "--shape", "train_4k", "--audit")
DRYRUN_LAYERS = 2
#: (d) beside it, each at one layer and audited alike:
#: deepseek-coder-33b's train_4k under the ``--opt`` plan (56 heads on 16:
#: attention over the sequence, in the port's own region),
#: deepseek-v2-236b's (MLA, and the MoE whose input gradient is reduced
#: once a layer: its all-reduce bytes printed) and its decode (MLA's cache
#: write and scores on their own shards), qwen3-8b's decode under the
#: ``--opt`` plan (the scatter write on a sharded cache), rwkv6-1.6b's
#: long_500k on the two-pod mesh (its one-token recurrence in a region)
#: and its prefill_32k (its recurrence traced one chunk for all: the
#: trace's seconds printed)
DRYRUN_MORE = (
    (("--arch", "deepseek-coder-33b", "--shape", "train_4k", "--opt",
      "--audit"), 1),
    (("--arch", "deepseek-v2-236b", "--shape", "train_4k", "--audit"), 1),
    (("--arch", "qwen3-8b", "--shape", "decode_32k", "--opt", "--audit"),
     1),
    (("--arch", "deepseek-v2-236b", "--shape", "decode_32k", "--audit"), 1),
    (("--arch", "rwkv6-1.6b", "--shape", "long_500k", "--multi-pod",
      "--audit"), 1),
    (("--arch", "rwkv6-1.6b", "--shape", "prefill_32k", "--audit"), 1))


def start_dry_runs(runs=None) -> dict:
    """Start phase 13 (d)'s dry runs, ``runs`` ((args, layers) pairs;
    default ``DRYRUN_ARGS`` at ``DRYRUN_LAYERS`` and ``DRYRUN_MORE``), one
    ``python -m repro_torch.launch.dryrun`` subprocess each, all now, each
    writing its JSON under a temporary directory; :func:`dist_check` waits
    for them.  They run on the host's cores alone (a fake process group,
    no device), so main starts them while the card, not the host, is
    busy."""
    from concurrent.futures import ThreadPoolExecutor
    runs = runs or [(DRYRUN_ARGS, DRYRUN_LAYERS), *DRYRUN_MORE]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun")
    atexit.register(shutil.rmtree, out, True)

    def dry_run(i, args, layers):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
               "--layers", str(layers), "--out", str(Path(out) / str(i))]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=600)
        return cmd, r, time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(runs))
    futures = [pool.submit(dry_run, i, tuple(args), layers)
               for i, (args, layers) in enumerate(runs)]
    pool.shutdown(wait=False)
    return {"futures": futures, "out": out, "started": time.perf_counter()}


def dist_check(smi: str, counts, zero_counts, failures: list[str], *,
               cfg=None, device: str = "cuda",
               step_layers: int = DIST_STEP_LAYERS,
               step_seq: int = DIST_STEP_SEQ,
               prefill_layers: int = DIST_PREFILL_LAYERS,
               prefill_seq: int = DIST_PREFILL_SEQ,
               decode_steps: int = DIST_DECODE_STEPS,
               train: dict | None = None,
               roof_cfg=None, roof_batch: int = TRAIN_BATCH,
               roof_micro: int = TRAIN_MICRO, dryruns: dict) -> dict:
    """Distribution, the roofline and the dry run.  (a) and (b) as the
    constants above say, on ``cfg`` (default ``DIST_ARCH``) made on
    ``device`` from seed 0, on ``launch.mesh.make_host_mesh``'s one-rank
    mesh (NCCL on the card: a failed init fails the run); every kernel's
    count set to 0 just before each sharded run and read just after: (a)
    launches nothing (training attention is plain), (b) launches the
    flash kernel once a layer, under the plain plan and again under the
    ``--opt`` plan, whose decode steps launch nothing.  (c) The roofline of phase 12's exact step
    (``roof_cfg``, default ``TRAIN_ARCH`` at ``TRAIN_LAYERS`` layers, 4 x
    4096 tokens in 4 microbatches), traced on fake tensors on ``device``
    (``launch.steps.lower_cell``): its three terms, bound and useful-FLOPs
    ratio, and ``train``'s measured median step (phase 12's) over the
    ideal overlapped time, beside phase 12's hand-reckoned bound.  (d) The
    dry run's CLI (``python -m repro_torch.launch.dryrun``) on its fake 16
    x 16 mesh, the runs :func:`start_dry_runs` started (``dryruns``),
    each JSON read back: it fails where DTensor issued any collective on its own (an
    all-gather, an all-to-all or any other, outside the port's regions
    and redistributions) or its Shard-to-Shard step ran.  Prints each
    number beside ``smi`` and the torch version; returns what it
    measured."""
    import dataclasses
    import math

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (lower_cell, optimize_config,
                                          plan_cell)
    from repro_torch.models import build_model
    from repro_torch.models.attention import ROUTES
    from repro_torch.quickstart import rel_l2
    from repro_torch.roofline import analyze_trace, model_flops
    from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                             init_opt_state)
    t_phase = time.perf_counter()
    base = cfg or ARCHS[TRAIN_ARCH]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gib = 2.0 ** 30

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(f"dist: {msg}")

    def placed_twin(c, ref):
        """A model of config ``c`` with ``ref``'s weights, its parameters
        placed by their specs on the mesh."""
        sh = build_model(c)
        sh.to_empty(device=dev)
        sh.load_state_dict(ref.state_dict())
        shd.place_params(sh, shd.param_shardings(
            dict(sh.named_parameters()), sh.param_axes(), mesh), mesh)
        return sh

    def twins(layers: int):
        """A model at ``layers`` layers from seed 0 and a copy of it whose
        parameters are placed by their specs on the mesh."""
        c = dataclasses.replace(base, n_layers=layers)
        ref = build_model(c).init(0, dev)
        return c, ref, placed_twin(c, ref)

    def grown(caches, rows: int):
        """Prefill ``caches`` with ``rows`` empty cache rows after the
        prompt's (the attention caches' dim 1; on the one-rank mesh a
        DTensor's local shard is the whole), as a serving engine's caches
        have room for the tokens to come."""
        def pad(t):
            if isinstance(t, DTensor):
                return DTensor.from_local(pad(t.to_local()), t.device_mesh,
                                          t.placements)
            return torch.cat([t, t.new_zeros((t.shape[0], rows,
                                              *t.shape[2:]))], dim=1)
        return [{k: {n: pad(t) for n, t in v.items()} if k == "attn" else v
                 for k, v in c.items()} for c in caches]

    def placed(batch):
        return {k: shd.place(v, shd.batch_spec(tuple(v.shape), mesh), mesh)
                for k, v in batch.items()}

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=dev)
    mesh_s = time.perf_counter() - t0
    backend = dist.get_backend()

    # (a) a sharded train step against the unsharded one
    t0 = time.perf_counter()
    ca, ref, sh = twins(step_layers)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_pipeline(
        DataConfig(vocab=ca.vocab, seq_len=step_seq, global_batch=1))
        .batch_at(0).items()}
    opt_cfg = OptimizerConfig(total_steps=4, warmup_steps=1)
    loss_u, _ = ref.train_loss(batch)
    loss_u.backward()
    zero_counts()
    ROUTES.clear()
    with shd.use_mesh(mesh):
        loss_s, _ = sh.train_loss(placed(batch))
        loss_s.backward()
    launches_a, routes_a = counts(), dict(ROUTES)
    loss_a = (float(loss_u.detach()), float(loss_s.detach().full_tensor()))
    loss_err = abs(loss_a[1] - loss_a[0]) / abs(loss_a[0])
    grad_errs = {n: rel_l2(p.grad.full_tensor().float(),
                           ref.get_parameter(n).grad.float())
                 for n, p in sh.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    updates = {}
    for name, m_ in (("unsharded", ref), ("sharded", sh)):
        params = dict(m_.named_parameters())
        state = init_opt_state(opt_cfg, params)
        with shd.use_mesh(mesh) if name == "sharded" else \
                contextlib.nullcontext():
            apply_updates(opt_cfg, params, state,
                          {k: p.grad for k, p in params.items()})
        updates[name] = state["master"]
    update_err = max(rel_l2(updates["sharded"][k].full_tensor(),
                            updates["unsharded"][k])
                     for k in updates["unsharded"])
    step_s = time.perf_counter() - t0
    check(all(v == 0 for v in launches_a.values()),
          f"(a) kernels launched by the sharded train step: {launches_a}")
    check(loss_err <= CARD_LOSS_TOL,
          f"(a) sharded loss {loss_a[1]} vs unsharded {loss_a[0]}: rel "
          f"{loss_err:.3e} > {CARD_LOSS_TOL:g}")
    check(grad_errs[worst] <= CARD_GRAD_TOL and update_err <= CARD_GRAD_TOL,
          f"(a) sharded grads vs unsharded: {worst} rel_l2 "
          f"{grad_errs[worst]:.3e}, updated masters {update_err:.3e} > "
          f"{CARD_GRAD_TOL:g}")
    placements = {str(p.placements) for p in sh.parameters()}
    del ref, sh, updates, batch, loss_u, loss_s
    if cuda:
        torch.cuda.empty_cache()

    # (b) a sharded prefill with attention on the kernel
    t0 = time.perf_counter()
    cb, ref, sh = twins(prefill_layers)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cb.vocab, (1, prefill_seq)), device=dev)
    want = ref.prefill({"tokens": tokens})[0]
    zero_counts()
    ROUTES.clear()
    with shd.use_mesh(mesh):
        got = sh.prefill(placed({"tokens": tokens}))[0]
    launches_b, routes_b = counts(), dict(ROUTES)
    prefill_err = rel_l2(got.full_tensor().float(), want.float())
    prefill_s = time.perf_counter() - t0
    want_launch = prefill_layers if cuda else 0
    check(launches_b.get("flash_attention", 0) == want_launch and sum(
        launches_b.values()) == want_launch,
          f"(b) sharded prefill launches {launches_b}, want flash_attention "
          f"{want_launch}")
    check(prefill_err <= LM_TOL,
          f"(b) sharded prefill logits vs unsharded: rel_l2 "
          f"{prefill_err:.3e} > {LM_TOL:g}")
    del sh, got

    # (b) under the --opt plan: the prefill and decode steps, whose cache
    # rows the scatter route writes on the mesh, against the unsharded
    # plain model's
    t0 = time.perf_counter()
    c_opt = optimize_config(cb, mesh)
    sh = placed_twin(c_opt, ref)
    nxt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cb.vocab, (1, decode_steps)), device=dev)
    with torch.no_grad():
        _, caches, _ = ref.prefill({"tokens": tokens})
        caches = grown(caches, decode_steps)
        want_dec = []
        for i in range(decode_steps):
            lg, caches = ref.decode_step(caches, nxt[:, i:i + 1],
                                         prefill_seq + i)
            want_dec.append(lg)
    zero_counts()
    ROUTES.clear()
    with shd.use_mesh(mesh), torch.no_grad():
        got_pre, caches, _ = sh.prefill(placed({"tokens": tokens}))
        caches = grown(caches, decode_steps)
        got_dec = []
        for i in range(decode_steps):
            lg, caches = sh.decode_step(
                caches, placed({"t": nxt[:, i:i + 1]})["t"], prefill_seq + i)
            got_dec.append(lg)
    launches_o, routes_o = counts(), dict(ROUTES)
    opt_prefill_err = rel_l2(got_pre.full_tensor().float(), want.float())
    decode_errs = [rel_l2(g.full_tensor().float(), w.float())
                   for g, w in zip(got_dec, want_dec)]
    decode_s = time.perf_counter() - t0
    check(c_opt.opt_scatter_cache and c_opt.opt_attn,
          f"(b) the --opt plan's config {c_opt}")
    check(launches_o.get("flash_attention", 0) == want_launch and sum(
        launches_o.values()) == want_launch,
          f"(b) --opt prefill and decode launches {launches_o}, want "
          f"flash_attention {want_launch}")
    check(opt_prefill_err <= LM_TOL and max(decode_errs) <= LM_TOL,
          f"(b) --opt prefill and decode logits vs unsharded plain: rel_l2 "
          f"{opt_prefill_err:.3e}, {decode_errs} > {LM_TOL:g}")
    del ref, sh, want, caches, got_pre, got_dec, want_dec
    dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()

    # (c) the roofline of phase 12's step, traced on fake tensors
    t0 = time.perf_counter()
    cc = roof_cfg or dataclasses.replace(ARCHS[TRAIN_ARCH],
                                         n_layers=TRAIN_LAYERS)
    plan = plan_cell(cc, "train_4k", shd.AbstractMesh((1, 1),
                                                      ("data", "model")),
                     opt_cfg=OptimizerConfig(total_steps=TRAIN_STEPS,
                                             warmup_steps=1),
                     microbatches=roof_micro, global_batch=roof_batch)
    trace = lower_cell(plan, None, device=dev)
    roof_seq = SHAPES["train_4k"]["seq_len"]
    rep = analyze_trace(trace, chips=1, arch=cc.name, shape="train_4k",
                        mesh=f"1 (batch {roof_batch})",
                        model_flops_value=model_flops(cc, {
                            "kind": "train", "global_batch": roof_batch,
                            "seq_len": roof_seq}))
    roof_s = time.perf_counter() - t0
    roof = dict(rep.to_dict(), trace_s=trace.seconds, ops=trace.ops,
                seconds=roof_s)
    measured = train["step_ms_median"] if train else None
    hand = train["bound"]["bound_ms"] if train else None
    if measured is not None:
        roof["measured_over_overlap"] = measured / (rep.t_total_overlap * 1e3)
    check(all(math.isfinite(v) and v > 0 for v in (
        rep.t_compute, rep.t_memory)) and rep.t_collective == 0.0,
          f"(c) roofline terms {rep.t_compute}, {rep.t_memory}, "
          f"{rep.t_collective}")

    # (d) the dry run's CLI on its fake 16 x 16 mesh, the cells at once
    dries = []
    t_wait = time.perf_counter()
    for future in dryruns["futures"]:
        cmd, r, dry_s = future.result()
        files = list(Path(cmd[-1]).glob("*.json"))
        check(r.returncode == 0 and len(files) == 1,
              f"(d) dry run {cmd[3:]} exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        dry = json.loads(files[0].read_text()) if files else {}
        audit = dry.get("collective_audit")
        check(not dry or (audit is not None
                          and audit["shard_dim_alltoall"] == 0
                          and not audit["dtensor_coll_by_op"]),
              f"(d) {cmd[3:]}: collectives the port did not issue "
              f"itself: {audit}")
        dries.append({"cmd": cmd[1:], "seconds": dry_s, "json": dry})
    wait_s = time.perf_counter() - t_wait
    shutil.rmtree(dryruns["out"], ignore_errors=True)

    out = {
        "backend": backend, "mesh_s": mesh_s,
        "step": {"layers": step_layers, "seq": step_seq, "loss": loss_a,
                 "loss_rel": loss_err, "grad_rel_l2_max": grad_errs[worst],
                 "grad_worst": worst, "update_rel_l2_max": update_err,
                 "launches": launches_a, "routes": routes_a,
                 "placements": sorted(placements), "seconds": step_s},
        "prefill": {"layers": prefill_layers, "seq": prefill_seq,
                    "rel_l2": prefill_err, "launches": launches_b,
                    "routes": routes_b, "seconds": prefill_s},
        "opt_decode": {"steps": decode_steps,
                       "prefill_rel_l2": opt_prefill_err,
                       "decode_rel_l2": decode_errs, "launches": launches_o,
                       "routes": routes_o, "seconds": decode_s},
        "roofline": roof, "hand_bound_ms": hand, "measured_step_ms": measured,
        "dryrun": dries[0], "dryrun_more": dries[1:],
        "dryrun_wait_s": wait_s,
        "dryrun_ahead_s": t_wait - dryruns["started"],
        "launches": launches_b.get("flash_attention", 0),
        "opt_launches": launches_o.get("flash_attention", 0),
        "nvidia_smi": smi,
    }
    print(f"  mesh {dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))} on "
          f"{backend} in {mesh_s:.2f} s ({smi})")
    print(f"  (a) {ca.name} at {step_layers} layers, {step_seq} tokens: loss "
          f"sharded {loss_a[1]:.6f} vs {loss_a[0]:.6f} (rel {loss_err:.3e}), "
          f"worst grad {worst} rel_l2 {grad_errs[worst]:.3e}, updated "
          f"masters {update_err:.3e}; launches {sum(launches_a.values())}, "
          f"routes {routes_a}; {step_s:.1f} s ({smi})")
    print(f"  (b) prefill at {prefill_layers} layers, {prefill_seq} tokens: "
          f"logits rel_l2 {prefill_err:.3e}; flash launches "
          f"{launches_b.get('flash_attention', 0)}, routes {routes_b}; "
          f"{prefill_s:.1f} s ({smi})")
    print(f"  (b) --opt plan: prefill logits rel_l2 {opt_prefill_err:.3e}, "
          f"{decode_steps} decode steps (scatter cache writes) rel_l2 "
          + ", ".join(f"{e:.3e}" for e in decode_errs)
          + f" vs the unsharded plain model; flash launches "
          f"{launches_o.get('flash_attention', 0)}, routes {routes_o}; "
          f"{decode_s:.1f} s ({smi})")
    print(f"  (c) roofline of phase 12's step ({cc.n_layers} layers, "
          f"{roof_batch} x {roof_seq} tokens in {roof_micro} microbatches, "
          f"traced in {trace.seconds:.1f} s, {trace.ops} ops): compute "
          f"{rep.t_compute * 1e3:.1f} ms ({rep.flops_per_chip:.4e} FLOP), "
          f"memory {rep.t_memory * 1e3:.1f} ms ({rep.hbm_bytes_per_chip:.4e}"
          f" B), collective {rep.t_collective * 1e3:.1f} ms; bound "
          f"{rep.bound}, useful_flops {rep.useful_flops_ratio:.3f}, peak "
          f"{rep.peak_memory_per_chip / gib:.2f} GiB; measured median step "
          f"{measured} ms = {roof.get('measured_over_overlap')} x "
          f"t_total_overlap {rep.t_total_overlap * 1e3:.1f} ms; phase 12's "
          f"hand bound {hand} ms; torch {torch.__version__} ({smi})")
    for run in dries:
        dry = run["json"]
        if not dry:
            continue
        audit = dry.get("collective_audit") or {}
        coll = dry["coll_by_op"]
        print(f"  (d) dry run {dry.get('arch')} {dry.get('shape')} "
              f"{dry.get('mesh')} at {dry.get('n_layers')} layers, "
              f"{dry.get('microbatches')} microbatches: compute "
              f"{dry['t_compute'] * 1e3:.3f} ms, memory "
              f"{dry['t_memory'] * 1e3:.3f} ms, collective "
              f"{dry['t_collective'] * 1e3:.3f} ms ({coll}; all-reduce "
              f"{coll.get('all-reduce', 0.0) / 1e9:.9f} GB, all-to-all "
              f"{coll.get('all-to-all', 0.0) / 1e9:.9f} GB a chip; "
              f"DTensor's own {audit.get('dtensor_coll_by_op')}, its "
              f"Shard-to-Shard steps {audit.get('shard_dim_alltoall')}); "
              f"bound {dry['bound']}, mfu {dry['mfu']:.4f}, useful_flops "
              f"{dry['useful_flops_ratio']:.3f}, peak "
              f"{dry['peak_memory_per_chip'] / gib:.2f} GiB per chip; trace "
              f"{dry['compile_s']:.1f} s, {run['seconds']:.1f} s with the "
              f"process; torch {dry.get('torch_version')} ({smi})")
    print(f"  (d) the dry runs started {out['dryrun_ahead_s']:.1f} s before "
          f"this phase's wait for them, which took {wait_s:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: phase 14 ``families`` (``families_check``): the nine model families
#: besides qwen3-8b at their published widths (d_model, heads, d_ff,
#: experts, vocab, window, latent dims), cut in depth only (PERF.md
#: section 4).  A family's row: the layers it is served at, the layers one
#: training step takes (None: none at its published widths fits the card),
#: the prompts the flash kernel takes (``attention_routes``) and those
#: that run the plain route.  A MoE prompt is a whole number of the
#: router's 128-token groups or at most one (the reference's
#: ``x.reshape(g, gs, d)``); deepseek-v2-236b's plain MLA scores take
#: 128 x T^2 x 4 B a layer (2.1 GiB at 2048), so its prompts stop there;
#: RWKV-6 and RG-LRU run a Python loop a token, so theirs stop at 1024;
#: gemma3-27b's 2048 outgrows its 1024-row ring buffers.  Depths: one
#: whole period of the pattern at least where serving (gemma3-27b 6,
#: recurrentgemma-9b 3), and for training what 16 B a parameter (bf16
#: weight and grad, f32 master, m and v) leaves room for under
#: ``FAMILY_BUDGET_GIB``; deepseek-v2-236b's one layer with its 160
#: experts would need 67.0 GiB of state.  RWKV-6's step is the phase's
#: longest: its recurrence steps a token at a time forward, in remat's
#: recompute and backward (one layer of 2048 tokens 6.3 s on an NVIDIA
#: H100 80GB HBM3 at 700.00 W, PERF.md section 6, PR 30); its depth is
#: the first to cut should the phase outgrow its 120 s
Family = collections.namedtuple("Family", "serve train kernel plain")
FAMILIES = {
    "granite-moe-3b-a800m": Family(32, 8, (512, 2048), (100,)),
    "deepseek-v2-236b": Family(2, None, (), (512, 2048)),
    "deepseek-coder-33b": Family(4, 2, (512, 2048), (100,)),
    "qwen3-14b": Family(4, 2, (512, 2048), (100,)),
    "internvl2-26b": Family(4, 2, (512, 2048), (100,)),
    "gemma3-27b": Family(6, 1, (), (512, 2048)),
    "recurrentgemma-9b": Family(3, 3, (), (512, 1024)),
    "rwkv6-1.6b": Family(4, 4, (), (512, 1024)),
    "whisper-medium": Family(24, 24, (512, 2048), (100,)),
}
#: what a family's bf16 parameters (serving) or 16 B a parameter
#: (training) may take of the card's 80 GB, the rest left to the cache,
#: the f32 head and the activations
FAMILY_BUDGET_GIB = 40.0
#: (a): 4 slots (``LM_SLOTS``), 8 new tokens a request, room for the
#: longest prompt and its tokens
FAMILY_NEW = 8
FAMILY_MAX_LEN = 2048 + FAMILY_NEW
#: (a), internvl2-26b: one ``Model.forward(make_cache=True)`` of 256
#: patches before 1792 text tokens, 2048 positions on the vision-prefix
#: path (the engine takes no patches, as the JAX engine takes none)
VISION_PATCHES, VISION_TEXT = 256, 1792
#: (b): one microbatch of one 2048-position sequence a step (whisper:
#: 2048 frames and its 448 decoder tokens; internvl2: 256 patches and
#: 1792 tokens, as ``launch/steps.py`` ``input_specs``), remat on
FAMILY_SEQ = 2048
#: (d): every arch of ``configs.ARCHS`` at ``reduce_config``, card against
#: host on the same weights and inputs: a prefill of ``REDUCED_PROMPT``
#: tokens (three of the reduced MoE's 16-token groups; past the reduced
#: 32-row window), ``REDUCED_DECODE`` decode steps through a serving
#: engine's slot, fed the host's f32 greedy tokens, and one train step on
#: ``REDUCED_BATCH`` sequences (whisper's of ``REDUCED_FRAMES`` frames)
REDUCED_PROMPT, REDUCED_DECODE, REDUCED_BATCH, REDUCED_FRAMES = 48, 2, 2, 64
REDUCED_SEED = 11
#: in f32 (``torch.bfloat16`` aliased to ``torch.float32`` in the run's
#: process before ``repro_torch`` is imported; TF32 off), the card's
#: logits, loss (relative) and each parameter's gradient within
#: ``REDUCED_F32_TOL`` rel-L2 of the host's: both compute the same f32
#: ops and differ only in their summation order
REDUCED_F32_TOL = 1e-4
#: in bf16, each within ``ROUND_FACTOR`` times the host's own bf16 run's
#: distance from its f32 run, plus ``ROUND_TOL``: the bound the families
#: test puts on the sharded step (``tests/test_torch_distributed_families
#: .py``), since bf16 rounding alone moves these reduced steps far from
#: f32 (RWKV-6's gradients 0.195-6.86, PERF.md section 6, PR 28)
ROUND_FACTOR, ROUND_TOL = 5.0, 5e-2
#: torch threads of each host run of (d): they share the host's cores
#: with the dry runs
REDUCED_THREADS = 2


def family_config(arch: str, layers: int):
    """``arch``'s published config cut to ``layers`` decoder layers (an
    encoder keeps its own depth)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch], n_layers=layers)


def family_batch(cfg, seq: int) -> dict:
    """One training sequence of ``seq`` positions for ``cfg`` from the
    synthetic pipeline (seed 0): tokens and labels, with whisper's ``seq``
    frames before its 448 decoder tokens, or internvl2's patches before
    ``seq`` minus ``n_patches`` tokens, from numpy seed 3."""
    import numpy as np

    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.steps import WHISPER_DEC_LEN
    rng = np.random.default_rng(3)
    extra = {}
    text = seq
    if cfg.frontend == "audio":
        text = WHISPER_DEC_LEN
        extra["frames"] = rng.standard_normal(
            (1, seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        text = seq - cfg.n_patches
        extra["patches"] = rng.standard_normal(
            (1, cfg.n_patches, cfg.d_model)).astype(np.float32)
    batch = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=text,
                                     global_batch=1)).batch_at(0)
    return dict(batch, **extra)


def family_train(cfg, seq: int, dev, counts, zero_counts,
                 failures: list[str], tag: str) -> dict:
    """One step of ``make_train_step`` (one microbatch, remat as ``cfg``
    says) of ``cfg`` made on ``dev`` from seed 0 over :func:`family_batch`:
    the counts set to 0 just before it and read just after (training
    attention runs the plain route: nothing launches), the loss and grad
    norm finite and the nll not below ln(vocab) - 1."""
    import math

    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.attention import ROUTES
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cuda = dev.type == "cuda"
    gib = 2.0 ** 30
    base_gib = fresh_peak(dev)
    t0 = time.perf_counter()
    model = build_model(cfg).init(0, dev)
    params = dict(model.named_parameters())
    opt_cfg = OptimizerConfig(total_steps=1, warmup_steps=1)
    state = init_opt_state(opt_cfg, params)
    if cuda:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in family_batch(cfg, seq).items()}
    step = make_train_step(model, opt_cfg, 1)
    zero_counts()
    ROUTES.clear()
    t0 = time.perf_counter()
    state, m = step(model, state, batch)
    m = {k: float(v) for k, v in m.items()}       # waits for the step
    ms = (time.perf_counter() - t0) * 1e3
    launches, routes = counts(), dict(ROUTES)
    peak = torch.cuda.max_memory_allocated(dev) / gib if cuda else None
    floor = math.log(cfg.vocab) - 1.0
    failures.extend(f"{tag}: train {msg}" for ok, msg in [
        (all(v == 0 for v in launches.values()),
         f"launched kernels {launches}"),
        (set(routes) <= {"plain"}, f"attention routes {routes}"),
        (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
         f"loss {m['loss']}, grad norm {m['grad_norm']}"),
        (m["nll"] >= floor, f"first nll {m['nll']:.4f} below ln(V) - 1 = "
                            f"{floor:.4f}"),
    ] if not ok)
    del model, params, state, step, batch
    if cuda:
        torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "params": n_params,
            "param_gib": n_params * 2 / gib, "state_gib": n_params * 16 / gib,
            "init_s": init_s, "step_ms": ms, "loss": m["loss"],
            "nll": m["nll"], "grad_norm": m["grad_norm"],
            "launches": sum(launches.values()), "routes": routes,
            "allocated_before_gib": base_gib,
            "max_memory_allocated_gib": peak}


def vision_check(cfg, dev, counts, zero_counts, failures: list[str],
                 tag: str, patches: int = VISION_PATCHES,
                 text: int = VISION_TEXT) -> dict:
    """internvl2's vision-prefix path: one ``Model.forward(make_cache=
    True)`` of ``patches`` patch embeddings before ``text`` tokens (made on
    ``dev`` from seed 0, inputs from numpy seed 4), the counts set to 0
    just before and read just after: attention launched as
    :func:`attention_routes` says at ``patches + text`` positions on the
    card (none on the host), nothing else; logits finite, the caches of
    every position; the last logits within ``LM_TOL`` of the plain
    route's."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.quickstart import rel_l2
    rng = np.random.default_rng(4)
    batch = {"patches": torch.as_tensor(rng.standard_normal(
                 (1, patches, cfg.d_model)).astype(np.float32), device=dev),
             "tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab, (1, text)), device=dev)}
    model = build_model(cfg).init(0, dev)
    zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _, (caches, _) = model.forward(batch, make_cache=True)
        logits = logits[0, -1].float()
        finite = bool(torch.isfinite(logits).all())
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    with torch.no_grad():
        plain = model.with_attention_impl("plain").forward(batch)[0][0, -1]
    err = rel_l2(logits, plain.float())
    want = {name: 0 for name in launches}
    want["flash_attention"] = attention_routes(cfg, patches + text)[
        "kernel"] if dev.type == "cuda" else 0
    rows = {int(c["attn"]["k"].shape[1]) for c in caches}
    failures.extend(f"{tag}: vision prefix {msg}" for ok, msg in [
        (launches == want, f"launches {launches}, want {want}"),
        (finite, "logits not finite"),
        (rows == {patches + text}, f"cache rows {rows}"),
        (err <= LM_TOL, f"kernel vs plain route rel_l2 {err:.3e} > "
                        f"{LM_TOL:g}"),
    ] if not ok)
    del model, caches
    return {"patches": patches, "text": text, "ms": ms,
            "launches": launches["flash_attention"], "rel_l2": err}


def reduced_run(device: str, tokens: dict | None = None) -> dict:
    """Part (d)'s one side: each arch of ``configs.ARCHS`` at its reduced
    config with ``init(0)``'s weights made on the CPU and copied to
    ``device``: a prefill of ``REDUCED_PROMPT`` tokens (whisper's
    ``REDUCED_FRAMES`` frames, internvl2's patches before them) spliced
    into the one slot of a ``ServingEngine``, and ``REDUCED_DECODE`` decode
    steps through it fed ``tokens[arch]`` (None: this run's own greedy
    tokens); then one train step's loss and gradients over
    ``REDUCED_BATCH`` sequences, three labels masked.  Inputs from numpy
    seed ``REDUCED_SEED``.  Returns, by arch, the prefill's and each
    step's logits, the tokens fed, this run's argmax after each, the loss
    and every parameter's gradient, in f32 on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serve.decode import ServeConfig, ServingEngine
    dev = torch.device(device)
    out = {}
    for arch in ARCHS:
        cfg = reduce_config(ARCHS[arch])
        model = build_model(cfg).init(0, "cpu")
        if dev.type != "cpu":
            state = model.state_dict()
            model = build_model(cfg)
            model.to_empty(device=dev)
            model.load_state_dict(state)
        rng = np.random.default_rng(REDUCED_SEED)
        n, b = REDUCED_PROMPT, REDUCED_BATCH
        batch = {k: rng.integers(0, cfg.vocab, (b, n)) for k in ("tokens",
                                                                 "labels")}
        batch["labels"][0, :3] = -1
        prefix = 0
        if cfg.frontend == "audio":
            batch["frames"] = rng.standard_normal(
                (b, REDUCED_FRAMES, cfg.d_model)).astype(np.float32)
        elif cfg.frontend == "vision":
            prefix = cfg.n_patches
            batch["patches"] = rng.standard_normal(
                (b, prefix, cfg.d_model)).astype(np.float32)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        engine = ServingEngine(model, ServeConfig(
            n_slots=1, max_len=prefix + n + REDUCED_DECODE,
            max_new_tokens=REDUCED_DECODE))
        with torch.no_grad():
            logits, caches, enc = model.prefill(
                {k: v[:1] for k, v in batch.items() if k != "labels"})
            engine._splice(caches, 0)
            cache, outs = engine.cache, [logits[0]]
            own = [int(logits[0].argmax())]
            fed = list(tokens[arch]) if tokens else []
            for i in range(REDUCED_DECODE):
                if not tokens:
                    fed.append(own[-1])
                logits, cache = model.decode_step(
                    cache, torch.tensor([[fed[i]]], device=dev),
                    prefix + n + i, enc_out=enc)
                outs.append(logits[0])
                own.append(int(logits[0].argmax()))
        loss, _ = model.train_loss(batch)
        loss.backward()
        out[arch] = {"logits": [o.float().cpu() for o in outs],
                     "tokens": fed, "argmax": own,
                     "loss": float(loss.detach()),
                     "grads": {k: p.grad.float().cpu()
                               for k, p in model.named_parameters()
                               if p.grad is not None}}
        del model, engine, cache, caches
    return out


def reduced_main(device: str, out: str, f32: bool,
                 tokens: str | None) -> int:
    """``--reduced-run``: :func:`reduced_run` on ``device`` in this process,
    saved to ``out`` (``torch.save``); with ``f32``, ``torch.bfloat16``
    aliased to ``torch.float32`` before ``repro_torch`` is imported, so
    that every bf16 of the port (the port has no dtype setting; defaults
    such as the parameters' dtype are bound at import) is computed in f32;
    ``tokens``: a JSON file of the tokens to feed each arch's decode
    steps."""
    import unittest.mock

    import torch
    alias = unittest.mock.patch.object(torch, "bfloat16", torch.float32)
    if f32:
        alias.start()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(REDUCED_THREADS)
    fed = json.loads(Path(tokens).read_text()) if tokens else None
    t0 = time.perf_counter()
    res = reduced_run(device, fed)
    if f32:
        alias.stop()        # the file's own dtypes are torch's again
    torch.save({"runs": res, "seconds": time.perf_counter() - t0}, out)
    return 0


def _reduced_cmd(device: str, out: Path, f32: bool,
                 tokens: Path | None = None) -> list[str]:
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--reduced-run",
            device, "--out", str(out)] + (["--f32"] if f32 else []) \
        + (["--tokens", str(tokens)] if tokens else [])


def _run_reduced(cmd: list[str]) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=900)
    return {"cmd": cmd[2:], "rc": r.returncode, "stderr": r.stderr[-3000:],
            "seconds": time.perf_counter() - t0}


def start_reduced_runs() -> dict:
    """Start part (d)'s host half now, in a thread: the reduced archs in
    f32 on the CPU (greedy: their tokens are the ones every other run of
    (d) is fed), then in bf16 fed those tokens, each a subprocess of
    :func:`reduced_main`.  They need the host's cores alone, so main
    starts them beside the dry runs; :func:`families_check` collects
    them."""
    from concurrent.futures import ThreadPoolExecutor
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_reduced"))
    atexit.register(shutil.rmtree, work, True)

    def host():
        runs = [_run_reduced(_reduced_cmd("cpu", work / "host_f32.pt",
                                          True))]
        if runs[0]["rc"] == 0:
            import torch
            got = torch.load(work / "host_f32.pt")["runs"]
            (work / "tokens.json").write_text(json.dumps(
                {a: r["tokens"] for a, r in got.items()}))
            runs.append(_run_reduced(_reduced_cmd(
                "cpu", work / "host_bf16.pt", False, work / "tokens.json")))
        return runs

    pool = ThreadPoolExecutor(1)
    future = pool.submit(host)
    pool.shutdown(wait=False)
    return {"future": future, "dir": work, "started": time.perf_counter()}


def reduced_compare(runs: dict) -> dict:
    """Part (d)'s distances, by arch: the card's f32 run against the
    host's (``card_f32``, ``host_f32``: the worst rel-L2 over the logits
    and the gradients, or the loss's relative difference, and where it
    is), and the card's bf16 run against the host's, each quantity beside
    its bound, ``ROUND_FACTOR`` times the host bf16 run's distance from
    its f32 run plus ``ROUND_TOL`` (the worst ratio of distance to bound,
    and every quantity past its bound)."""
    from repro_torch.quickstart import rel_l2

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def parts(r):
        return dict({f"logits.{i}": t for i, t in enumerate(r["logits"])},
                    **{f"grad.{k}": g for k, g in r["grads"].items()})

    out = {}
    for arch, h32 in runs["host_f32"].items():
        c32, h16, c16 = (runs[k][arch] for k in ("card_f32", "host_bf16",
                                                  "card_bf16"))
        p_h32, p_c32, p_h16, p_c16 = map(parts, (h32, c32, h16, c16))
        f32 = {k: rel_l2(p_c32[k], v) for k, v in p_h32.items()}
        f32["loss"] = rel(c32["loss"], h32["loss"])
        bf16 = {k: (rel_l2(p_c16[k], p_h16[k]),
                    ROUND_FACTOR * rel_l2(p_h16[k], v) + ROUND_TOL)
                for k, v in p_h32.items()}
        bf16["loss"] = (rel(c16["loss"], h16["loss"]),
                        ROUND_FACTOR * rel(h16["loss"], h32["loss"])
                        + ROUND_TOL)
        worst = max(f32, key=f32.get)
        worst16 = max(bf16, key=lambda k: bf16[k][0] / bf16[k][1])
        out[arch] = {
            "f32_worst": worst, "f32_rel": f32[worst],
            "f32_logits": max(v for k, v in f32.items()
                              if k.startswith("logits")),
            "f32_loss": f32["loss"],
            "bf16_worst": worst16, "bf16_rel": bf16[worst16][0],
            "bf16_bound": bf16[worst16][1],
            "bf16_over": [k for k, (d, bnd) in bf16.items() if d > bnd],
            "tokens_fed": h32["tokens"],
            "argmax_agrees": {k: runs[k][arch]["argmax"] == h32["argmax"]
                              for k in ("card_f32", "host_bf16",
                                        "card_bf16")}}
    return out


def families_check(smi: str, counts, zero_counts, failures: list[str], *,
                   reduced: dict, device: str = "cuda",
                   families: dict = FAMILIES, config=family_config,
                   seq: int = FAMILY_SEQ,
                   max_len: int = FAMILY_MAX_LEN,
                   vision=(VISION_PATCHES, VISION_TEXT)) -> dict:
    """The nine other model families on ``device``, each row of
    ``families`` (``config(arch, layers)`` gives the
    model, default :func:`family_config`): (a) served by
    :func:`lm_check` (no find-DB: the plan's tier ``default``; 4 slots,
    ``FAMILY_NEW`` tokens a request; the counts set to 0 just before the
    requests and read just after: attention launched once a layer that
    takes it for each kernel prompt, nothing else; the longest kernel
    prompt's logits by both routes within ``LM_TOL``, each attention call
    within the JAX package's oracle tolerance), internvl2's
    vision-prefix forward too (:func:`vision_check`); (b) one training
    step (:func:`family_train`); (d) the reduced archs card against host,
    in f32 within ``REDUCED_F32_TOL`` and in bf16 within ``ROUND_FACTOR``
    x the host's own bf16-to-f32 distance + ``ROUND_TOL``: the host's
    runs (``reduced``, :func:`start_reduced_runs`) collected here, the
    card's f32 run a subprocess started as this phase begins and its bf16
    run in this process.  Prints each number beside ``smi``; returns what
    it measured."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device(device)

    # (d) the card's f32 run starts first, fed the host's f32 tokens
    host_runs = reduced["future"].result()
    work = reduced["dir"]
    card_f32 = None
    if len(host_runs) == 2 and not host_runs[1]["rc"]:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(1)
        card_f32 = pool.submit(_run_reduced, _reduced_cmd(
            device, work / "card_f32.pt", True, work / "tokens.json"))
        pool.shutdown(wait=False)

    out: dict = {}
    launched = 0
    for arch, fam in families.items():
        tag = f"families: {arch}"
        t0 = time.perf_counter()
        cfg = config(arch, fam.serve)
        serve = lm_check(None, smi, counts, zero_counts, failures, cfg=cfg,
                         device=device, kernel_prompts=fam.kernel,
                         plain_prompts=fam.plain,
                         compare=fam.kernel[-1] if fam.kernel else None,
                         max_len=max_len, new_tokens=FAMILY_NEW,
                         want_tier="default", tag=tag)
        launched += serve["launches"]
        row = {"serve": serve}
        if cfg.frontend == "vision":
            row["vision"] = vision_check(cfg, dev, counts, zero_counts,
                                         failures, tag, *vision)
            launched += row["vision"]["launches"]
            print(f"  vision prefix: {vision[0]} patches + {vision[1]} "
                  f"tokens in {row['vision']['ms']:.2f} ms, attention "
                  f"launches {row['vision']['launches']}, kernel vs plain "
                  f"rel_l2 {row['vision']['rel_l2']:.3e} ({smi})")
        if fam.train:
            tr = family_train(config(arch, fam.train), seq, dev, counts,
                              zero_counts, failures, tag)
            row["train"] = tr
            peak, base = (tr[k] if tr[k] is None else round(tr[k], 2)
                          for k in ("max_memory_allocated_gib",
                                    "allocated_before_gib"))
            print(f"  train: {tr['layers']} layers, {tr['params'] / 1e9:.3f}"
                  f" B parameters ({tr['state_gib']:.2f} GiB at 16 B; "
                  f"allocated before {base} GiB), one "
                  f"step of {seq} positions {tr['step_ms']:.1f} ms, loss "
                  f"{tr['loss']:.4f}, nll {tr['nll']:.4f}, grad norm "
                  f"{tr['grad_norm']:.4f}, launches {tr['launches']}, "
                  f"routes {tr['routes']}, init {tr['init_s']:.2f} s, peak "
                  f"{peak} GiB ({smi})")
        row["seconds"] = time.perf_counter() - t0
        print(f"  {arch}: {row['seconds']:.1f} s")
        out[arch] = row

    # (d) the card's bf16 run here, then the four runs compared
    t0 = time.perf_counter()
    runs = {}
    if (work / "tokens.json").exists():
        runs["card_bf16"] = reduced_run(device, json.loads(
            (work / "tokens.json").read_text()))
    card_bf16_s = time.perf_counter() - t0
    if card_f32 is not None:
        host_runs.append(card_f32.result())
    for run in host_runs:
        if run["rc"]:
            failures.append(f"families: (d) {run['cmd']} exit {run['rc']}: "
                            f"{run['stderr']}")
    for name in ("host_f32", "host_bf16", "card_f32"):
        if (work / f"{name}.pt").exists():
            runs[name] = torch.load(work / f"{name}.pt")["runs"]
    reduced_out = reduced_compare(runs) if len(runs) == 4 else {}
    if len(runs) != 4:
        failures.append(f"families: (d) runs missing: have {sorted(runs)}")
    for arch, r in reduced_out.items():
        if r["f32_rel"] > REDUCED_F32_TOL:
            failures.append(f"families: (d) {arch} in f32: {r['f32_worst']} "
                            f"rel {r['f32_rel']:.3e} > {REDUCED_F32_TOL:g}")
        if r["bf16_over"]:
            failures.append(f"families: (d) {arch} in bf16 past "
                            f"{ROUND_FACTOR:g} x the host's bf16-to-f32 "
                            f"distance + {ROUND_TOL:g}: {r['bf16_over']}")
        print(f"  (d) {arch}: f32 worst {r['f32_worst']} {r['f32_rel']:.3e}"
              f" (logits {r['f32_logits']:.3e}, loss {r['f32_loss']:.3e}); "
              f"bf16 worst {r['bf16_worst']} {r['bf16_rel']:.3e} of bound "
              f"{r['bf16_bound']:.3e}; argmax as the host's f32 "
              f"{r['argmax_agrees']} ({smi})")
    print("  (d) runs: " + ", ".join(
        f"{r['cmd'][1]} {'f32' if '--f32' in r['cmd'] else 'bf16'} "
        f"{r['seconds']:.1f} s" for r in host_runs)
        + f"; the card's bf16 run {card_bf16_s:.1f} s in this process; the "
        f"host's started {t_phase - reduced['started']:.1f} s ahead")
    return {"families": out, "launches": launched, "reduced": reduced_out,
            "reduced_runs": [{k: v for k, v in r.items() if k != "stderr"}
                             for r in host_runs],
            "reduced_card_bf16_s": card_bf16_s,
            "reduced_ahead_s": t_phase - reduced["started"],
            "nvidia_smi": smi, "seconds": time.perf_counter() - t_phase}


def families_main() -> int:
    """Phase 14 alone on the card (``python -c "import chip_smoke, sys;
    sys.exit(chip_smoke.families_main())"``): the host's reduced runs
    started, the phase run, its failures printed; exit 1 on any, 2 with
    no card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reduced = start_reduced_runs()
    kernels = kernel_table()

    def counts() -> dict:
        return {name: op.launches for name, (_, op) in kernels.items()}

    def zero_counts() -> None:
        for _, op in kernels.values():
            op.launches = op.device_launches = 0

    failures: list[str] = []
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    with phase("families"):
        fam = families_check(smi, counts, zero_counts, failures,
                             reduced=reduced)
        print(f"  families phase {fam['seconds']:.1f} s (mark 120 s); "
              f"attention launches {fam['launches']}")
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on a card")
    ap.add_argument("--budget", type=int, default=100,
                    help="evaluations per tuner in the GEMM path (>= 40)")
    ap.add_argument("--samples", type=int, default=400,
                    help="configs landscape.main measures of each sampled "
                         "space, hotspot's at most HOTSPOT_SAMPLES (the "
                         "paper's is 10 000)")
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    ap.add_argument("--start-probe", type=float, default=None,
                    metavar="T", help="run only the start probe, started "
                    "at time.time() T, and print its stamps (what the "
                    "orchestrator phase runs)")
    ap.add_argument("--reduced-run", default=None, metavar="DEVICE",
                    help="run only one side of the families phase's part "
                    "(d) on DEVICE into --out (what that phase runs)")
    ap.add_argument("--out", default=None, help="--reduced-run's file")
    ap.add_argument("--f32", action="store_true",
                    help="--reduced-run with torch.bfloat16 as float32")
    ap.add_argument("--tokens", default=None,
                    help="--reduced-run's decode tokens (JSON)")
    args = ap.parse_args(argv)
    if args.start_probe is not None:
        print(json.dumps(start_probe(args.start_probe)))
        return 0
    if args.reduced_run is not None:
        return reduced_main(args.reduced_run, args.out, args.f32,
                            args.tokens)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch import _build, landscape, quickstart
    from repro_torch.kernels import EXHAUSTIVE
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

    def check_tiles(tiles: dict) -> None:
        """Each kernel's compiled tiles (name -> tile -> attributes): none
        spills, and each launches the largest block its space admits."""
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

    def conv2d_built() -> tuple[float, dict]:
        """Wait for conv2d's compile (started with the others in the build
        phase), print the whole build's time and last compiles, check
        conv2d's tiles and SASS as the build phase checks the others', and
        return the build's seconds and conv2d's SASS counts by tile."""
        built.update(conv2d_build.result())
        ckernel.libraries()
        build_s = max(b.seconds for b in built.values())
        n_nvcc = sum(len(m.VARIANTS) for m, _ in KERNELS.values())
        print(f"build: {build_s:.1f} s ({n_nvcc} nvcc processes in "
              f"parallel, {len(built)} sources)")
        finished = sorted(((t, f"{src}[{v}]") for src, b in built.items()
                           for v, t in b.finished.items()), reverse=True)
        print("  the last nvcc to finish: " + ", ".join(
            f"{name} at {t:.1f} s" for t, name in finished[:4]))
        record["build_finished_s"] = {name: t for t, name in finished}
        record["build_s"] = build_s
        check_tiles({"conv2d": {
            (f, ufh, rc, cc, ufw, a, fs): ckernel.tile_attributes(
                f, ufh, rc, cc, ufw, a, fs)
            for f in ckernel.FILTER_SIZES
            for ufh in sorted({ckernel.snap_unroll(u, f)
                               for u in ckernel.UNROLL})
            for ufw in sorted({ckernel.snap_unroll(u, f)
                               for u in ckernel.UNROLL})
            for rc, cc in ckernel.TILES for a in ("f32", "bf16")
            for fs in (0, 1)}})
        # every compiled conv2d tile's SASS: no local memory, and the tap
        # loop's instruction counts against the shared reads it should issue
        csass = conv2d_sass(built[ckernel.SOURCE], failures)
        record["conv2d_sass"] = {str(k): v for k, v in csass.items()}
        big = max(csass.items(), key=lambda kv: kv[1]["bytes"])
        print(f"  conv2d SASS: {len(csass)} compiled tiles, "
              f"{sum(n['local'] for n in csass.values())} LDL/STL; largest "
              f"{big[1]['bytes']} B of code, {big[0]}")
        return build_s, csass

    with phase("build"):
        # every variant of every source starts compiling at once; conv2d's
        # in a thread of its own, since its filter-15 variants end 50-70 s
        # after every other source's (PERF.md section 5): the other
        # sources' checks and parity run meanwhile (``conv2d_built``)
        from concurrent.futures import ThreadPoolExecutor
        conv2d_builder = ThreadPoolExecutor(1)
        conv2d_build = conv2d_builder.submit(
            _build.build_all, {ckernel.SOURCE: ckernel.VARIANTS})
        conv2d_builder.shutdown(wait=False)
        built = _build.build_all({m.SOURCE: m.VARIANTS
                                  for m, _ in KERNELS.values()
                                  if m is not ckernel})
        kernel.libraries()
        fkernel.libraries()
        nkernel.library()
        pkernel.libraries()
        hkernel.library()
        ekernel.library()
        dkernel.library()
        print(f"build: the other sources ({len(built)}) built in "
              f"{max(b.seconds for b in built.values()):.1f} s; conv2d's "
              f"{len(ckernel.VARIANTS)} variants go on")
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
            # every compiled tile of the three kernels of the sampled spaces
            "hotspot": {t: hkernel.tile_attributes(*t)
                        for t in hkernel.tiles()},
            "expdist": {(u, e, d): ekernel.tile_attributes(u, e, d)
                        for u in ekernel.UNROLL_J for e in ("exp", "exp2")
                        for d in ("f32", "bf16")},
            "dedisp": {(u, st, a): dkernel.tile_attributes(u, st, a)
                       for u, st in dkernel.tiles() for a in ("f32", "bf16")},
        }
        check_tiles(tiles)
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

        # conv2d last: its compile ran on through the phases before
        build_s, csass = conv2d_built()
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
        gemm_random = res["runs"]["RandomSearch"].trials

    def run_path(problem: str, name: str, prob, winner_parity,
                 samples: int | None = None) -> dict:
        """One problem's path: the quickstart (random search and GA, budget
        60 each, 64 sampled configs), then ``landscape.main`` over the
        whole space, or ``samples`` configs of a sampled one (of one it
        measures whole, :func:`sampled_landscape`), with the counts set to
        0 just before and read just after; then the winner against its
        plain version."""
        zero_counts()
        t0 = time.perf_counter()
        with trace.tracing():
            res = quickstart.main(problem=problem, device="cuda", budget=60,
                                  sample=64)
            land = sampled_landscape(problem, samples) \
                if samples is not None and problem in EXHAUSTIVE \
                else landscape.main(problem=problem, device="cuda",
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

    # phase 13 (d)'s dry runs and phase 14 (d)'s host runs need the host's
    # cores and no card: they run while the paths below keep the card, not
    # the host, busy
    dryruns = start_dry_runs()
    reduced = start_reduced_runs()

    with phase("nbody"):
        npath = run_path("nbody_h100", "nbody", nfull,
                         lambda c: nbody_parity(c, xnf), NBODY_SAMPLES)
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

    # the orchestrator phase's store, which the servedb phase distills
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_store")
    with phase("orchestrator"):
        t0 = time.perf_counter()
        orch = orchestrator_check(full, ffull, gemm_random,
                                  table_best_s, args.budget, failures,
                                  Path(work.name))
        orch["seconds"] = time.perf_counter() - t0
        split = start_split()
        orch["start_split"] = split
        record["orchestrator"] = orch
        print(f"  orchestrator phase {orch['seconds']:.1f} s; kernel "
              f"launches in its measuring processes {orch['launches']}")
        print("  a measuring process's start, split (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split["seconds"].items())
            + f"; kernel modules imported {len(split['kernel_modules'])}")
        if not split["ok"]:
            failures.append("the start probe's GEMM config was invalid")

    def gemm_winner(cfg: dict) -> None:
        """A tuner's GEMM winner at 4096^3: against the oracle within the
        JAX package's tolerance (the quickstart's check) and against the
        plain version (``gemm_parity``)."""
        err = quickstart.rel_l2(full.run_kernel(cfg, xf),
                                full.run_reference(cfg, xf))
        tol = quickstart.tolerance(full.name, cfg)
        print(f"    winner vs oracle rel_l2 {err:.3e} (tolerance {tol:g})")
        if not err <= tol:
            failures.append(f"GEMM winner {cfg} misses the oracle: rel_l2 "
                            f"{err:.3e} > {tol:g}")
        gemm_parity(cfg, xf, xf_nk)

    with phase("tuners"):
        t0 = time.perf_counter()
        tun = tuners_check(
            full, gemm_winner,
            {"conv2d": (cfull, cpath["land"]["table"]),
             "pnpoly": (pfull, ppath["land"]["table"])}, failures)
        tun["seconds"] = time.perf_counter() - t0
        record["tuners"] = tun
        print(f"  tuners phase {tun['seconds']:.1f} s; gemm launches "
              f"{tun['launches']}")

    def serve(kernel: str, cfg: dict, shape: dict) -> bool:
        """A served config launched at ``shape`` and held against its plain
        version; False, launching nothing, where the space does not admit
        it there."""
        if kernel == "gemm_h100":
            prob = full if shape == full.shape else GemmProblem(
                shape=shape, device="cuda")
            if not admits(prob.space, cfg):
                return False
            if prob is full:
                gemm_parity(cfg, xf, xf_nk)
            else:
                x = prob.make_inputs(seed=5, small=False)
                gemm_parity(cfg, x, x["b"].t().contiguous())
        elif kernel == "flash_attention_h100":
            if shape != ffull.shape or not admits(ffull.space, cfg):
                return False
            attention_parity(cfg, xaf, True)
        elif kernel == "conv2d_h100":
            if shape != cfull.shape or not admits(cfull.space, cfg):
                return False
            conv2d_parity(cfg, xcf)
        else:
            raise SystemExit(f"chip_smoke: no launch for a served {kernel}")
        return True

    with phase("servedb"):
        sdb = servedb_check(orch, Path(work.name), full, ffull, cfull,
                            cpath["land"]["table"], gemm_trials,
                            best.objective, serve, counts, failures)
        record["servedb"] = sdb
        print(f"  servedb phase {sdb['seconds']:.1f} s (mark 60 s); "
              f"launches of served answers {sdb['launches']}, screened "
              f"session {sdb['screen']['launches']}, warm-started submit "
              f"{sdb['warm_start']['launches']}")

    with phase("lm"):
        lm = lm_check(Path(work.name) / "servedb", nvidia_smi_line(), counts,
                      zero_counts, failures)
        work.cleanup()
        record["lm"] = lm
        print(f"  lm phase {lm['seconds']:.1f} s (mark 60 s); attention "
              f"launches {lm['launches']}")

    with phase("train"):
        tr = train_check(nvidia_smi_line(), counts, zero_counts, failures)
        record["train"] = tr
        print(f"  train phase {tr['seconds']:.1f} s (mark 90 s); kernel "
              f"launches {sum(tr['launches'].values())}; script so far "
              f"{time.time() - STARTED:.1f} s")

    with phase("dist"):
        dst = dist_check(nvidia_smi_line(), counts, zero_counts, failures,
                         train=tr, dryruns=dryruns)
        record["dist"] = dst
        print(f"  dist phase {dst['seconds']:.1f} s (mark 60 s); attention "
              f"launches {dst['launches']} (--opt {dst['opt_launches']}); "
              f"script so far "
              f"{time.time() - STARTED:.1f} s")

    with phase("families"):
        fam = families_check(nvidia_smi_line(), counts, zero_counts,
                             failures, reduced=reduced)
        record["families"] = fam
        print(f"  families phase {fam['seconds']:.1f} s (mark 120 s); "
              f"attention launches {fam['launches']}; script so far "
              f"{time.time() - STARTED:.1f} s")

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
         "orchestrator_launches": orch["launches"].get("gemm", 0),
         "tuners_launches": tun["launches"],
         "servedb_launches": sdb["launches"].get("gemm", 0),
         "screen_launches": sdb["screen"]["launches"],
         "warm_start_launches": sdb["warm_start"]["launches"],
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
         "exhaustive_best_ms": table_best_s * 1e3,
         "orchestrator_launches": orch["launches"].get("flash_attention", 0),
         "servedb_launches": sdb["launches"].get("flash_attention", 0),
         "lm_launches": lm["launches"],
         "train_launches": tr["launches"]["flash_attention"],
         "dist_launches": dst["launches"],
         "dist_opt_launches": dst["opt_launches"],
         "families_launches": fam["launches"],
         "build_s": build_s},
    ] + f32_lines
    for line in f32_lines:
        if line["name"] in sdb["launches"]:
            line["servedb_launches"] = sdb["launches"][line["name"]]
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
