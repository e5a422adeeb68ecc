#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py [--budget N] [--json PATH]

Phases, each timed:

1. probe     — the card must be sm_90 (Hopper); prints ``nvidia-smi``'s name
               and power limit.
2. build     — builds every kernel of the port from ``src/repro_torch/csrc``
               with nvcc, all sources and variants at once, and checks that
               no compiled tile spills and that every tile launches the
               largest block its space admits.
3. parity    — each kernel against its plain PyTorch version on the card, on
               configs that together take every value of every parameter at
               small shapes (GEMM 256x256x512; attention 4 q heads, 2 kv
               heads, 256 x 256, d 64, causal and full, and 128 x 256;
               N-body 512 and 4096 bodies; pnpoly 1536 points and a
               17-gon; conv2d 48 x 160 with a 5 x 5 filter and 300 x 600
               with 15 x 15), and on three configs at the full shapes;
               within the JAX package's tolerance and the tighter
               ``kernel.PLAIN_TOL``, with a bf16-vs-f32 control for every
               kernel with a bf16 option.  pnpoly is held exactly (0
               mismatching points), and its twelve method variants must
               agree point for point at the full shape.
4. main      — the GEMM path, ``repro_torch.quickstart.main``: random search
               and a genetic algorithm over ``gemm_h100`` at 4096^3, every
               config timed on the card through the kernel, the winner
               checked, a sampled table and its speedup over the median.
5. paths     — for ``flash_attention_h100`` (32 q heads, 8 kv heads, 4096 x
               4096, d 128, causal), ``nbody_h100`` (131 072 bodies),
               ``pnpoly_h100`` (2 000 000 points, a 600-gon) and
               ``conv2d_h100`` (4096 x 4096, 15 x 15): the same quickstart,
               then ``repro_torch.landscape.main``, which measures the whole
               space and prints the paper's five landscape results on it.
               Each path's launch counts are set to 0 just before it and
               read just after; its kernel must have launched, and no
               admitted config may be invalid.
6. timing    — per kernel at its full shape: the default config, the plain
               version and, where one exists, one PyTorch library call
               computing the same function (``torch.addmm``;
               ``scaled_dot_product_attention``; ``F.conv2d``), a yardstick
               the port never calls; each the median of cold-L2 CUDA-event
               repeats.

Prints the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure exits non-zero without the ``ok`` line, as does a host
with no CUDA device or a directory without the rest of the repository.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM data sheet peaks (dense), for the bound
PEAK_BF16_TC = 989e12     # FLOP/s, bf16 on the tensor cores
PEAK_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
PEAK_HBM = 3.35e12        # bytes/s


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


def bound(flops: float, f32_ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    (tensor-core products, and the f32 work beside them) over their peak
    rates and the bytes over the memory rate."""
    ops_s = max(flops / PEAK_BF16_TC, f32_ops / PEAK_F32)
    bytes_s = nbytes / PEAK_HBM
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def kernel_table() -> dict:
    """A row per kernel of the port: its kernel module (``SOURCE``,
    ``VARIANTS``, ``PLAIN_TOL``) and its public op, which counts its
    launches.  Needs ``src`` on the path."""
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.conv2d import kernel as ckernel
    from repro_torch.kernels.conv2d import ops as cops
    from repro_torch.kernels.matmul import kernel, ops
    from repro_torch.kernels.nbody import kernel as nkernel
    from repro_torch.kernels.nbody import ops as nops
    from repro_torch.kernels.pnpoly import kernel as pkernel
    from repro_torch.kernels.pnpoly import ops as pops
    return {"gemm": (kernel, ops.gemm),
            "flash_attention": (fkernel, fops.attention),
            "nbody": (nkernel, nops.nbody),
            "pnpoly": (pkernel, pops.pnpoly),
            "conv2d": (ckernel, cops.conv2d)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on a card")
    ap.add_argument("--budget", type=int, default=100,
                    help="evaluations per tuner in the GEMM path (>= 40)")
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
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.space import (AttentionProblem,
                                                     inputs_from_numpy,
                                                     numpy_inputs)
    from repro_torch.kernels.conv2d import kernel as ckernel
    from repro_torch.kernels.conv2d import ops as cops
    from repro_torch.kernels.conv2d.space import Conv2dProblem
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

    def zero_counts() -> None:
        for _, op in KERNELS.values():
            op.launches = 0

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
    with phase("build"):
        built = _build.build_all({m.SOURCE: m.VARIANTS
                                  for m, _ in KERNELS.values()})
        build_s = max(b.seconds for b in built.values())
        kernel.libraries()
        fkernel.libraries()
        nkernel.library()
        pkernel.libraries()
        ckernel.libraries()
        n_nvcc = sum(len(m.VARIANTS) for m, _ in KERNELS.values())
        print(f"build: {build_s:.1f} s ({n_nvcc} nvcc processes in "
              f"parallel, {len(built)} sources)")
        tiles = {
            "gemm": {t: kernel.tile_attributes(*t) for t in sorted(
                {(c["rhs_layout"], c["block_m"], c["block_n"], c["block_k"],
                  c["warps"]) for c in full.space.valid_configs()})},
            # every compiled attention tile: d 128 runs the full shape, d 64
            # the small one
            "flash_attention": {(d, bkv, w): fkernel.tile_attributes(d, bkv, w)
                                for d in fkernel.HEAD_DIMS
                                for bkv in fkernel.BLOCK_KV
                                for w in fkernel.WARPS},
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
            "conv2d": {(f, ufh, rc, ufw, a, fs): ckernel.tile_attributes(
                f, ufh, rc, ufw, a, fs)
                for f in ckernel.FILTER_SIZES
                for ufh in sorted({ckernel.snap_unroll(u, f)
                                   for u in ckernel.UNROLL})
                for ufw in sorted({ckernel.snap_unroll(u, f)
                                   for u in ckernel.UNROLL})
                for rc in ckernel.ROW_CHUNK for a in ("f32", "bf16")
                for fs in (0, 1)},
        }
        for name, attrs in tiles.items():
            spills = [(t, a) for t, a in attrs.items() if a["local_bytes"]]
            regs = [a["regs"] for a in attrs.values()]
            print(f"{name}: {len(attrs)} tiles, registers "
                  f"{min(regs)}..{max(regs)}, spilling: {spills or 'none'}")
            if spills:
                failures.append(f"{name} tiles spill: {spills}")
            # the three f32 kernels' spaces admit blocks of MAX_THREADS
            most = getattr(KERNELS[name][0], "MAX_THREADS", None)
            short = [t for t, a in attrs.items()
                     if most and a["max_threads"] < most]
            if short:
                failures.append(f"{name} tiles cannot launch {most} threads: "
                                f"{short}")
        for (d, bkv, w), a in tiles["flash_attention"].items():
            print(f"  attention d={d} block_kv={bkv} warps={w}: "
                  f"{a['regs']} registers, {a['smem_bytes']} B shared")
        record["build_s"] = build_s

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
        image, filt = x["image"], x["filt"]
        before = cops.conv2d.launches
        got = cops.conv2d(image, filt, cfg)
        launched_once(cops.conv2d, before)
        control = None
        if cfg["acc_dtype"] == "bf16":
            def control():
                return ckernel.conv2d_plain(image, filt,
                                            **dict(cfg, acc_dtype="f32"))
        hold("conv2d", "conv2d_h100", cfg, got,
             ckernel.conv2d_plain(image, filt, **cfg), control,
             f"{tuple(image.shape)}*{tuple(filt.shape)} ")

    def pnpoly_parity(cfg: dict, x: dict) -> torch.Tensor:
        """The kernel against its plain version, point for point: any
        mismatching point fails the run."""
        pts = laid_out(x["points"], cfg)
        before = pops.pnpoly.launches
        got = pops.pnpoly(pts, x["poly"], cfg)
        launched_once(pops.pnpoly, before)
        want = pkernel.pnpoly_plain(pts, x["poly"], **cfg)
        if got.shape != want.shape or got.dtype != torch.int32:
            raise SystemExit(f"chip_smoke: bad pnpoly output for {cfg}")
        bad = int((got != want).sum())
        w = worst["pnpoly"]
        w["mismatches"] += bad
        w["max_abs_err"] = max(w["max_abs_err"],
                               float((got - want).abs().max()))
        w["rel_l2"] = max(w["rel_l2"], quickstart.rel_l2(got, want))
        w["calls"] += 1
        print(f"  mismatches {bad} of {got.numel()} (tol 0) "
              f"{tuple(x['poly'].shape)} {cfg}")
        if bad:
            failures.append(f"pnpoly disagrees with its plain version on "
                            f"{bad} points for {cfg}")
        return got

    with phase("parity"):
        x = small.make_inputs(seed=3, small=True)
        x_nk = x["b"].t().contiguous()
        cfgs = covering_configs(small.space, 16, seed=5)
        print(f"gemm: {len(cfgs)} configs at {SMALL_SHAPE}, alpha 0.75, "
              f"beta 0.5")
        for cfg in cfgs:
            gemm_parity(cfg, x, x_nk)
        xf = full.make_inputs(seed=4, small=False)
        xf_nk = xf["b"].t().contiguous()
        big = [dict(ops.DEFAULT_CONFIG)] + full.space.sample_distinct(2, 9)
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

        for shape in (Conv2dProblem.small_shape,
                      {"h": 300, "w": 600, "fh": 15, "fw": 15}):
            prob = Conv2dProblem(shape=shape, device="cuda")
            ccfgs = covering_configs(prob.space, 12, seed=5)
            print(f"conv2d: {len(ccfgs)} configs at {shape}")
            xc = prob.make_inputs(seed=3, small=False)
            for cfg in ccfgs:
                conv2d_parity(cfg, xc)
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
        launches = launched["gemm"]
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

    def run_path(problem: str, name: str, prob, winner_parity) -> dict:
        """One problem's path: the quickstart (random search and GA, budget
        60 each, 64 sampled configs), then ``landscape.main`` over the
        whole space, with the launch counts set to 0 just before and read
        just after; then the winner against its plain version."""
        zero_counts()
        t0 = time.perf_counter()
        with trace.tracing():
            res = quickstart.main(problem=problem, device="cuda", budget=60,
                                  sample=64)
            land = landscape.main(problem=problem, device="cuda")
        path_s = time.perf_counter() - t0
        launched = counts()
        trials = [t for r in res["runs"].values() for t in r.trials] \
            + list(res["sampled"]) + list(land["trials"])
        bad = [(t.config, t.info) for t in trials if not t.ok]
        print(f"kernel launches in the {name} path: {launched}; "
              f"{len(trials)} trials, {len(bad)} invalid "
              f"({land['invalid']} of {len(land['trials'])} in the "
              f"exhaustive table)")
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
        ex_best_enc, ex_best_s = table.best()
        cfgs_t = [prob.space.decode(c) for c in table.configs]
        print(f"  exhaustive best {ex_best_s * 1e3:.4f} ms "
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
                "best": best, "ex_best_s": ex_best_s, "configs": cfgs_t}

    with phase("attention"):
        apath = run_path("flash_attention_h100", "flash_attention", ffull,
                         lambda c: attention_parity(c, xaf, True))
        abest, alaunches = apath["best"], apath["launches"]
        ex_best_s = apath["ex_best_s"]
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

    m, n, k = (full.shape[d] for d in "mnk")
    flops = 2.0 * m * n * k
    # A, B, C read once and the output written once, bf16; the epilogue's
    # f32 work runs beside the tensor cores
    bound_s, bound_by = bound(flops, 3.0 * m * n,
                              2.0 * (m * k + k * n + m * n + m * n))
    hq, hkv, tq, tk, d = (ffull.shape[s] for s in
                          ("hq", "hkv", "tq", "tk", "d"))
    # the visible (row, column) pairs of the causal mask: QK^T and PV take
    # 2 * d FLOP each on the tensor cores; scale, mask, max, exp and sum
    # about 5 f32 operations; q, k, v read and the output written once
    pairs = hq * sum(min(tk, max(0, r + tk - tq + 1)) for r in range(tq))
    abound_s, abound_by = bound(4.0 * d * pairs, 5.0 * pairs,
                                2.0 * d * (2 * hq * tq + 2 * hkv * tk))
    # the three f32 kernels use no tensor core.  nbody: N^2 pairs at 20 FLOP
    # each (the CUDA SDK's count per interaction); pos and mass read once,
    # the (3, N) output written once
    nb = nfull.shape["n"]
    nbound_s, nbound_by = bound(0.0, 20.0 * nb * nb, 4.0 * (4 * nb + 3 * nb))
    # pnpoly: N x V point-edge pairs at about 7 operations each (two
    # comparisons, the crossing's subtract, multiply and add, its compare,
    # the parity update); the points and polygon read once, the int32
    # flags written once
    pn, pv = pfull.shape["n"], pfull.shape["v"]
    pbound_s, pbound_by = bound(0.0, 7.0 * pn * pv,
                                4.0 * (2 * pn + 2 * pv + pn))
    # conv2d: every output takes F^2 multiply-adds (2 FLOP each); the image
    # and filter read once, the output written once
    ch, cw, cf = cfull.shape["h"], cfull.shape["w"], cfull.shape["fh"]
    coh, cow = ch - cf + 1, cw - cf + 1
    cbound_s, cbound_by = bound(0.0, 2.0 * coh * cow * cf * cf,
                                4.0 * (ch * cw + cf * cf + coh * cow))

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
              f"ms bound ({bound_by})")
        print(f"gemm default config {default.objective * 1e3:.4f} ms; plain "
              f"version {plain_s * 1e3:.3f} ms; library_ms (torch.addmm) "
              f"{lib_s * 1e3:.4f} ms")
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
              f"bound ({abound_by})")
        print(f"attention default config {adefault.objective * 1e3:.4f} ms; "
              f"plain version {aplain_s * 1e3:.3f} ms; library_ms "
              f"(scaled_dot_product_attention) "
              f"{'n/a' if alib_s is None else f'{alib_s * 1e3:.4f}'} ms")

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
                 (cbound_s, cbound_by), "conv2d/kernel.py:86")):
            dflt = prob.evaluate(dcfg)
            if not dflt.ok:
                raise SystemExit(f"chip_smoke: {name} default config "
                                 f"failed: {dflt.info}")
            plain_t = statistics.median(cuda_event_seconds(
                plain, repeats=3, warmup=1, flush=flush))
            lib_t = None if lib is None else statistics.median(
                cuda_event_seconds(lib, repeats=10, warmup=3, flush=flush))
            tuned = path["best"]
            print(f"{name} tuned config {tuned.config}")
            print(f"  median {tuned.objective * 1e3:.4f} ms = "
                  f"{b_s / tuned.objective:.1%} of the {b_s * 1e3:.4f} ms "
                  f"bound ({b_by}); exhaustive best "
                  f"{path['ex_best_s'] * 1e3:.4f} ms")
            print(f"{name} default config {dflt.objective * 1e3:.4f} ms; "
                  f"plain version {plain_t * 1e3:.3f} ms; library_ms "
                  f"{'n/a' if lib_t is None else f'{lib_t * 1e3:.4f}'} ms")
            f32_lines.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": path["launches"],
                "max_abs_err": worst[name]["max_abs_err"],
                "ms": dflt.objective * 1e3, "plain_ms": plain_t * 1e3,
                "bound_ms": b_s * 1e3, "bound_by": b_by,
                "library_ms": None if lib_t is None else lib_t * 1e3,
                "rel_l2": worst[name]["rel_l2"],
                "mismatches": worst[name]["mismatches"],
                "shape": list(prob.shape.values()), "default_config": dcfg,
                "tuned_ms": tuned.objective * 1e3,
                "tuned_config": tuned.config,
                "exhaustive_best_ms": path["ex_best_s"] * 1e3,
                "build_s": build_s})

    lines = [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm.cu",
         "replaces": "src/repro/kernels/matmul/kernel.py:71",
         "launches": launches, "max_abs_err": worst["gemm"]["max_abs_err"],
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
         "launches": alaunches,
         "max_abs_err": worst["flash_attention"]["max_abs_err"],
         "ms": adefault.objective * 1e3, "plain_ms": aplain_s * 1e3,
         "bound_ms": abound_s * 1e3, "bound_by": abound_by,
         "library_ms": None if alib_s is None else alib_s * 1e3,
         "rel_l2": worst["flash_attention"]["rel_l2"],
         "shape": [hq, hkv, tq, tk, d],
         "default_config": fops.DEFAULT_CONFIG,
         "tuned_ms": at_best * 1e3, "tuned_config": abest.config,
         "exhaustive_best_ms": ex_best_s * 1e3, "build_s": build_s},
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
