#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py [--budget N] [--json PATH]

Phases, each timed:

1. probe     — the card must be sm_90 (Hopper); prints ``nvidia-smi``'s name
               and power limit.
2. build     — builds every kernel of the port from ``src/repro_torch/csrc``
               with nvcc, all sources and variants at once, and checks that
               no compiled tile spills.
3. parity    — each kernel against its plain PyTorch version on the card, on
               configs that together take every value of every parameter at
               the small shapes (GEMM 256x256x512; attention 4 q heads, 2 kv
               heads, 256 x 256, d 64, causal and full, and 128 x 256), and
               on three configs at the full shapes; within the JAX package's
               tolerance and the tighter ``kernel.PLAIN_TOL``, with a
               bf16-vs-f32 accumulator control.
4. main      — the GEMM path, ``repro_torch.quickstart.main``: random search
               and a genetic algorithm over ``gemm_h100`` at 4096^3, every
               config timed on the card through the kernel, the winner
               checked, a sampled table and its speedup over the median.
5. attention — the attention path: the same quickstart over
               ``flash_attention_h100`` (32 q heads, 8 kv heads, 4096 x
               4096, d 128, causal), then ``repro_torch.landscape.main``,
               which measures the whole space and prints the paper's five
               landscape results on it.
               Each path's launch counts are set to 0 just before it and
               read just after; its kernel must have launched.
6. timing    — per kernel at its full shape: the default config, the plain
               version and one PyTorch library call computing the same
               function (``torch.addmm``; ``scaled_dot_product_attention``),
               a yardstick the port never calls; each the median of cold-L2
               CUDA-event repeats.

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
    from repro_torch.kernels.matmul import kernel, ops
    from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem
    from repro_torch.telemetry import trace

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    failures: list[str] = []     # checks that fail the run at its end

    def counts() -> dict:
        return {"gemm": ops.gemm.launches,
                "flash_attention": fops.attention.launches}

    def zero_counts() -> None:
        ops.gemm.launches = 0
        fops.attention.launches = 0

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
    with phase("build"):
        built = _build.build_all({kernel.SOURCE: kernel.VARIANTS,
                                  fkernel.SOURCE: fkernel.VARIANTS})
        build_s = max(b.seconds for b in built.values())
        kernel.libraries()
        fkernel.libraries()
        n_nvcc = len(kernel.VARIANTS) + len(fkernel.VARIANTS)
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
        }
        for name, attrs in tiles.items():
            spills = [(t, a) for t, a in attrs.items() if a["local_bytes"]]
            regs = [a["regs"] for a in attrs.values()]
            print(f"{name}: {len(attrs)} tiles, registers "
                  f"{min(regs)}..{max(regs)}, spilling: {spills or 'none'}")
            if spills:
                failures.append(f"{name} tiles spill: {spills}")
        for (d, bkv, w), a in tiles["flash_attention"].items():
            print(f"  attention d={d} block_kv={bkv} warps={w}: "
                  f"{a['regs']} registers, {a['smem_bytes']} B shared")
        record["build_s"] = build_s

    worst = {k: {"rel_l2": 0.0, "max_abs_err": 0.0, "controls": 0, "calls": 0}
             for k in ("gemm", "flash_attention")}

    def hold(name: str, problem: str, cfg: dict, got, want, f32_plain,
             label: str) -> None:
        """``got`` (the kernel) against ``want`` (its plain version): within
        the JAX package's tolerance and within the kernel's ``PLAIN_TOL``.
        ``f32_plain``, when given, computes the plain version with an f32
        accumulator: the control that the kernel is nearer the bf16 one, or
        the tight check could not tell the two apart."""
        w = worst[name]
        plain_tol = (kernel if name == "gemm" else fkernel).PLAIN_TOL
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
                failures.append(f"{name}: bf16 accumulator not told apart "
                                f"from f32: {far:.3e} <= {err:.3e} for {cfg}")
        print(f"  rel_l2 {err:.2e} max_abs {mae:.3g} (tol {tol:g}){note} "
              f"{label}{cfg}")
        if not err <= tol:
            failures.append(f"{name} disagrees with its plain version: "
                            f"rel_l2 {err:.3e} > {tol:g} for {label}{cfg}")
        w["rel_l2"] = max(w["rel_l2"], err)
        w["max_abs_err"] = max(w["max_abs_err"], mae)
        w["calls"] += 1

    def gemm_parity(cfg: dict, x: dict, b_nk) -> None:
        b = x["b"] if cfg["rhs_layout"] == "kn" else b_nk
        before = ops.gemm.launches
        got = ops.gemm(x["a"], b, x["c"], x["alpha"], x["beta"], cfg)
        torch.cuda.synchronize()
        if ops.gemm.launches != before + 1:
            raise SystemExit("chip_smoke: launch counter did not rise by 1")
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
        torch.cuda.synchronize()
        if fops.attention.launches != before + 1:
            raise SystemExit("chip_smoke: launch counter did not rise by 1")
        control = None
        if cfg["acc_dtype"] == "bf16" and k.shape[1] > cfg["block_kv"]:
            def control():
                return fkernel.flash_attention_plain(
                    q, k, v, causal=causal, **dict(cfg, acc_dtype="f32"))
        hold("flash_attention", "flash_attention_h100", cfg, got,
             fkernel.flash_attention_plain(q, k, v, causal=causal, **cfg),
             control, f"{tuple(q.shape)}x{tuple(k.shape)} causal={causal} ")

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
        for name, w in worst.items():
            if not w["controls"]:
                failures.append(f"{name}: no bf16-accumulator config ran "
                                f"the control")
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

    with phase("attention"):
        zero_counts()
        t0 = time.perf_counter()
        with trace.tracing():
            ares = quickstart.main(problem="flash_attention_h100",
                                   device="cuda", budget=60, sample=64)
            land = landscape.main(problem="flash_attention_h100",
                                  device="cuda")
        att_s = time.perf_counter() - t0
        launched = counts()
        alaunches = launched["flash_attention"]
        atrials = [t for r in ares["runs"].values() for t in r.trials] \
            + list(ares["sampled"]) + list(land["trials"])
        abad = [(t.config, t.info) for t in atrials if not t.ok]
        print(f"kernel launches in the attention path: {launched}; "
              f"{len(atrials)} trials, {len(abad)} invalid "
              f"({land['invalid']} of {len(land['trials'])} in the "
              f"exhaustive table)")
        if alaunches <= 0:
            raise SystemExit("chip_smoke: the attention path launched no "
                             "kernel")
        if abad:
            raise SystemExit(f"chip_smoke: admitted attention configs were "
                             f"invalid: {abad[:5]}")
        aspans = trace.summarize()
        for sp in aspans:
            print(f"  span {sp['name']:15s} x{sp['count']:4d} "
                  f"{sp['total_ms']:9.1f} ms")
        print(f"  attention path {att_s:.2f} s on the host clock, "
              f"{att_s / len(atrials) * 1e3:.1f} ms per measured config")
        abest = ares["best"]
        attention_parity(abest.config, xaf, True)   # the winner, full shape
        table = land["table"]
        ex_best_enc, ex_best_s = table.best()
        cfgs_t = [ffull.space.decode(c) for c in table.configs]
        f32_h1 = min((o, i) for i, (c, o) in enumerate(zip(cfgs_t,
                                                           table.objectives))
                     if c["acc_dtype"] == "f32" and c["block_h"] == 1)
        print(f"  exhaustive best {ex_best_s * 1e3:.4f} ms "
              f"{ffull.space.decode(ex_best_enc)}; tuners' best "
              f"{abest.objective * 1e3:.4f} ms; fastest f32 config with "
              f"block_h 1 {f32_h1[0] * 1e3:.4f} ms {cfgs_t[f32_h1[1]]}")
        record["attention"] = {
            "spans": aspans, "path_s": att_s, "landscape": {
                k: land[k] for k in ("speedup", "n90", "n99", "centrality",
                                     "pfi", "r2", "pfi_sum", "table8",
                                     "best_config", "invalid", "seconds",
                                     "analyse_seconds")},
            "table": [{"config": c, "seconds": o}
                      for c, o in zip(cfgs_t, table.objectives)],
            "trials": [{"config": t.config, "info": t.info}
                       for t in atrials]}

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
    ]
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
