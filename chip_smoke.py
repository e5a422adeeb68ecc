#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py [--budget N] [--json PATH]

Phases, each timed:

1. probe    — the card must be sm_90 (Hopper); prints ``nvidia-smi``'s name
              and power limit.
2. build    — builds every kernel of the path from ``src/repro_torch/csrc``
              with nvcc, and checks that no compiled tile spills.
3. parity   — each kernel against its plain PyTorch version on the card: at
              256x256x512 for configs that together take every value of
              every parameter, and at 4096^3 for three configs; within the
              JAX package's tolerance and the tighter ``kernel.PLAIN_TOL``,
              with a bf16-vs-f32 accumulator control.
4. main     — the port's main path, ``repro_torch.quickstart.main``: random
              search and a genetic algorithm over the ``gemm_h100`` space at
              4096^3, every config timed on the card through the kernel,
              the winner checked, a sampled table and its speedup over the
              median.  The kernel's launch count is read around this phase.
5. timing   — the default config, the plain version and the PyTorch library
              call (``torch.addmm``, a yardstick the port never calls) at
              4096^3, each the median of cold-L2 CUDA-event repeats.

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on a card")
    ap.add_argument("--budget", type=int, default=100,
                    help="evaluations per tuner in the main path (>= 40)")
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as devmod
    from repro_torch import quickstart
    from repro_torch.core.problem import L2_FLUSH_BYTES, cuda_event_seconds
    from repro_torch.kernels.matmul import kernel, ops
    from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem
    from repro_torch.telemetry import trace

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    failures: list[str] = []     # checks that fail the run at its end

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
    with phase("build"):
        kernel.libraries()
        print(f"build: {kernel.build_seconds:.1f} s "
              f"(4 nvcc processes in parallel)")
        tiles = sorted({(c["rhs_layout"], c["block_m"], c["block_n"],
                         c["block_k"], c["warps"])
                        for c in full.space.valid_configs()})
        spills = []
        for t in tiles:
            a = kernel.tile_attributes(*t)
            if a["local_bytes"]:
                spills.append((t, a))
        regs = [kernel.tile_attributes(*t)["regs"] for t in tiles]
        print(f"{len(tiles)} tiles admitted by the space, registers "
              f"{min(regs)}..{max(regs)}, spilling: {spills or 'none'}")
        if spills:
            failures.append(f"admitted tiles spill: {spills}")
        record["build_s"] = kernel.build_seconds

    worst = {"rel_l2": 0.0, "max_abs_err": 0.0, "controls": 0}

    def parity(cfg: dict, x: dict, b_nk: torch.Tensor | None) -> None:
        """The kernel against its plain version: within ``TOLS`` (the JAX
        package's limit) and within ``kernel.PLAIN_TOL``.  For a bf16
        accumulator rounded more than once per slice, the control: the
        kernel must be nearer that plain version than the f32-accumulator
        one, or the tight check could not tell the two apart."""
        b = x["b"] if cfg["rhs_layout"] == "kn" else b_nk
        before = ops.gemm.launches
        got = ops.gemm(x["a"], b, x["c"], x["alpha"], x["beta"], cfg)
        torch.cuda.synchronize()
        if ops.gemm.launches != before + 1:
            raise SystemExit("chip_smoke: launch counter did not rise by 1")
        args = dict(alpha=x["alpha"], beta=x["beta"])
        want = kernel.gemm_plain(x["a"], b, x["c"], **args, **cfg)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: bad output for {cfg}")
        err = quickstart.rel_l2(got, want)
        mae = float((got.float() - want.float()).abs().max())
        tol = min(quickstart.TOLS[cfg["acc_dtype"]], kernel.PLAIN_TOL)
        note = ""
        if cfg["acc_dtype"] == "bf16" \
                and x["a"].shape[1] // cfg["split_k"] > cfg["block_k"]:
            f32 = kernel.gemm_plain(x["a"], b, x["c"], **args,
                                    **dict(cfg, acc_dtype="f32"))
            far = quickstart.rel_l2(got, f32)
            note = f" vs f32-acc plain {far:.2e}"
            worst["controls"] += 1
            if not far > err:
                failures.append(f"bf16 accumulator not told apart from f32: "
                                f"{far:.3e} <= {err:.3e} for {cfg}")
        print(f"  rel_l2 {err:.2e} max_abs {mae:.3g} (tol {tol:g}){note} "
              f"{cfg}")
        if not err <= tol:
            failures.append(f"kernel disagrees with its plain version: "
                            f"rel_l2 {err:.3e} > {tol:g} for {cfg}")
        worst["rel_l2"] = max(worst["rel_l2"], err)
        worst["max_abs_err"] = max(worst["max_abs_err"], mae)

    with phase("parity"):
        x = small.make_inputs(seed=3, small=True)
        x_nk = x["b"].t().contiguous()
        cfgs = covering_configs(small.space, 16, seed=5)
        print(f"{len(cfgs)} configs at {SMALL_SHAPE}, alpha 0.75, beta 0.5")
        for cfg in cfgs:
            parity(cfg, x, x_nk)
        xf = full.make_inputs(seed=4, small=False)
        xf_nk = xf["b"].t().contiguous()
        big = [dict(ops.DEFAULT_CONFIG)] + full.space.sample_distinct(2, 9)
        print(f"{len(big)} configs at {full.shape}")
        for cfg in big:
            parity(cfg, xf, xf_nk)
        if not worst["controls"]:
            failures.append("no bf16-accumulator config ran the control")
        record["parity"] = dict(worst, small_configs=len(cfgs),
                                full_configs=len(big))

    with phase("main"):
        ops.gemm.launches = 0
        t0 = time.perf_counter()
        with trace.tracing():        # host spans; device times are events
            res = quickstart.main(device="cuda", budget=args.budget,
                                  sample=64)
        main_s = time.perf_counter() - t0
        launches = ops.gemm.launches
        trials = [t for r in res["runs"].values() for t in r.trials] \
            + list(res["sampled"])
        bad = [(t.config, t.info) for t in trials if not t.ok]
        print(f"kernel launches in the main path: {launches}; "
              f"{len(trials)} trials, {len(bad)} invalid")
        if launches <= 0:
            raise SystemExit("chip_smoke: the main path launched no kernel")
        if bad:
            raise SystemExit(f"chip_smoke: admitted configs were invalid: "
                             f"{bad[:5]}")
        spans = trace.summarize()
        for sp in spans:
            print(f"  span {sp['name']:15s} x{sp['count']:4d} "
                  f"{sp['total_ms']:9.1f} ms")
        print(f"  main path {main_s:.2f} s on the host clock, "
              f"{main_s / len(trials) * 1e3:.1f} ms per measured config")
        record["spans"] = spans
        record["main_s"] = main_s
        best = res["best"]
        parity(best.config, xf, xf_nk)      # the winner at 4096^3
        record["trials"] = [{"config": t.config, "info": t.info}
                            for t in trials]

    m, n, k = (full.shape[d] for d in "mnk")
    flops = 2.0 * m * n * k
    # A, B, C read once and the output written once, bf16
    nbytes = 2.0 * (m * k + k * n + m * n + m * n)
    # the epilogue's f32 work runs beside the tensor cores, not after them
    ops_s = max(flops / PEAK_BF16_TC, 3.0 * m * n / PEAK_F32)
    bound_s = max(ops_s, nbytes / PEAK_HBM)
    bound_by = "operations" if ops_s >= nbytes / PEAK_HBM else "bytes"

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
        print(f"best config {best.config}")
        print(f"  median {t_best * 1e3:.4f} ms = {flops / t_best / 1e12:.1f} "
              f"TFLOP/s = {bound_s / t_best:.1%} of the {bound_s * 1e3:.4f} "
              f"ms bound ({bound_by})")
        print(f"default config {default.objective * 1e3:.4f} ms; plain "
              f"version {plain_s * 1e3:.3f} ms; library_ms (torch.addmm) "
              f"{lib_s * 1e3:.4f} ms")
        print(f"speedup over median: {res['speedup']:.3f}x over "
              f"{len(res['table'])} sampled configs")

    line = {"name": "gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm.cu",
            "replaces": "src/repro/kernels/matmul/kernel.py:71",
            "launches": launches, "max_abs_err": worst["max_abs_err"],
            "ms": default.objective * 1e3, "plain_ms": plain_s * 1e3,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": lib_s * 1e3,
            "rel_l2": worst["rel_l2"], "shape": [m, n, k],
            "default_config": ops.DEFAULT_CONFIG,
            "tuned_ms": t_best * 1e3, "tuned_config": best.config,
            "build_s": kernel.build_seconds}
    record["kernels"] = [line]
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
    print(json.dumps({"kernels": [line]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
