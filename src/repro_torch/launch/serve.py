"""Serving launcher: continuous-batching decode over KV-cache slots.

    python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
        --requests 16 --max-new 32 --device cpu

Drives repro_torch.serve.ServingEngine with synthetic prompts
(deterministic, seeded) and random weights made from ``--seed`` on the
device.  It runs on the card unless ``--device`` says otherwise; without
``--reduced`` the architecture is built at full width and depth.
``--servedb DIR`` plans the flash-attention config from a find-DB.  An
encoder-decoder's requests carry ``ENC_OUT_LEN`` frames, the engine's
fixed encoder length.
Prints the JAX launcher's JSON summary, plus each prefill's milliseconds
and attention route, the median milliseconds of a decode step, and the
prefill attention calls by route.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--servedb", default=None, metavar="DIR",
                    help="find-DB to plan kernel configs from")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, reduce_config
    from ..device import resolve
    from ..kernels.attention import ops as flash_ops
    from ..models import build_model
    from ..models.attention import ROUTES
    from ..serve.decode import (ENC_OUT_LEN, FLASH, Request, ServeConfig,
                                ServingEngine)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    device = resolve(args.device)
    model = build_model(cfg).init(args.seed, device)
    engine = ServingEngine(model, ServeConfig(
        n_slots=args.slots, max_len=args.max_len,
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed, servedb=args.servedb))

    rng = np.random.default_rng(args.seed)
    routes0, launches0 = dict(ROUTES), flash_ops.attention.launches
    t0 = time.perf_counter()
    for uid in range(args.requests):
        plen = int(rng.integers(2, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        frames = (rng.standard_normal((ENC_OUT_LEN, cfg.d_model))
                  .astype(np.float32) if cfg.frontend == "audio" else None)
        engine.submit(Request(uid=uid, prompt=prompt, frames=frames))
    completions = engine.run()
    dt = time.perf_counter() - t0

    toks = sum(len(c.tokens) for c in completions)
    summary = {
        "requests": len(completions),
        "decode_steps": engine.steps,
        "generated_tokens": toks,
        "wall_s": round(dt, 3),
        "tokens_per_s": round(toks / max(dt, 1e-9), 1),
        "finished": {c.uid: c.finished_reason for c in completions},
        "device": str(device),
        "plan_tier": engine.kernel_plan[FLASH].tier,
        "prefill_ms": {p["uid"]: [round(p["ms"], 3), p["route"]]
                       for p in engine.prefills},
        "decode_step_ms_median": (round(statistics.median(engine.decode_ms),
                                        3) if engine.decode_ms else None),
        "attention_routes": {k: ROUTES[k] - routes0.get(k, 0)
                             for k in ("kernel:plan", "kernel:resolved",
                                       "plain")},
        "attention_launches": flash_ops.attention.launches - launches0,
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
