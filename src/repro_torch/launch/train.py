"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-8b --shape train_4k \
        --steps 200 --ckpt-dir CKPT [--reduced] [--device cpu] \
        [--mesh host|production]

The port of ``repro.launch.train``: its flags, with ``--device`` (default
the card) beside ``--mesh``.  Without ``--mesh`` the run is on the one
device; ``--mesh host`` shards it over the process group's ranks (a
(data, model) mesh with ``model`` 1, as the JAX launcher's,
``launch.mesh.make_host_mesh``: under ``torchrun`` the group comes from
its environment, else it is this one process) and
``--mesh production`` over the 16x16 production mesh (256 ranks).
``--reduced --device cpu`` runs the same code end to end on the host on a
tiny same-family config.  Random weights come from ``Model.init`` with
the data seed; a reduced run takes 8 sequences of 128 tokens a step
unless told otherwise.

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch \
        qwen3-8b --reduced --mesh host --steps 20 --ckpt-dir CKPT

Fault tolerance in practice (see train/train_loop.py): auto-resume from
the newest committed checkpoint, SIGTERM-safe preemption checkpointing,
straggler watchdog events, resumable data pipeline keyed only by step
index.  Re-launching this command is the whole recovery protocol.

Prints a line a logged step and, last, the JSON summary (the final step,
the events, the device and the mesh), on rank 0 alone under a mesh;
``main`` returns the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--metrics", default=None, help="jsonl metrics sink")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (host smoke runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--mesh", choices=("host", "production"), default=None,
                    help="shard over a mesh (default: one device)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, SHAPES, reduce_config
    from ..data import DataConfig
    from ..train.optimizer import OptimizerConfig
    from ..train.train_loop import TrainLoop, TrainLoopConfig

    from ..device import resolve
    from .mesh import init_from_env, make_host_mesh, make_production_mesh

    mesh = None
    if args.mesh:
        device = resolve(args.device)
        init_from_env(device)
        mesh = make_production_mesh(device_type=device.type) \
            if args.mesh == "production" else \
            make_host_mesh(device=device)
    lead = mesh is None or mesh.get_rank() == 0   # one rank prints, logs
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)

    cell = SHAPES[args.shape]
    gb = args.global_batch or (8 if args.reduced else cell["global_batch"])
    sl = args.seq_len or (128 if args.reduced else cell["seq_len"])
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=sl, global_batch=gb)
    loop = TrainLoop(
        cfg, args.device,
        opt_cfg=OptimizerConfig(total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 20),
                                compress_grads=args.compress_grads),
        loop_cfg=TrainLoopConfig(
            total_steps=args.steps, log_every=args.log_every,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            auto_resume=not args.no_resume,
            microbatches=args.microbatches,
            metrics_path=args.metrics if lead else None),
        data_cfg=data_cfg, mesh=mesh)

    def log(step, m):
        if not lead:
            return
        print(f"step {step:5d}  loss {m.get('loss', float('nan')):8.4f}  "
              f"nll {m.get('nll', float('nan')):8.4f}  "
              f"gnorm {m.get('grad_norm', float('nan')):7.3f}  "
              f"{m.get('tokens_per_s', 0.0):9.0f} tok/s", flush=True)

    state = loop.run(on_metrics=log)
    summary = {"final_step": state.step, "events": loop.events,
               "device": str(loop.device),
               "mesh": None if mesh is None else dict(zip(
                   mesh.mesh_dim_names, tuple(mesh.shape)))}
    if lead:
        print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
