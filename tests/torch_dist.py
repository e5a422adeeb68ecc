"""Helpers the port's multi-rank tests share: a body of code run in
``world`` processes of a gloo process group on the host, each its own
subprocess with a timeout, so no process group outlives the test.

Each rank runs ``body`` with ``rank``, ``world``, ``tmp`` (a directory
shared by the ranks) and ``out`` (a dict it fills) in its namespace, after
``torch.distributed.init_process_group("gloo")`` on a ``FileStore`` under
``tmp`` (no port is opened for the rendezvous, so workers that run at the
same time cannot collide), with one torch thread.  :func:`run_ranks`
returns the ranks' ``out`` dicts, in rank order.  :func:`family_inputs`
is the weights and batch the families' sharded steps are held on.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

_RANK = """
import os, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tmp, "store"), world), rank=rank, world_size=world)
out = {}
exec(compile(open(os.path.join(tmp, "body.py")).read(), "body", "exec"),
     {"rank": rank, "world": world, "tmp": tmp, "out": out})
torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(body: str, world: int, tmp: Path, timeout: float = 240.0
              ) -> list[dict]:
    """Run ``body`` on ``world`` gloo ranks (see the module's note)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "body.py").write_text(textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:"
               f"{REPO / 'tests'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(world), str(tmp)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        logs[r][-3000:] for r, _ in bad if r < len(logs))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def family_inputs(arch: str) -> dict:
    """The reduced ``arch``'s weights from seed 0 and a batch of 8
    sequences of 16 tokens (some labels masked), with its frames, from a
    numpy seed."""
    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.models import build_model
    cfg = reduce_config(ARCHS[arch])
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int64)
             for k in ("tokens", "labels")}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32)
    return {"state": build_model(cfg).init(0, "cpu").state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
