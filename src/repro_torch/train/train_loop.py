"""The training loop: eager steps on one device + the fault-tolerance
policy.

The port of ``repro.train.train_loop``.  Where the JAX loop shards its
state over a mesh, this one runs on one device, the card unless the
caller asks for another (``device.resolve``).  The weights come from
``Model.init(data_cfg.seed)`` there; the state checkpointed is
``{"params": model.state_dict(), "opt": opt_state}``, restored in place.

* **Auto-resume** — on start, the loop restores the newest committed
  checkpoint if one exists; the data pipeline needs only the step index
  (see data/pipeline.py), so restart = re-exec.
* **Preemption hook** — SIGTERM/SIGINT set a flag; the loop finishes the
  in-flight step, checkpoints, and exits 0, converting evictions into
  clean restarts.
* **Straggler watchdog** — per-step wall time is tracked with a robust
  running median; a step slower than ``watchdog_factor``× median is logged
  as a straggler event and (optionally) triggers an early checkpoint.
* **Host fetches** — metrics are fetched with one blocking transfer per
  ``log_every`` steps, keeping the device queue full between logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from ..configs.common import SHAPES
from ..data import DataConfig, make_pipeline
from ..device import resolve
from ..models import ModelConfig, build_model
from . import checkpoint as ckpt
from .optimizer import OptimizerConfig, init_opt_state


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    auto_resume: bool = True
    microbatches: int = 1
    watchdog_factor: float = 3.0
    checkpoint_on_straggler: bool = False
    metrics_path: str | None = None      # jsonl sink


@dataclasses.dataclass
class TrainState:
    params: Any          # the model's parameters by state_dict name
    opt_state: Any
    step: int


class _Preemption:
    """Latch SIGTERM/SIGINT; never aborts an in-flight step."""

    def __init__(self):
        self.flagged = False
        self._orig: dict[int, Any] = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:          # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        self.flagged = True

    def uninstall(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


class TrainLoop:
    def __init__(self, model_cfg: ModelConfig, device=None,
                 opt_cfg: OptimizerConfig | None = None,
                 loop_cfg: TrainLoopConfig | None = None,
                 data_cfg: DataConfig | None = None):
        self.model_cfg = model_cfg
        self.device = resolve(device)
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.loop_cfg = loop_cfg or TrainLoopConfig()
        self.data_cfg = data_cfg or DataConfig(vocab=model_cfg.vocab)
        self.model = build_model(model_cfg)
        self.pipeline = make_pipeline(self.data_cfg)
        self._events: list[dict] = []        # watchdog / lifecycle events

    # -------------------------------------------------------------- #
    def init_state(self) -> TrainState:
        self.model.init(self.data_cfg.seed, self.device)
        params = dict(self.model.named_parameters())
        return TrainState(params, init_opt_state(self.opt_cfg, params), 0)

    def _tree(self, state: TrainState) -> dict:
        return {"params": self.model.state_dict(), "opt": state.opt_state}

    # -------------------------------------------------------------- #
    def _resume(self, state: TrainState) -> TrainState:
        last = ckpt.latest_step(self.loop_cfg.ckpt_dir)
        if last is None or not self.loop_cfg.auto_resume:
            return state
        _, extra = ckpt.restore(self.loop_cfg.ckpt_dir, self._tree(state))
        self._events.append({"event": "resumed", "step": extra["step"]})
        return TrainState(state.params, state.opt_state, int(extra["step"]))

    def _save(self, state: TrainState) -> None:
        ckpt.save(self.loop_cfg.ckpt_dir, state.step, self._tree(state),
                  extra={"step": state.step,
                         "model": self.model_cfg.name,
                         "data_seed": self.data_cfg.seed},
                  keep=self.loop_cfg.ckpt_keep)

    # -------------------------------------------------------------- #
    def run(self, state: TrainState | None = None,
            on_metrics: Callable[[int, dict], None] | None = None
            ) -> TrainState:
        from ..launch.steps import make_train_step   # (avoids import cycle)
        lc = self.loop_cfg
        state = state or self.init_state()
        state = self._resume(state)
        step_fn = make_train_step(self.model, self.opt_cfg, lc.microbatches)
        preempt = _Preemption().install()
        metrics_file = (open(lc.metrics_path, "a")
                        if lc.metrics_path else None)
        step_times: list[float] = []
        try:
            while state.step < lc.total_steps:
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in self.pipeline.batch_at(state.step).items()}
                opt_state, metrics = step_fn(self.model, state.opt_state,
                                             batch)
                state = TrainState(state.params, opt_state, state.step + 1)

                if state.step % lc.log_every == 0 or \
                        state.step == lc.total_steps:
                    host = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    host["step_time_s"] = dt
                    host["tokens_per_s"] = (
                        self.data_cfg.global_batch
                        * self.data_cfg.seq_len / max(dt, 1e-9))
                    if on_metrics:
                        on_metrics(state.step, host)
                    if metrics_file:
                        metrics_file.write(json.dumps(
                            {"step": state.step, **host}) + "\n")
                        metrics_file.flush()

                # straggler watchdog (robust median of recent steps)
                dt = time.perf_counter() - t0
                step_times.append(dt)
                if len(step_times) >= 8:
                    med = float(np.median(step_times[-32:]))
                    if dt > lc.watchdog_factor * med:
                        self._events.append({
                            "event": "straggler", "step": state.step,
                            "step_time_s": dt, "median_s": med})
                        if lc.checkpoint_on_straggler:
                            self._save(state)

                if state.step % lc.ckpt_every == 0:
                    self._save(state)
                if preempt.flagged:
                    self._events.append({"event": "preempted",
                                         "step": state.step})
                    self._save(state)
                    break
            # final checkpoint so a completed run is always resumable
            self._save(state)
        finally:
            preempt.uninstall()
            if metrics_file:
                metrics_file.close()
        return state

    @property
    def events(self) -> list[dict]:
        return list(self._events)


def train_shape_cell(model_cfg: ModelConfig, shape_name: str, device=None,
                     **loop_kwargs) -> TrainLoop:
    """Loop wired to one assigned shape cell (launchers use this)."""
    cell = SHAPES[shape_name]
    data_cfg = DataConfig(vocab=model_cfg.vocab, seq_len=cell["seq_len"],
                          global_batch=cell["global_batch"])
    return TrainLoop(model_cfg, device,
                     loop_cfg=TrainLoopConfig(**loop_kwargs),
                     data_cfg=data_cfg)
