"""The port's train loop (``repro_torch.train.train_loop``) and launcher
(``repro_torch.launch.train``) on the CPU: a run stopped by the preemption
flag and resumed from its checkpoint ends bit-equal to an uninterrupted
one (the counterpart of ``tests/test_checkpoint.py``'s
``test_train_loop_auto_resume``), the straggler watchdog sees an injected
slow step, a reduced qwen3-8b learns, and ``chip_smoke.train_check``
(the launcher's SIGTERM drill included) runs on the host."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduce_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train import (OptimizerConfig, TrainLoop,  # noqa: E402
                               TrainLoopConfig, train_shape_cell)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(tmp_path, steps, *, ckpt_every=2, opt=None, data=None, **kw):
    cfg = reduce_config(ARCHS["qwen3-8b"])
    return TrainLoop(
        cfg, "cpu", opt_cfg=opt or OptimizerConfig(lr=3e-3, warmup_steps=1,
                                                   total_steps=steps),
        loop_cfg=TrainLoopConfig(total_steps=steps, log_every=1,
                                 ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmp_path), **kw),
        data_cfg=data or DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=2))


def _preempt_at(monkeypatch, step: int):
    """Replace the loop's SIGTERM latch by one whose flag goes up once the
    loop has logged ``step``; returns the metrics callback that raises
    it."""
    latches = []

    class Latch(train_loop._Preemption):
        def install(self):
            latches.append(self)
            return self

    monkeypatch.setattr(train_loop, "_Preemption", Latch)

    def on_metrics(s, m):
        if s == step:
            latches[-1].flagged = True
    return on_metrics


def _leaves(loop, state):
    return ckpt._flatten(loop._tree(state))


def test_a_resumed_run_is_bit_equal_to_an_uninterrupted_one(tmp_path,
                                                            monkeypatch):
    full = _loop(tmp_path / "full", 8)
    want = full.run()
    assert want.step == 8 and full.events == []

    first = _loop(tmp_path / "pre", 8)
    stopped = first.run(on_metrics=_preempt_at(monkeypatch, 5))
    assert stopped.step == 5
    assert first.events == [{"event": "preempted", "step": 5}]
    assert ckpt.latest_step(tmp_path / "pre") == 5
    monkeypatch.undo()

    logged = {}
    second = _loop(tmp_path / "pre", 8)
    got = second.run(on_metrics=lambda s, m: logged.update({s: m}))
    assert got.step == 8
    assert second.events == [{"event": "resumed", "step": 5}]
    assert sorted(logged) == [6, 7, 8]
    a, b = _leaves(full, want), _leaves(second, got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # both committed step 8's checkpoint, byte for byte
    assert ckpt.latest_step(tmp_path / "full") == 8
    shard = Path("step_000000008") / ckpt.SHARD
    assert (tmp_path / "full" / shard).read_bytes() \
        == (tmp_path / "pre" / shard).read_bytes()


def test_restart_from_a_finished_run_continues_its_steps(tmp_path):
    """The reference's ``test_train_loop_auto_resume``: a loop asked for
    more steps continues from the newest checkpoint."""
    assert _loop(tmp_path, 4).run().step == 4
    again = _loop(tmp_path, 6)
    assert again.run().step == 6
    assert any(e["event"] == "resumed" and e["step"] == 4
               for e in again.events)
    fresh = _loop(tmp_path, 6, auto_resume=False)
    state = fresh.init_state()
    assert fresh._resume(state) is state and fresh.events == []


def test_sigterm_sets_the_latch_and_uninstall_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    latch = train_loop._Preemption().install()
    try:
        if latch._orig:              # installed: this is the main thread
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                if latch.flagged:
                    break
                time.sleep(0.01)
        else:
            latch._handler(signal.SIGTERM, None)
        assert latch.flagged
    finally:
        latch.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_the_watchdog_logs_an_injected_straggler(tmp_path):
    loop = _loop(tmp_path, 12, ckpt_every=100, checkpoint_on_straggler=True)
    fast = loop.pipeline.batch_at

    def slow_at_10(step):
        if step == 10:
            time.sleep(1.0)
        return fast(step)

    loop.pipeline.batch_at = slow_at_10
    loop.run()
    # (a busy host may slow another step past the factor too)
    stragglers = {e["step"]: e for e in loop.events
                  if e["event"] == "straggler"}
    assert 11 in stragglers
    assert stragglers[11]["step_time_s"] >= 1.0 \
        > 3 * stragglers[11]["median_s"]
    # the early checkpoint, beside the final one
    saved = {int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")}
    assert {11, 12} <= saved


def test_a_reduced_qwen3_learns(tmp_path):
    """lr 1e-2 over 20 steps of 8 x 128 tokens: the mean nll of steps
    17-20 at least 1 nat below step 1's (the Markov source's floor is far
    below both)."""
    cfg = reduce_config(ARCHS["qwen3-8b"])
    nll = {}
    loop = _loop(tmp_path, 20, ckpt_every=100,
                 opt=OptimizerConfig(lr=1e-2, warmup_steps=2,
                                     total_steps=20),
                 data=DataConfig(vocab=cfg.vocab, seq_len=128,
                                 global_batch=8))
    loop.run(on_metrics=lambda s, m: nll.update({s: m["nll"]}))
    late = float(np.mean([nll[s] for s in (17, 18, 19, 20)]))
    assert nll[1] - late >= 1.0, (nll[1], late)
    assert late > loop.pipeline.entropy_floor()


def test_the_launcher_trains_on_the_host(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    out = launcher.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                         "--steps", "4", "--log-every", "2",
                         "--ckpt-every", "2", "--ckpt-dir",
                         str(tmp_path / "ck"), "--metrics", str(metrics),
                         "--microbatches", "2", "--compress-grads"])
    assert out["final_step"] == 4 and out["events"] == []
    assert out["device"] == "cpu"
    rows = [json.loads(s) for s in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4]
    assert all(math.isfinite(r["loss"]) for r in rows)
    printed = capsys.readouterr().out
    assert "step     2  loss" in printed
    assert json.loads(printed[printed.index("\n{") + 1:]) == out
    assert ckpt.latest_step(tmp_path / "ck") == 4


def test_train_shape_cell_takes_the_cells_shape(tmp_path):
    loop = train_shape_cell(reduce_config(ARCHS["qwen3-8b"]), "train_4k",
                            "cpu", ckpt_dir=str(tmp_path), total_steps=1)
    assert (loop.data_cfg.seq_len, loop.data_cfg.global_batch) == (4096, 256)
    assert loop.loop_cfg.total_steps == 1 and loop.device.type == "cpu"


def test_chip_smoke_train_phase_on_the_host(tmp_path):
    """``chip_smoke.train_check`` at the reduced qwen3 with remat on, on the
    CPU: no kernel launched, the plain route twice a layer and microbatch
    a step, remat's gradients equal, the launcher's drill (real SIGTERM,
    resume) bit-equal to the uninterrupted run, the host against itself
    exactly."""
    import dataclasses
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernels = smoke.kernel_table()

    def counts():
        return {name: op.launches for name, (_, op) in kernels.items()}

    def zero_counts():
        for _, op in kernels.values():
            op.launches = op.device_launches = 0

    cfg = dataclasses.replace(reduce_config(ARCHS["qwen3-8b"]), remat=True)
    failures: list = []
    out = smoke.train_check(
        "host", counts, zero_counts, failures, cfg=cfg, device="cpu",
        seq=64, batch=4, micro=2, steps=2, drop=0.0,
        drill_args=("--device", "cpu"),
        drill_env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert failures == []
    assert out["routes"] == {"plain": cfg.n_layers * 2 * 2 * 2}
    assert sum(out["launches"].values()) == 0
    assert out["remat"]["bit_equal"] and out["drill"]["bit_equal"]
    assert out["drill"]["preempted_at"] == out["drill"]["resumed_at"]
    assert out["card_vs_host"]["loss_rel"] == 0.0
    assert set(out["split"]) == {"data_ms", "forward_ms", "backward_ms",
                                 "optimizer_ms"}
    assert out["bound"]["flops"] > out["bound"]["dense_flops"] > 0
