"""The port's serving engine (``repro_torch.serve``) and launcher
(``repro_torch.launch.serve``) on the CPU.

Greedy completions equal the JAX engine's token for token, on the same
weights and prompts, for all ten archs: GQA ones (qwen3-8b, qwen3-14b,
deepseek-coder), a windowed one whose prompt outgrows its ring buffer
(gemma3), two recurrent ones (recurrentgemma, rwkv6), the encoder-decoder
(whisper), MLA + MoE (deepseek-v2), MoE (granite) and the vision one's
text path (internvl2), with more requests than slots.  The JAX engine's prefill and decode are
compiled with XLA's excess precision off (``torch_lm.strict_jit``), so
that both round every bf16 result alike and a near tie of two logits
cannot fall apart by a rounding the code does not ask for.  Temperature
sampling uses a seeded ``torch.Generator``, which cannot draw what
``jax.random`` draws: it is checked for legal tokens and for determinism.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_lm import jax_model, port_model, strict_jit  # noqa: E402

from repro_torch.configs import ARCHS, reduce_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models.attention import ROUTES  # noqa: E402
from repro_torch.servedb import (STATIC_DEFAULTS, TIERS, Snapshot,  # noqa: E402
                                 publish)
from repro_torch.serve.decode import (ENC_OUT_LEN, FLASH, Request,  # noqa: E402
                                      ServeConfig, ServingEngine)

#: the archs served against the JAX engine: every one of ``ARCHS``
PARITY_ARCHS = ("qwen3-8b", "gemma3-27b", "recurrentgemma-9b", "rwkv6-1.6b",
                "whisper-medium", "deepseek-v2-236b", "granite-moe-3b-a800m",
                "internvl2-26b", "qwen3-14b", "deepseek-coder-33b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_config(**kw) -> dict:
    return {**dict(n_slots=2, max_len=64, max_new_tokens=6, temperature=0.0,
                   seed=0), **kw}


def _requests(cfg, lens, seed=0, frames=False) -> list:
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                    .astype(np.int32),
                    frames=(rng.standard_normal((ENC_OUT_LEN, cfg.d_model))
                            .astype(np.float32) if frames else None))
            for i, n in enumerate(lens)]


def _port_engine(arch="qwen3-8b", **kw) -> ServingEngine:
    return ServingEngine(port_model(arch),
                         ServeConfig(**_serve_config(device="cpu", **kw)))


def _jax_engine(arch, **kw):
    """The JAX package's engine over the same weights, its prefill and
    decode compiled strictly."""
    from repro.models import build_model
    from repro.serve.decode import ServeConfig as RefConfig
    from repro.serve.decode import ServingEngine as RefEngine
    cfg, _, params = jax_model(arch)
    model = build_model(cfg)
    model.prefill = strict_jit(model.prefill)
    engine = RefEngine(model, RefConfig(**_serve_config(**kw)),
                       params=params)
    engine._decode = strict_jit(engine._decode_fn)
    return engine


def _run(engine, reqs) -> dict:
    for r in reqs:
        engine.submit(r)
    return {c.uid: (c.tokens, c.finished_reason) for c in engine.run()}


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_greedy_completions_equal_the_jax_engines(arch):
    """Three requests on two slots (the third waits for a slot); prompts of
    7 and 41 tokens, 41 past the reduced window of 32 rows; whisper's
    requests carry ``ENC_OUT_LEN`` frames.  A MoE prefill groups its tokens
    by ``moe_group`` (16 reduced), so deepseek's long prompt is 32 (both
    packages refuse 41: a group count that does not divide the tokens)."""
    cfg = reduce_config(ARCHS[arch])
    long = 32 if cfg.n_experts else 41
    reqs = _requests(cfg, (7, long, 7), frames=cfg.frontend == "audio")
    want = _run(_jax_engine(arch), reqs)
    engine = _port_engine(arch)
    got = _run(engine, reqs)
    assert got == want
    assert all(len(t) == 6 and r == "length" for t, r in got.values())
    assert [p["uid"] for p in engine.prefills] == [0, 1, 2]
    assert {p["route"] for p in engine.prefills} == {"plain"}   # the CPU


def test_continuous_batching_mixes_sequence_lengths():
    """Slots admitted at different times decode in the same lockstep batch
    at their own positions; five requests on two slots all complete."""
    engine = _port_engine(max_new_tokens=6)
    cfg = engine.model.cfg
    reqs = _requests(cfg, (4, 9, 3, 11, 5))
    engine.submit(reqs[0])
    engine.step()                    # admit r0 alone
    for r in reqs[1:]:
        engine.submit(r)
    engine.step()                    # r1 joins mid-flight
    assert engine.active.all()
    assert engine.positions[0] != engine.positions[1]
    done = engine.run()
    assert sorted(c.uid for c in done) == list(range(5))
    assert all(len(c.tokens) == 6 for c in done)
    assert len(engine.decode_ms) == engine.steps


def test_greedy_decode_matches_full_forward():
    """Prefill + spliced cache + decode steps give what greedy decoding by
    full-sequence forwards gives (the no-cache oracle)."""
    engine = _port_engine(n_slots=1, max_new_tokens=4, max_len=32)
    prompt = np.asarray([5, 9, 2], np.int32)
    engine.submit(Request(uid=0, prompt=prompt))
    (completion,) = engine.run()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(4):
            logits, _, _ = engine.model.forward(
                {"tokens": np.asarray(toks, np.int64)[None]})
            toks.append(int(torch.argmax(logits[0, -1])))
    assert completion.tokens == toks[3:]


def test_eos_frees_slot_early():
    engine = _port_engine(n_slots=1, max_new_tokens=50, max_len=64)
    probe = _requests(engine.model.cfg, (5,))[0]
    first = _run(engine, [probe])[0][0][0]
    engine2 = _port_engine(n_slots=1, max_new_tokens=50, max_len=64,
                           eos_token=first)
    (tokens, reason), = _run(engine2, [probe]).values()
    assert reason == "eos" and tokens == [first]
    assert not engine2.active.any()


def test_a_request_past_max_len_is_refused():
    engine = _port_engine(max_len=16, max_new_tokens=8)
    with pytest.raises(ValueError, match="exceeds max_len"):
        engine.submit(Request(uid=0, prompt=np.zeros(9, np.int32)))


def test_temperature_sampling_is_legal_and_seeded():
    cfg = reduce_config(ARCHS["qwen3-8b"])
    reqs = _requests(cfg, (6, 6, 9))
    runs = [_run(_port_engine(temperature=1.5, seed=s), reqs)
            for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    for run in runs:
        for tokens, _ in run.values():
            assert len(tokens) == 6
            assert all(0 <= t < cfg.vocab for t in tokens)
    assert runs[0] != runs[2]


def test_the_plan_without_a_find_db_is_the_static_default():
    engine = _port_engine()
    plan = engine.kernel_plan[FLASH]
    assert plan.tier == "default" and engine.cfg.arch == "h100"
    assert plan.shape == {"hq": 4, "hkv": 2, "tq": 64, "tk": 64, "d": 16}
    assert engine.kernel_config(FLASH) == STATIC_DEFAULTS[FLASH]
    assert engine.kernel_config("unknown") == {}


def test_the_plan_from_a_snapshot(tmp_path):
    """A snapshot holding the engine's attention shape under ``h100`` plans
    its config (exact); an empty find-DB degrades and the engine serves."""
    cfg = reduce_config(ARCHS["qwen3-8b"])
    tuned = dict(STATIC_DEFAULTS[FLASH], block_q=64, block_kv=64)
    shape = {"hq": 4, "hkv": 2, "tq": 64, "tk": 64, "d": 16}
    publish(Snapshot(tables={FLASH: {"h100": {
        "param_names": sorted(tuned), "heuristic": None,
        "entries": [{"shape": shape, "config": tuned, "objective": 1e-4,
                     "protocol": "session_x", "trials": 72}]}}}),
            tmp_path / "db")
    engine = _port_engine(servedb=str(tmp_path / "db"))
    assert engine.kernel_plan[FLASH].tier == "exact"
    assert engine.kernel_config(FLASH) == tuned
    (tokens, _), = _run(engine, _requests(cfg, (5,))).values()
    assert len(tokens) == 6

    empty = _port_engine(servedb=str(tmp_path / "empty"))
    assert empty.kernel_plan[FLASH].tier in TIERS[1:]
    assert len(_run(empty, _requests(cfg, (5,)))) == 1


def test_the_launcher_serves_on_the_host(capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu``: every
    request completes, each prefill timed and routed (plain on the CPU,
    one attention call a layer), the JSON summary printed."""
    before = dict(ROUTES)
    out = launcher.main(["--arch", "qwen3-8b", "--reduced", "--device",
                         "cpu", "--requests", "3", "--slots", "2",
                         "--max-new", "4"])
    assert out["requests"] == 3 and out["generated_tokens"] == 12
    assert set(out["finished"].values()) == {"length"}
    assert out["device"] == "cpu" and out["plan_tier"] == "default"
    layers = reduce_config(ARCHS["qwen3-8b"]).n_layers
    assert out["attention_routes"] == {"kernel:plan": 0,
                                       "kernel:resolved": 0,
                                       "plain": 3 * layers}
    assert ROUTES["plain"] - before.get("plain", 0) == 3 * layers
    assert out["attention_launches"] == 0
    assert [route for _, route in out["prefill_ms"].values()] == \
        ["plain"] * 3
    assert out["decode_step_ms_median"] > 0
    assert '"requests": 3' in capsys.readouterr().out


def test_the_launcher_serves_whisper_with_its_frames():
    """The encoder-decoder's requests carry ``ENC_OUT_LEN`` frames, the
    engine's fixed encoder length."""
    out = launcher.main(["--arch", "whisper-medium", "--reduced", "--device",
                         "cpu", "--requests", "2", "--max-new", "3"])
    assert out["requests"] == 2 and out["generated_tokens"] == 6


def test_chip_smoke_lm_phase_on_the_host(tmp_path):
    """``chip_smoke.lm_check`` at the reduced qwen3 on the CPU, planned
    from a snapshot that holds its attention shape: every request served,
    every kernel's count 0 (the kernel takes no CPU tensor: no prompt is
    the kernel's here), the plain route once a layer a prompt, the
    comparison of the two routes exact (both plain)."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduce_config(ARCHS["qwen3-8b"])
    shape = {"hq": 4, "hkv": 2, "tq": 64, "tk": 64, "d": 16}
    tuned = dict(STATIC_DEFAULTS[FLASH], block_q=64)
    publish(Snapshot(tables={FLASH: {"h100": {
        "param_names": sorted(tuned), "heuristic": None,
        "entries": [{"shape": shape, "config": tuned, "objective": 1e-4,
                     "protocol": "session_x", "trials": 72}]}}}),
            tmp_path / "db")
    kernels = smoke.kernel_table()

    def counts():
        return {name: op.launches for name, (_, op) in kernels.items()}

    def zero_counts():
        for _, op in kernels.values():
            op.launches = op.device_launches = 0

    failures: list = []
    out = smoke.lm_check(tmp_path / "db", "host", counts, zero_counts,
                         failures, cfg=cfg, device="cpu", kernel_prompts=(),
                         plain_prompts=(9, 17, 12), compare=17, max_len=64)
    assert failures == []
    assert out["plan_tier"] == "exact" and out["plan_config"] == tuned
    assert out["routes"] == {"plain": 3 * cfg.n_layers}
    assert out["launches"] == 0 and out["compare"]["rel_l2"] == 0.0
    assert out["generated_tokens"] == 3 * smoke.LM_NEW
    assert [p["route"] for p in out["prefills"]] == ["plain"] * 3
    # a check that fails is reported, not raised
    smoke.lm_check(tmp_path / "db", "host", counts, zero_counts, failures,
                   cfg=cfg, device="cpu", kernel_prompts=(),
                   plain_prompts=(9,), compare=9, max_len=64,
                   want_tier="default")
    assert failures == ["lm: plan tier exact, want default"]
