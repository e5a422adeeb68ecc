"""``chip_smoke.py``'s ``families`` phase on the host: its plan and the
phase itself at the reduced configs.

The plan (``chip_smoke.FAMILIES``): every arch of ``configs.ARCHS`` but the
one the ``lm``, ``train`` and ``dist`` phases run, each at its published
widths, cut in depth only, its bf16 parameters (serving) and 16 bytes a
parameter (training) within the phase's budget; a MoE prompt a whole
number of the router's groups; each prompt on the route the phase expects
of it by ``kernels.common.config_at`` over the ``flash_attention_h100``
space (the flash kernel at GQA groups 1, 3, 5, 6 and 7, and the plain
route where a window, a head dim the kernel is not built for, or MLA
rule it out).  Then the phase run on the CPU at the reduced configs
(``reduce_config``) with small prompts: every family served, its
training step taken, the plain route's counts exact (``lm_check``'s own
checks), no kernel launched (the CPU takes no kernel), and part (d)'s four
runs (the host's in f32 and bf16, and two more standing for the card's)
within their bounds.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduce_config  # noqa: E402
from repro_torch.kernels.attention.space import build_space  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = _smoke()
FAMILIES = smoke.FAMILIES
GIB = 2.0 ** 30
#: the route each family's prompts take on the card, and its GQA group
#: where the kernel takes it
ROUTE = {"granite-moe-3b-a800m": 3, "deepseek-v2-236b": None,
         "deepseek-coder-33b": 7, "qwen3-14b": 5, "internvl2-26b": 6,
         "gemma3-27b": None, "recurrentgemma-9b": None, "rwkv6-1.6b": None,
         "whisper-medium": 1}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_families_are_every_arch_but_the_lm_phases():
    assert sorted(FAMILIES) == sorted(set(ARCHS) - {smoke.LM_ARCH})
    assert smoke.LM_ARCH == smoke.TRAIN_ARCH == "qwen3-8b"


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_the_plan_cuts_depth_alone_and_fits_the_budget(arch):
    """Every field of the config the phase builds is the published one but
    the decoder's depth; serving keeps a whole period of the pattern; the
    bf16 parameters and, where a family trains, 16 bytes a parameter are
    within ``FAMILY_BUDGET_GIB``; a family that does not train could not
    at one layer."""
    fam = FAMILIES[arch]
    pub = ARCHS[arch]
    for layers in filter(None, (fam.serve, fam.train)):
        cfg = smoke.family_config(arch, layers)
        assert dataclasses.replace(cfg, n_layers=pub.n_layers) == pub
        assert 1 <= layers <= pub.n_layers
    serve = smoke.family_config(arch, fam.serve)
    assert fam.serve >= len(pub.pattern)
    assert serve.param_count() * 2 / GIB <= smoke.FAMILY_BUDGET_GIB
    one = smoke.family_config(arch, fam.train or 1)
    fits = one.param_count() * 16 / GIB <= smoke.FAMILY_BUDGET_GIB
    assert fits == (fam.train is not None)


def test_the_plan_is_the_issues_table():
    """Depths and reckoned sizes (GiB, 2 and 16 bytes a parameter)."""
    want = {"granite-moe-3b-a800m": (32, 6.14, 8, 13.13),
            "deepseek-v2-236b": (2, 15.77, None, None),
            "deepseek-coder-33b": (4, 4.38, 2, 19.25),
            "qwen3-14b": (4, 3.91, 2, 21.44),
            "internvl2-26b": (4, 3.97, 2, 20.10),
            "gemma3-27b": (6, 7.47, 1, 27.46),
            "recurrentgemma-9b": (3, 3.24, 3, 25.91),
            "rwkv6-1.6b": (4, 0.77, 4, 6.12),
            "whisper-medium": (24, 1.41, 24, 11.29)}
    for arch, (serve, s_gib, train, t_gib) in want.items():
        fam = FAMILIES[arch]
        assert (fam.serve, fam.train) == (serve, train)
        got = smoke.family_config(arch, serve).param_count() * 2 / GIB
        assert got == pytest.approx(s_gib, abs=5e-3)
        if train:
            got = smoke.family_config(arch, train).param_count() * 16 / GIB
            assert got == pytest.approx(t_gib, abs=5e-3)
    assert smoke.family_config("deepseek-v2-236b", 1).param_count() * 16 \
        / GIB == pytest.approx(67.0, abs=5e-3)


@pytest.mark.parametrize("arch", sorted(a for a in FAMILIES
                                        if ARCHS[a].n_experts))
def test_moe_prompts_are_whole_groups(arch):
    """The reference's ``x.reshape(g, gs, d)`` takes a token count that is
    a multiple of ``moe_group`` or at most one group: every prompt and the
    training sequence."""
    cfg, fam = ARCHS[arch], FAMILIES[arch]
    for n in (*fam.kernel, *fam.plain, smoke.FAMILY_SEQ):
        assert n <= cfg.moe_group or n % cfg.moe_group == 0, n
    if arch == "deepseek-v2-236b":
        assert max(fam.plain) <= 2048     # MLA's plain scores, 2.1 GiB


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_each_prompt_takes_the_route_of_the_table(arch):
    """On the card a kernel prompt takes the flash kernel in every causal
    self-attention layer without a window (``attention_routes``, by
    ``config_at``), a plain prompt in none; the kernel families' GQA
    groups are 1, 3, 5, 6 and 7, their ``block_h`` what the space allows;
    the others have no kernel prompt."""
    fam = FAMILIES[arch]
    cfg = smoke.family_config(arch, fam.serve)
    group = ROUTE[arch]
    assert bool(fam.kernel) == (group is not None)
    assert fam.plain and all(n + smoke.FAMILY_NEW <= smoke.FAMILY_MAX_LEN
                             for n in (*fam.kernel, *fam.plain))
    specs = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    for n in fam.kernel:
        r = smoke.attention_routes(cfg, n)
        assert r["kernel"] == cfg.n_layers == sum(
            s.kind == "attn" and not s.window for s in specs)
        assert cfg.n_heads // cfg.n_kv_heads == group
        space = build_space(cfg.n_heads, cfg.n_kv_heads, n, n, cfg.d_head)
        block_h = {c["block_h"] for c in space.valid_configs()}
        assert block_h == ({1, 2} if group == 6 else {1})
    for n in fam.plain:
        assert smoke.attention_routes(cfg, n)["kernel"] == 0
    if cfg.frontend == "vision":
        r = smoke.attention_routes(cfg, smoke.VISION_PATCHES
                                   + smoke.VISION_TEXT)
        assert r["kernel"] == cfg.n_layers


def test_the_families_phase_on_the_host():
    """``families_check`` on the CPU at every family's reduced config, with
    prompts of 32 and 64 tokens (the reduced MoE's 16-token groups) and
    one of 48 on the plain route: every request completes, every count is
    what ``lm_check`` and the training step expect (no kernel launched,
    the plain route's calls exact), the vision prefix runs, and part
    (d)'s four runs stay within their bounds, the two f32 runs (both
    processes of their own, at one thread count) equal."""
    reduced = smoke.start_reduced_runs()
    kernels = smoke.kernel_table()

    def counts():
        return {name: op.launches for name, (_, op) in kernels.items()}

    def zero_counts():
        for _, op in kernels.values():
            op.launches = op.device_launches = 0

    fams = {a: smoke.Family(f.serve, f.train, (32, 64) if f.kernel else (),
                            (48,) if f.kernel else (32, 48))
            for a, f in FAMILIES.items()}
    failures: list = []
    out = smoke.families_check(
        "host", counts, zero_counts, failures, reduced=reduced,
        device="cpu", families=fams,
        config=lambda arch, layers: reduce_config(ARCHS[arch]), seq=64,
        max_len=80, vision=(4, 60))
    assert failures == []
    assert out["launches"] == 0
    assert sorted(out["families"]) == sorted(FAMILIES)
    for arch, row in out["families"].items():
        serve = row["serve"]
        assert serve["launches"] == 0 and serve["plan_tier"] == "default"
        assert serve["generated_tokens"] == smoke.FAMILY_NEW * len(
            fams[arch].kernel + fams[arch].plain)
        assert {p["route"] for p in serve["prefills"]} == {"plain"}
        assert (serve["compare"] is None) == (not fams[arch].kernel)
        if serve["compare"]:
            assert serve["compare"]["rel_l2"] == 0.0
        assert ("train" in row) == (FAMILIES[arch].train is not None)
        if "train" in row:
            assert row["train"]["launches"] == 0
            assert set(row["train"]["routes"]) <= {"plain"}
    assert out["families"]["internvl2-26b"]["vision"]["rel_l2"] == 0.0
    assert sorted(out["reduced"]) == sorted(ARCHS)
    for r in out["reduced"].values():
        assert r["f32_rel"] == 0.0 and r["bf16_over"] == []
        assert all(r["argmax_agrees"].values())
        assert len(r["tokens_fed"]) == smoke.REDUCED_DECODE
    assert [r["rc"] for r in out["reduced_runs"]] == [0, 0, 0]


def test_pinned_routing_replays_the_recorded_experts():
    """``chip_smoke.pinned_routing`` records a prefill's top-k expert
    choices and replays them: on the same model the replayed prefill
    equals the recorded one to the bit, and on a model whose routers were
    moved far enough to change its own choices, every MoE layer takes the
    recorded experts."""
    from repro_torch.models import build_model, moe

    cfg = reduce_config(ARCHS["granite-moe-3b-a800m"])
    model = build_model(cfg).init(0, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 48),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    choices: list = []
    with smoke.pinned_routing(choices):
        want = model.prefill(batch)[0]
    assert len(choices) == cfg.n_layers
    with smoke.pinned_routing(choices):
        got = model.prefill(batch)[0]
    assert torch.equal(got, want)
    with torch.no_grad():
        for b in model.blocks:
            b.moe.router.mul_(-1.0)
    own: list = []
    with smoke.pinned_routing(own):
        model.prefill(batch)
    assert any(not torch.equal(a, b) for a, b in zip(own, choices))
    used = []
    dispatch = moe._dispatch

    def spy(gate_vals, idx, *args):
        used.append(idx)
        return dispatch(gate_vals, idx, *args)

    moe._dispatch = spy
    try:
        with smoke.pinned_routing(choices):
            model.prefill(batch)
    finally:
        moe._dispatch = dispatch
    assert len(used) == len(choices)
    assert all(torch.equal(u, c) for u, c in zip(used, choices))
