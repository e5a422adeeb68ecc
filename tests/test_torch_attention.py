"""The port's flash attention against the JAX package's: the torch oracle
against the jnp oracle, the plain version against the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it), the space, and CPU
dispatch.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed, rounded to bf16 once, and handed to
both packages, so both see the same values.

Tolerances, rel-L2:

* oracle vs oracle: 1e-6 on f32 inputs (the same f32 math, summed in
  another order).  On bf16 inputs both round the f32 result to bf16 at the
  end, and that other order flips an isolated rounding (measured: 3 to 18 of
  65,536 to 131,072 outputs, 5e-6 to 3.4e-5 rel-L2), so there fewer than
  0.1 % of the outputs may differ, within 1e-4 rel-L2.
* plain version vs Pallas: ``PALLAS_TOL`` = 5e-4, measured 4.0e-5 to
  1.5e-4 over ``PALLAS_CASES`` (XLA and PyTorch sum in other orders).  The
  plain version feeds P to the P @ V product as a bf16 high part plus the
  bf16 of the remainder, as the kernel does.  Rounding P to bf16 once
  instead moved the output by 1.8e-3 to 3.4e-3 from Pallas, as much as the
  bf16 accumulator's own rounding (2.8e-3 to 4.0e-3), so that the
  accumulator could not have been checked.  Two controls hold both
  semantics: an f32 accumulator in place of bf16, and one bf16 rounding of
  P in place of the split, each misses Pallas by more than the tolerance.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import kernel as jkernel  # noqa: E402
from repro.kernels.attention.ref import mha_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro_torch.kernels.attention import kernel, ops  # noqa: E402
from repro_torch.kernels.attention.ref import mha_reference  # noqa: E402
from repro_torch.kernels.common import config_at  # noqa: E402
from repro_torch.kernels.attention.space import (  # noqa: E402
    SMALL_SHAPE, AttentionProblem, build_space, inputs_from_numpy,
    numpy_inputs)

TOLS = (5e-3, 2e-2)     # tests/test_kernels.py TOLS["attention"]
PALLAS_TOL = 5e-4
ORACLE_TOL = 1e-6
BF16_ORACLE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores, which slowed these
    small CPU ops by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


def both(seed, hq, hkv, tq, tk, d, dtype=torch.bfloat16):
    """The same inputs as torch CPU tensors and as jnp arrays, rounded to
    bf16 once and held in ``dtype``."""
    t = inputs_from_numpy(numpy_inputs(seed, hq, hkv, tq, tk, d),
                          device="cpu")
    t = {k: v.to(dtype) if isinstance(v, torch.Tensor) else v
         for k, v in t.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = {k: jnp.asarray(v.float().numpy(), jdt)
         if isinstance(v, torch.Tensor) else v for k, v in t.items()}
    return t, j


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


ORACLE_SHAPES = [(4, 2, 256, 256, 64), (4, 2, 128, 256, 64),
                 (4, 2, 256, 256, 128), (8, 2, 128, 128, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", ORACLE_SHAPES,
                         ids=["small", "tq<tk", "d128", "g4_d128"])
def test_torch_oracle_matches_jnp_oracle(shape, causal):
    t, j = both(1, *shape, dtype=torch.float32)
    got = mha_reference(t["q"], t["k"], t["v"], causal=causal)
    want = jnp_reference(j["q"], j["k"], j["v"], causal=causal)
    assert got.dtype == torch.float32
    assert rel_l2(as_np(got), as_np(want)) <= ORACLE_TOL

    t, j = both(1, *shape)
    got = as_np(mha_reference(t["q"], t["k"], t["v"], causal=causal))
    want = as_np(jnp_reference(j["q"], j["k"], j["v"], causal=causal))
    assert (got != want).mean() < 1e-3
    assert rel_l2(got, want) <= BF16_ORACLE_TOL


def test_oracle_scale_is_computed_in_the_input_dtype():
    """The jnp oracle's default scale is 1/sqrt(d) in q's dtype: for bf16
    at d = 128 that is 0.08837890625, not 128 ** -0.5.  The torch oracle
    uses the same: with it, fewer than 0.1 % of the bf16 outputs differ
    from the jnp oracle's; with 128 ** -0.5, more than 1 % do."""
    t, j = both(6, 4, 2, 128, 128, 128)
    args = (t["q"], t["k"], t["v"])
    jscale = float(1.0 / jnp.sqrt(128).astype(jnp.bfloat16))
    assert jscale == 0.08837890625
    default = mha_reference(*args)
    assert torch.equal(default, mha_reference(*args, scale=jscale))
    want = as_np(jnp_reference(j["q"], j["k"], j["v"]))
    assert (as_np(default) != want).mean() < 1e-3
    f32_scale = as_np(mha_reference(*args, scale=128 ** -0.5))
    assert (f32_scale != want).mean() > 1e-2


def _cfg(bq, bkv, bh, skip, acc):
    return {"block_q": bq, "block_kv": bkv, "block_h": bh,
            "skip_masked": skip, "acc_dtype": acc}


#: every value of every parameter, causal and full, and tq != tk both ways;
#: each a block of whole warpgroups (64 or 128 stacked rows), as the
#: kernel's menu takes
PALLAS_CASES = [
    ((4, 2, 256, 256, 64), True, _cfg(64, 32, 1, 1, "f32")),
    ((4, 2, 256, 256, 64), True, _cfg(32, 64, 2, 0, "bf16")),
    ((4, 2, 256, 256, 64), False, _cfg(64, 128, 2, 1, "bf16")),
    ((4, 2, 256, 256, 64), False, _cfg(128, 32, 1, 0, "f32")),
    ((4, 2, 128, 256, 64), True, _cfg(64, 32, 1, 1, "bf16")),
    ((4, 2, 128, 256, 64), True, _cfg(128, 128, 1, 0, "f32")),
    ((4, 2, 256, 128, 64), True, _cfg(32, 32, 2, 1, "bf16")),
    ((4, 2, 256, 128, 64), True, _cfg(32, 64, 2, 0, "f32")),
    ((4, 2, 256, 256, 128), True, _cfg(64, 64, 1, 1, "bf16")),
    ((8, 2, 128, 256, 128), True, _cfg(16, 128, 4, 1, "f32")),
]


@pytest.mark.parametrize("shape,causal,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(shape, causal, cfg, monkeypatch):
    t, j = both(2, *shape)
    args = (t["q"], t["k"], t["v"])
    got = kernel.flash_attention_plain(*args, causal=causal, **cfg)
    want = jkernel.flash_attention(j["q"], j["k"], j["v"], causal=causal,
                                   interpret=True, **cfg)
    err = rel_l2(as_np(got), as_np(want))
    assert err <= TOLS[cfg["acc_dtype"] == "bf16"]
    assert err <= PALLAS_TOL
    if cfg["acc_dtype"] == "bf16":
        # the acc_dtype control: an f32 accumulator misses Pallas by more
        # than both tight tolerances, so neither this comparison nor the
        # kernel's on the card (kernel.PLAIN_TOL) would pass a version that
        # skipped the per-tile bf16 rounding
        f32 = kernel.flash_attention_plain(*args, causal=causal,
                                           **dict(cfg, acc_dtype="f32"))
        miss = rel_l2(as_np(f32), as_np(want))
        assert miss > max(PALLAS_TOL, kernel.PLAIN_TOL), miss
    # the P control: one bf16 rounding of P, without the low part, misses
    # Pallas by more than the tolerance
    monkeypatch.setattr(kernel, "split_bf16",
                        lambda p: p.to(torch.bfloat16).float())
    once = kernel.flash_attention_plain(*args, causal=causal, **cfg)
    assert rel_l2(as_np(once), as_np(want)) > PALLAS_TOL


@pytest.mark.parametrize("skip", [0, 1])
def test_rows_that_see_no_column(skip):
    """With tq > tk the first tq - tk rows see no column.  As in the
    reference, a q tile with no visible column gives 0 when its tiles are
    skipped, and the mean of V over the tiles it visits when they are not
    (the finite mask value makes every logit equal), never NaN."""
    t, _ = both(5, 2, 1, 256, 128, 64)
    cfg = _cfg(64, 32, 1, skip, "f32")
    out = kernel.flash_attention_plain(t["q"], t["k"], t["v"], causal=True,
                                       **cfg)
    assert torch.isfinite(out).all()
    dead = out[:, :128].float()                 # q tiles 0 and 1
    if skip:
        assert torch.equal(dead, torch.zeros_like(dead))
    else:
        mean_v = t["v"].float().mean(dim=1, keepdim=True)
        torch.testing.assert_close(dead, mean_v.expand_as(dead),
                                   rtol=1e-2, atol=1e-2)


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("shape", [AttentionProblem.default_shape,
                                   SMALL_SHAPE], ids=["full", "small"])
def test_space_compiles_and_audits_clean(shape):
    sp = build_space(*(shape[k] for k in ("hq", "hkv", "tq", "tk", "d")))
    comp = sp.compiled()
    assert 0 < comp.n_valid <= 300
    # every admitted config fits the kernel's launch check
    for cfg in comp.valid_configs():
        ops.check(*(torch.empty(s) for s in (
            (shape["hq"], shape["tq"], shape["d"]),
            (shape["hkv"], shape["tk"], shape["d"]),
            (shape["hkv"], shape["tk"], shape["d"]))), cfg)
    rep = audit_space(rebuild(sp, jspace))
    checks = {f.check for f in rep.findings}
    assert rep.ok, rep.render()
    assert not checks & {"unsatisfiable", "dead-value", "disconnected"}
    assert rep.n_components == 1


def test_full_space_size():
    """72 of 144 configs at the default shape: 6 (block_q, block_h) pairs
    that stack into 64 or 128 rows (of 12), 3 kv tiles, skip and
    accumulator.  The whole-warpgroup constraint refuses every config
    that is refused: among blocks of whole warpgroups, the shared memory
    (230,504 B at most, of 232,448) and the registers (192 at most) refuse
    nothing."""
    prob = AttentionProblem(device="cpu")
    sp = prob.space
    assert (sp.cardinality, sp.compiled().n_valid) == (144, 72)
    refused = [c for c in sp.enumerate(constrained=False)
               if not sp.satisfies(c)]
    assert all("warpgroups" in sp.violated(c) for c in refused)
    assert max(kernel.smem_bytes(c["block_q"], c["block_h"], c["block_kv"],
                                 128)
               for c in sp.valid_configs()) == 230_504
    assert sp.satisfies(ops.DEFAULT_CONFIG)


@pytest.mark.parametrize("shape", [AttentionProblem.default_shape,
                                   SMALL_SHAPE], ids=["full", "small"])
def test_default_config_is_in_the_space(shape):
    sp = build_space(*(shape[k] for k in ("hq", "hkv", "tq", "tk", "d")))
    assert all(ops.DEFAULT_CONFIG[p.name] in p.values for p in sp.params)
    assert sp.satisfies(ops.DEFAULT_CONFIG)
    assert config_at(build_space, shape, ops.DEFAULT_CONFIG,
                     ops.SEMANTIC) == ops.DEFAULT_CONFIG


@pytest.mark.parametrize("cfg,want", [
    # (block_q, block_h, block_kv, d): alignment slack + Q + the ring of
    # three K and V tiles + 13 mbarriers of 8 B
    ((128, 1, 128, 128), 1024 + 128 * 128 * 2 + 3 * 2 * 128 * 128 * 2
     + 104),
    ((64, 1, 32, 64), 1024 + 64 * 64 * 2 + 3 * 2 * 32 * 64 * 2 + 104),
    ((16, 4, 64, 128), 1024 + 64 * 128 * 2 + 3 * 2 * 64 * 128 * 2 + 104),
    ((32, 4, 128, 64), 1024 + 128 * 64 * 2 + 3 * 2 * 128 * 64 * 2 + 104),
], ids=["largest", "smallest", "stacked4", "d64"])
def test_smem_bytes_matches_a_hand_count(cfg, want):
    assert kernel.smem_bytes(*cfg) == want
    cols = [np.array([v, v]) for v in cfg]
    assert (kernel.smem_bytes(*cols) == want).all()
    assert want <= 232_448                    # what a block may have


SOURCE = Path(kernel.__file__).resolve().parents[2] / "csrc" / kernel.SOURCE


def _source_menu() -> tuple[set, dict]:
    """``FA_TILES``'s (block_kv, warpgroups) and the constants the
    shared-memory and register counts mirror, read from the CUDA source."""
    text = SOURCE.read_text()
    block = text[text.index("#define FA_TILES(X)"):]
    block = block[:block.index("\n\n")]
    tiles = {tuple(int(v) for v in t)
             for t in re.findall(r"X\((\d+), (\d+)\)", block)}
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (STAGES|ALIGN|MAX_FRAG) = (\d+);", text)}
    return tiles, consts


def test_compiled_menu_mirrors_the_source():
    tiles, consts = _source_menu()
    assert tiles == set(kernel.TILES) and len(tiles) == len(kernel.TILES) \
        == 6
    assert consts == {"STAGES": kernel.STAGES, "ALIGN": kernel.SMEM_ALIGN,
                      "MAX_FRAG": kernel.MAX_FRAG_REGS}
    assert kernel.SMEM_BARRIERS == (1 + 4 * consts["STAGES"]) * 8


@pytest.mark.parametrize("shape", [AttentionProblem.default_shape,
                                   SMALL_SHAPE, ORACLE_SHAPES[3]],
                         ids=["full", "small", "g4_d128"])
def test_every_admitted_config_is_compiled(shape):
    """The space admits exactly the compiled menu: each admitted config's
    (block_kv, warpgroups) is in ``FA_TILES`` and every tile of the
    menu is admitted; its head dim is a built variant."""
    if isinstance(shape, dict):
        shape = tuple(shape[k] for k in ("hq", "hkv", "tq", "tk", "d"))
    space = build_space(*shape)
    admitted = {(c["block_kv"], kernel.warpgroups(c["block_q"],
                                                  c["block_h"]))
                for c in space.valid_configs()}
    assert admitted == _source_menu()[0]
    assert f"d{shape[4]}" in kernel.VARIANTS


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, *SMALL_SHAPE.values())
    before = ops.attention.launches
    for _, causal, cfg in PALLAS_CASES[:4]:
        got = ops.attention(t["q"], t["k"], t["v"], causal=causal,
                            config=cfg)
        want = kernel.flash_attention_plain(t["q"], t["k"], t["v"],
                                            causal=causal, **cfg)
        assert torch.equal(got, want)
    assert ops.attention.launches == before


def _bad(case):
    t, _ = both(4, *SMALL_SHAPE.values())
    q, k, v = t["q"], t["k"], t["v"]
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "contiguity":
        return q.transpose(1, 2).contiguous().transpose(1, 2), k, v, cfg
    if case == "kv_shape":
        return q, k, v[:, :128].contiguous(), cfg
    if case == "heads":
        return q[:3].contiguous(), k, v, cfg             # 3 q heads, 2 kv
    if case == "group":
        return q, k, v, dict(cfg, block_h=4)              # group of 2
    if case == "divisibility":
        return q[:, :200].contiguous(), k, v, cfg
    return q, k, v, dict(cfg, block_q=128, block_h=2)     # "warps": 256 rows


@pytest.mark.parametrize("case", ["contiguity", "kv_shape", "heads", "group",
                                  "divisibility", "warps"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    q, k, v, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.attention(q, k, v, config=cfg)
