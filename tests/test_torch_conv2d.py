"""The port's 2-D convolution against the JAX package's: the torch oracle
against the jnp oracle, the plain version against the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it), the space, and CPU
dispatch.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed in f32 and handed to both packages.

Tolerances, rel-L2:

* oracle vs oracle: ``ORACLE_TOL`` 1e-6 (both f32 convolutions).
* plain version vs Pallas: with a bf16 accumulator, exact (0 mismatches):
  both round the image and filter values, each product and each running
  sum to bf16, tap by tap, i outer and j inner.  With an f32 accumulator,
  ``PALLAS_TOL`` 1e-6 (measured 8.7e-8: XLA and PyTorch round the same
  taps, but not always as one fused multiply-add).  The control: the f32
  plain version misses a bf16 Pallas run by about 6e-3, far more than
  either bound.  The Pallas kernel is compiled with XLA's excess precision
  off, so that bf16 is rounded where the reference's code says.
* plain version vs the torch oracle: the JAX package's ``TOLS["conv2d"]``,
  5e-3 (f32) and 3e-2 (bf16).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.conv2d import kernel as jkernel  # noqa: E402
from repro.kernels.conv2d.ref import conv2d_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.common import fitting_config  # noqa: E402
from repro_torch.kernels.conv2d import kernel, ops  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_reference  # noqa: E402
from repro_torch.kernels.conv2d.space import (  # noqa: E402
    SMALL_SHAPE, TILE_SHAPES, Conv2dProblem, build_space, numpy_inputs,
    tile_configs)

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "csrc" / "conv2d.cu"
TOLS = {"f32": 5e-3, "bf16": 3e-2}     # tests/test_kernels.py TOLS["conv2d"]
PALLAS_TOL = 1e-6
ORACLE_TOL = 1e-6


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


def both(seed, h, w, fh, fw):
    """The same f32 inputs as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, h, w, fh, fw)
    return ({k: torch.from_numpy(a) for k, a in x.items()},
            {k: jnp.asarray(a) for k, a in x.items()})


@pytest.mark.parametrize("shape", [(48, 160, 5, 5), (64, 96, 15, 15),
                                   (33, 47, 3, 7)],
                         ids=["small", "f15", "ragged"])
def test_torch_oracle_matches_jnp_oracle(shape):
    t, j = both(1, *shape)
    got = conv2d_reference(t["image"], t["filt"])
    want = jnp_reference(j["image"], j["filt"])
    assert got.dtype == torch.float32
    assert got.shape == (shape[0] - shape[2] + 1, shape[1] - shape[3] + 1)
    assert rel_l2(got.numpy(), want) <= ORACLE_TOL


def _cfg(bh, bw, ufh, ufw, rc, acc, fsmem):
    return {"block_h": bh, "block_w": bw, "unroll_fh": ufh, "unroll_fw": ufw,
            "row_chunk": rc, "acc_dtype": acc, "filter_smem": fsmem}


#: every value of every parameter, at the small shape (5 x 5 filter: the
#: unroll factors snap to 1 or 5) and with a 15 x 15 filter
SMALL = tuple(SMALL_SHAPE.values())
F15 = (40, 80, 15, 15)
PALLAS_CASES = [
    (SMALL, _cfg(1, 32, 1, 5, 1, "f32", 0)),
    (SMALL, _cfg(2, 32, 5, 1, 2, "bf16", 1)),
    (SMALL, _cfg(4, 64, 3, 15, 4, "bf16", 0)),
    (SMALL, _cfg(16, 128, 15, 3, 8, "f32", 1)),
    (SMALL, _cfg(64, 256, 5, 5, 8, "bf16", 1)),
    (F15, _cfg(8, 32, 3, 5, 2, "f32", 0)),
    (F15, _cfg(32, 16, 15, 1, 4, "bf16", 1)),
    (F15, _cfg(16, 64, 1, 15, 1, "bf16", 0)),
    (F15, _cfg(4, 128, 5, 3, 4, "f32", 1)),
]


def pallas(j, cfg):
    """The Pallas kernel in interpret mode with XLA's excess precision off,
    so bf16 values are rounded where the reference's code rounds them."""
    f = jax.jit(functools.partial(jkernel.conv2d, interpret=True,
                                  **dict(cfg, filter_smem=bool(
                                      cfg["filter_smem"]))),
                compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(f(j["image"], j["filt"]))


@pytest.mark.parametrize("shape,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(shape, cfg):
    t, j = both(2, *shape)
    got = kernel.conv2d_plain(t["image"], t["filt"], **cfg).numpy()
    want = pallas(j, cfg)
    if cfg["acc_dtype"] == "bf16":
        assert int((got != want).sum()) == 0
        # the acc_dtype control: an f32 accumulator misses by far more than
        # the tight bounds here and on the card (kernel.PLAIN_TOL)
        f32 = kernel.conv2d_plain(t["image"], t["filt"],
                                  **dict(cfg, acc_dtype="f32")).numpy()
        assert rel_l2(f32, want) > max(PALLAS_TOL, kernel.PLAIN_TOL)
    else:
        assert rel_l2(got, want) <= PALLAS_TOL
    oracle = conv2d_reference(t["image"], t["filt"]).numpy()
    assert rel_l2(got, oracle) <= TOLS[cfg["acc_dtype"]]


def test_snap_unroll_is_the_references():
    for f in (5, 7, 15):
        for u in kernel.UNROLL:
            got = kernel.snap_unroll(u, f)
            assert f % got == 0 and got <= u
            assert not any(f % v == 0 for v in range(got + 1, min(u, f) + 1))
    # one build per (filter size, row unroll, accumulator), and with the
    # rows unrolled whole one per filter home
    assert set(kernel.VARIANTS) == {
        f"f{f}_u{u}_{acc}" + (f"_fs{fs}" if u == f else "")
        for f, us in ((5, (1, 5)), (15, (1, 3, 5, 15)))
        for u in us for acc in ("f32", "bf16") for fs in (0, 1)}
    assert len(kernel.VARIANTS) == 16
    assert kernel.VARIANTS["f15_u15_bf16_fs1"] == {
        "CONV_F": 15, "CONV_UFH": 15, "CONV_ACC_BF16": 1, "CONV_FSMEM": 1}
    assert "CONV_FSMEM" not in kernel.VARIANTS["f15_u5_f32"]


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("shape", [Conv2dProblem.default_shape, SMALL_SHAPE],
                         ids=["full", "small"])
def test_space_compiles_and_audits_clean(shape):
    sp = build_space(*(shape[k] for k in ("h", "w", "fh", "fw")))
    rep = audit_space(rebuild(sp, jspace))
    checks = {f.check for f in rep.findings}
    assert rep.ok, rep.render()
    assert not checks & {"unsatisfiable", "dead-value", "disconnected"}
    assert rep.n_components == 1
    scalar_only = tspace.SearchSpace(
        sp.params, [tspace.Constraint(c.name, c.fn) for c in sp.constraints],
        name=sp.name + "_scalar")
    assert np.array_equal(sp.compiled().mask, scalar_only.compiled().mask)
    # every admitted config fits the kernel's launch check
    image = torch.empty((shape["h"], shape["w"]))
    filt = torch.empty((shape["fh"], shape["fw"]))
    for cfg in sp.compiled().valid_configs():
        ops.check(image, filt, cfg)


def test_space_sizes():
    """6112 of 12 288 configs at the default shape: a compiled row_chunk x
    col_chunk tile in a block of 128 threads to its launch bound (512, 384
    for the bf16 8 x 4 tile), at least 8 a row."""
    prob = Conv2dProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (12288, 6112)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)


def _source_menu() -> tuple[set, dict]:
    """``CONV_TILES``'s (row_chunk, col_chunk), the unroll_fw values each
    is built at, and the launch bound ``CONV_MAX_THREADS``, read from the
    CUDA source."""
    text = SOURCE.read_text()
    block = text[text.index("#define CONV_TILES(X)"):]
    block = block[:block.index("\n\n")]
    tiles = {tuple(int(v) for v in t)
             for t in re.findall(r"X\((\d+), (\d+)\)", block)}
    ufw = text[text.index("#define CONV_UFW("):]
    ufw = ufw[:ufw.index("\n\n")]
    unrolls = tuple(int(u) for u in re.findall(r"RX_, (\d+)\)", ufw))
    bound = re.search(r"#define CONV_MAX_THREADS\(RY, RX\) \(CONV_ACC_BF16 "
                      r"&& \(RY\) \* \(RX\) >= (\d+) \? (\d+) : (\d+)\)",
                      text).groups()
    return tiles, {"unroll_fw": unrolls,
                   "bound": tuple(int(v) for v in bound)}


def test_compiled_menu_mirrors_the_source():
    tiles, consts = _source_menu()
    assert tiles == set(kernel.TILES) and len(kernel.TILES) == len(tiles) \
        == 12
    wide, narrow = consts["bound"][1:]
    assert consts["unroll_fw"] == kernel.UNROLL
    assert (wide, narrow) == (kernel.WIDE_BF16_THREADS, kernel.MAX_THREADS)
    for rc, cc in kernel.TILES:
        for acc in ("f32", "bf16"):
            want = wide if acc == "bf16" and rc * cc >= consts["bound"][0] \
                else narrow
            assert kernel.max_threads(rc, cc, acc) == want


@pytest.mark.parametrize("shape", [Conv2dProblem.default_shape, SMALL_SHAPE],
                         ids=["full", "small"])
def test_every_admitted_config_is_compiled(shape):
    """Each admitted config names a compiled tile of a built library, and
    at the default shape every compiled tile is admitted."""
    f = shape["fh"]
    space = build_space(*(shape[k] for k in ("h", "w", "fh", "fw")))
    admitted = set()
    for c in space.valid_configs():
        admitted.add((c["row_chunk"], c["col_chunk"]))
        assert kernel.variant(f, c["unroll_fh"], c["acc_dtype"],
                              c["filter_smem"]) in kernel.VARIANTS
        assert f % kernel.snap_unroll(c["unroll_fw"], f) == 0
    assert admitted <= set(kernel.TILES)
    if shape is Conv2dProblem.default_shape:
        assert admitted == set(kernel.TILES)


def test_shared_memory_and_registers_by_hand():
    """The shared memory a block takes and the register budget the space
    charges (each tile's launch bound), counted by hand."""
    # 64 x 128 outputs at F 15: 78 rows of 142 floats padded to 144, and
    # the filter's 15 rows padded to 16 words
    assert kernel.pitch(128, 15) == 144
    assert kernel.smem_bytes(64, 128, 15, 0) == 78 * 144 * 4 == 44928
    assert kernel.smem_bytes(64, 128, 15, 1) == (78 * 144 + 15 * 16) * 4
    # 8 x 32 at F 5: 12 rows of 36 floats (already a multiple of 4), the
    # filter's 5 rows padded to 8
    assert kernel.smem_bytes(8, 32, 5, 1) == (12 * 36 + 5 * 8) * 4
    # the largest block: 78 rows of 272 floats, 86 KB, well within 227 KB
    assert kernel.smem_bytes(64, 256, 15, 1) == (78 * 272 + 240) * 4 == 85824
    # the register file (65 536) over a launch bound, in ptxas's units of
    # 8: 512 threads leave 128 registers a thread, 384 leave 170, so 168
    assert [65536 // t // 8 * 8 for t in (512, 384)] == [128, 168]
    # every tile at 512 threads but the bf16 ones of 32 outputs (8 x 4),
    # whose filter-in-shared-memory build spilled at 128 registers
    assert kernel.max_threads(8, 4, "f32") == 512
    assert kernel.max_threads(8, 4, "bf16") == 384
    assert kernel.max_threads(4, 4, "bf16") == 512
    space = build_space(**Conv2dProblem.default_shape)
    cfg = dict(ops.DEFAULT_CONFIG, block_h=64, block_w=256, row_chunk=8,
               col_chunk=4, unroll_fh=15, unroll_fw=15)
    assert kernel.threads(64, 256, 8, 4) == 512
    assert space.satisfies(dict(cfg, acc_dtype="f32"))
    assert not space.satisfies(dict(cfg, acc_dtype="bf16"))
    assert space.satisfies(dict(cfg, block_w=128, acc_dtype="bf16"))


def test_loads_per_fma():
    """Shared words a thread reads per FMA: (RY + UFH - 1)(RX + UFW - 1) /
    (RY RX UFH UFW), plus 1 / RX with the filter in shared memory."""
    four_by_eight = dict(ops.DEFAULT_CONFIG, row_chunk=8, col_chunk=4,
                         unroll_fh=15, unroll_fw=15, filter_smem=0)
    assert kernel.loads_per_fma(four_by_eight, 15) \
        == pytest.approx(18 * 22 / (8 * 4 * 225)) == pytest.approx(0.055)
    d = ops.DEFAULT_CONFIG
    ry, rx = d["row_chunk"], d["col_chunk"]
    assert kernel.loads_per_fma(d, 15) == pytest.approx(
        (ry + 14) * (rx + 14) / (ry * rx * 225) + d["filter_smem"] / rx)
    # one column a thread, rows rolled, as before register blocking: a read
    # a tap
    one = dict(d, row_chunk=1, col_chunk=1, unroll_fh=1, unroll_fw=15,
               filter_smem=0)
    assert kernel.loads_per_fma(one, 15) == pytest.approx(1.0)
    # rolled 5-tap column chunks re-read 4 of every 8 window values
    assert kernel.loads_per_fma(dict(four_by_eight, unroll_fw=5), 15) \
        == pytest.approx(22 * 8 / (8 * 4 * 15 * 5))
    assert kernel.loads_per_fma(dict(four_by_eight, filter_smem=1), 15) \
        == pytest.approx(0.055 + 0.25)
    # at F 5 the unroll factors snap to 5
    assert kernel.loads_per_fma(four_by_eight, 5) \
        == pytest.approx(12 * 8 / (8 * 4 * 25))


@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=[f"{h}x{w}_f{f}" for h, w, f, _ in TILE_SHAPES])
def test_tile_configs_cover_every_compiled_tile(shape):
    """The card's parity set: one admitted config for every compiled tile
    of the filter size's libraries, on an output no block divides."""
    h, w, f, _ = shape
    cfgs = tile_configs(*shape)
    space = build_space(*shape)
    units = sorted({kernel.snap_unroll(u, f) for u in kernel.UNROLL})
    assert len(cfgs) == len(units) ** 2 * len(kernel.TILES) * 4
    assert {(c["unroll_fh"], c["row_chunk"], c["col_chunk"], c["unroll_fw"],
             c["acc_dtype"], c["filter_smem"]) for c in cfgs} \
        == {(uh, rc, cc, uw, a, fs) for uh in units for rc, cc in kernel.TILES
            for uw in units for a in ("f32", "bf16") for fs in (0, 1)}
    assert all(space.satisfies(c) for c in cfgs)
    oh, ow = h - f + 1, w - f + 1
    assert all(oh % c["block_h"] and ow % c["block_w"] for c in cfgs)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    """The first Pallas cases' configs, each as the admitted config nearest
    to it (one column a thread) that keeps its unroll factors (snapped to
    the filter), accumulator and filter home."""
    t, _ = both(3, *SMALL)
    space = build_space(*SMALL)
    f = SMALL_SHAPE["fh"]
    before = ops.conv2d.launches
    for _, case in PALLAS_CASES[:4]:
        snapped = {k: kernel.snap_unroll(case[k], f)
                   for k in ("unroll_fh", "unroll_fw")}
        cfg = fitting_config(space, dict(case, col_chunk=1, **snapped), (
            "unroll_fh", "unroll_fw", "acc_dtype", "filter_smem"))
        got = ops.conv2d(t["image"], t["filt"], cfg)
        assert torch.equal(got, kernel.conv2d_plain(t["image"], t["filt"],
                                                    **cfg))
    assert ops.conv2d.launches == before


def _bad(case):
    t, _ = both(4, *SMALL)
    image, filt = t["image"], t["filt"]
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "dtype":
        return image.double(), filt, cfg
    if case == "square":
        return image, filt[:3].contiguous(), cfg
    if case == "contiguity":
        return image.t().contiguous().t(), filt, cfg
    if case == "row_chunk":
        return image, filt, dict(cfg, block_h=2, row_chunk=4)
    if case == "threads":
        return image, filt, dict(cfg, block_h=64, block_w=256, row_chunk=1)
    return image, filt, dict(cfg, block_w=48)               # "menu"


@pytest.mark.parametrize("case", ["dtype", "square", "contiguity",
                                  "row_chunk", "threads", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    image, filt, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.conv2d(image, filt, cfg)
