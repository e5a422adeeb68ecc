"""The port's Hotspot stencil against the JAX package's: the torch oracle
against the jnp oracle, the plain version against the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it), the space, and CPU
dispatch.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed in f32 and handed to both packages.

Tolerances, rel-L2, on the central crop the reference compares (outside it
the Pallas result depends on its tiles):

* oracle vs oracle: ``ORACLE_TOL`` 1e-6 (the same f32 sweeps).
* plain version vs Pallas: with a bf16 accumulator, exact (0 mismatches):
  both round the temperature, the power, the five constants and every
  operation of every sweep to bf16.  With f32, ``PALLAS_TOL`` 1e-6
  (measured at most 1e-7: XLA fuses some multiply-adds, PyTorch does
  not).  The control: the f32 plain version misses a bf16 Pallas run by
  far more than either bound.  The Pallas kernel is compiled with XLA's
  excess precision off, so that bf16 is rounded where the reference's code
  says.
* plain version vs the torch oracle: the JAX package's ``TOLS["hotspot"]``,
  5e-3 (f32) and 3e-2 (bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.hotspot import kernel as jkernel  # noqa: E402
from repro.kernels.hotspot.ref import hotspot_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.hotspot import kernel, ops  # noqa: E402
from repro_torch.kernels.hotspot.ref import hotspot_reference  # noqa: E402
from repro_torch.kernels.hotspot.space import (  # noqa: E402
    SMALL_SHAPE, HotspotProblem, build_space, crop, numpy_inputs)

TOLS = {"f32": 5e-3, "bf16": 3e-2}     # tests/test_kernels.py TOLS["hotspot"]
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


def both(seed, h, w, n):
    """The same f32 inputs as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, h, w, n)
    return ({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in x.items()},
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in x.items()})


SMALL = tuple(SMALL_SHAPE.values())
#: a domain small enough for Pallas interpret, swept more often than the
#: largest tt, so that tt 5 ends in a shorter launch (5, 5, 2)
MID = (16, 40, 12)


@pytest.mark.parametrize("shape", [SMALL, MID], ids=["small", "mid"])
def test_torch_oracle_matches_jnp_oracle(shape):
    t, j = both(1, *shape)
    n = shape[2]
    got = hotspot_reference(t["temp"], t["power"], n)
    want = jnp_reference(j["temp"], j["power"], n)
    assert got.dtype == torch.float32 and got.shape == t["temp"].shape
    assert rel_l2(got.numpy(), want) <= ORACLE_TOL


def _cfg(bh, bw, tt, u, ps, acc, order):
    return {"block_h": bh, "block_w": bw, "tt": tt, "unroll_t": u,
            "power_smem": ps, "acc_dtype": acc, "grid_order": order}


#: every value of every parameter: each block size, each tt with unroll_t
#: equal to it, both power homes, accumulators and raster orders
PALLAS_CASES = [
    (SMALL, _cfg(8, 8, 1, 1, 0, "f32", "rm")),
    (SMALL, _cfg(16, 16, 2, 2, 1, "bf16", "cm")),
    (SMALL, _cfg(32, 32, 3, 3, 0, "bf16", "rm")),
    (SMALL, _cfg(64, 64, 4, 4, 1, "f32", "cm")),
    (MID, _cfg(128, 128, 5, 5, 0, "bf16", "rm")),
    (MID, _cfg(256, 256, 6, 6, 1, "f32", "cm")),
    (MID, _cfg(8, 512, 7, 7, 1, "bf16", "cm")),
    (MID, _cfg(16, 1024, 8, 8, 0, "f32", "rm")),
    (MID, _cfg(32, 64, 9, 9, 1, "bf16", "rm")),
    (MID, _cfg(64, 32, 10, 10, 0, "f32", "cm")),
]


def pallas(j, n, cfg):
    """The Pallas kernel in interpret mode with XLA's excess precision off,
    so bf16 values are rounded where the reference's code rounds them; its
    ``keep_power_vmem`` is the port's ``power_smem``."""
    jcfg = {k: v for k, v in cfg.items() if k != "power_smem"}
    f = jax.jit(functools.partial(jkernel.hotspot, n_sweeps=n,
                                  interpret=True,
                                  keep_power_vmem=cfg["power_smem"], **jcfg),
                compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(f(j["temp"], j["power"]))


@pytest.mark.parametrize("shape,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(shape, cfg):
    t, j = both(2, *shape)
    n = shape[2]
    got = crop(kernel.hotspot_plain(t["temp"], t["power"], n, **cfg),
               n).numpy()
    want = pallas(j, n, cfg)[n:-n, n:-n]
    if cfg["acc_dtype"] == "bf16":
        assert int((got != want).sum()) == 0
        # the acc_dtype control: an f32 accumulator misses by far more than
        # the tight bounds here and on the card (kernel.PLAIN_TOL)
        f32 = crop(kernel.hotspot_plain(t["temp"], t["power"], n,
                                        **dict(cfg, acc_dtype="f32")),
                   n).numpy()
        assert rel_l2(f32, want) > max(PALLAS_TOL, kernel.PLAIN_TOL)
    else:
        assert rel_l2(got, want) <= PALLAS_TOL
    oracle = crop(hotspot_reference(t["temp"], t["power"], n), n).numpy()
    assert rel_l2(got, oracle) <= TOLS[cfg["acc_dtype"]]


def test_bf16_rounds_the_constants():
    """acc_dtype bf16 takes the constants as bf16: rx 0.1 is 0.10009765625,
    as the reference's ``jnp.asarray(v, bf16)`` rounds it."""
    c = kernel.constants("bf16")
    assert c["rx"] == c["ry"] == 0.10009765625
    assert c["step"] == 0.5 and c["amb"] == 80.0
    assert kernel.constants("f32")["rx"] == float(np.float32(0.1))


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


def test_space_compiles_and_audits_clean():
    sp = build_space()
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
    temp = torch.empty((48, 144))
    for cfg in sp.compiled().valid_configs():
        ops.check(temp, temp, 4, cfg)


def test_space_sizes():
    """2600 of 4000 configs: unroll_t dividing tt, and the tile with its
    halo on a compiled number of columns a lane (unroll_t 1 at 5) and
    within its threads' register budget.  (The shared-memory design had
    38 400 and 7652: block_w and block_h to 1024 and 256, unroll_t to 10.)"""
    prob = HotspotProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (4000, 2600)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)
    assert prob.shape == {"h": 2048, "w": 2048, "n_total": 600}


def test_register_and_shared_memory_budget_by_hand():
    """What the space charges a tile, counted by hand: a lane holds 8 rows
    x C columns of temperature (and of power with power_smem) besides 4 C
    edge and row values and about 24 more registers, within the file's
    65 536 over the threads its columns allow (ptxas's cap, in steps of
    8); shared memory is the two parities of each warp's top and bottom
    rows, 32 C floats each, under the 48 KB that needs no opt-in."""
    assert kernel.ROWS == 8 and kernel.COLS == (1, 2, 3, 5)
    budget = {c: 65536 // kernel.MAX_THREADS[c] // 8 * 8 for c in kernel.COLS}
    assert budget == {1: 80, 2: 96, 3: 128, 5: 184}
    for c in kernel.COLS:
        for ps in (0, 1):
            assert 8 * c * (1 + ps) + 4 * c + 24 <= budget[c]
    # 64 x 128 at tt 10: 148 columns on 5 a lane, 84 rows on 11 warps
    assert (kernel.cols(128, 10), kernel.warps(64, 10)) == (5, 11)
    assert kernel.fits(64, 128, 10) and not kernel.fits(64, 128, 13)
    worst = max(2 * 2 * kernel.warps(c["block_h"], c["tt"]) * 32
                * kernel.cols(c["block_w"], c["tt"]) * 4
                for c in build_space().compiled().valid_configs())
    assert worst == 2 * 2 * 11 * 32 * 5 * 4 <= 48 * 1024


def _hot_source():
    from pathlib import Path
    return (Path(kernel.__file__).parents[2] / "csrc"
            / kernel.SOURCE).read_text()


def test_compiled_menu_mirrors_the_source():
    """``kernel.ROWS``, ``MAX_THREADS`` and ``tiles()`` are what
    ``csrc/hotspot.cu`` compiles: its HOT_ROWS, HOT_MAX_THREADS and the
    (columns, unroll_t, acc, power_smem) that HOT_TILES instantiates."""
    import re
    src = _hot_source()
    assert int(re.search(r"#define HOT_ROWS (\d+)", src).group(1)) \
        == kernel.ROWS
    expr = re.search(r"#define HOT_MAX_THREADS\(C\) (.+)", src).group(1)
    pairs = re.findall(r"\(C\) == (\d+) \? (\d+)", expr)
    last = int(re.search(r": (\d+)\)\s*$", expr).group(1))
    most = {int(c): int(n) for c, n in pairs}
    most.update({c: last for c in kernel.COLS if c not in most})
    assert most == kernel.MAX_THREADS
    body = re.search(r"#define HOT_TILES\(X\) (.+)", src).group(1)
    both_u = [int(c) for c in re.findall(r"HOT_UNROLL\(X, (\d+)\)", body)]
    one_u = [int(c) for c in re.findall(r"HOT_ACC\(X, (\d+), 1\)", body)]
    compiled = {(c, u, a, ps) for c in both_u for u in (1, 2)
                for a in ("f32", "bf16") for ps in (0, 1)} \
        | {(c, 1, a, ps) for c in one_u for a in ("f32", "bf16")
           for ps in (0, 1)}
    assert compiled == set(kernel.tiles())
    assert len(kernel.tiles()) == 28


def test_every_admitted_config_is_compiled():
    """Each launch of an admitted config runs a compiled tile within its
    threads' budget: every sweep count a launch can have (tt, or fewer for
    the last), with unroll_t snapped as the launcher snaps it."""
    tiles = set(kernel.tiles())
    for cfg in build_space().compiled().valid_configs():
        for s in range(1, cfg["tt"] + 1):
            c = kernel.cols(cfg["block_w"], s)
            u = 1 if s % cfg["unroll_t"] else cfg["unroll_t"]
            assert (c, u, cfg["acc_dtype"], cfg["power_smem"]) in tiles, cfg
            assert 32 * kernel.warps(cfg["block_h"], s) \
                <= kernel.MAX_THREADS[c]
    assert kernel.tile_configs()[0]["tt"] == 4
    assert [(kernel.cols(c["block_w"], c["tt"]), c["unroll_t"],
             c["acc_dtype"], c["power_smem"]) for c in kernel.tile_configs()] \
        == kernel.tiles()


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, *SMALL)
    before = (ops.hotspot.launches, ops.hotspot.device_launches)
    # the first four cases with one sweep per unrolled chunk, which the
    # space admits
    for _, cfg in PALLAS_CASES[:4]:
        cfg = dict(cfg, unroll_t=1)
        got = ops.hotspot(t["temp"], t["power"], 4, cfg)
        assert torch.equal(got, kernel.hotspot_plain(t["temp"], t["power"],
                                                     4, **cfg))
    assert (ops.hotspot.launches, ops.hotspot.device_launches) == before


def _bad(case):
    t, _ = both(4, *SMALL)
    temp, power = t["temp"], t["power"]
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "dtype":
        return temp.double(), power, 4, cfg
    if case == "shape":
        return temp, power[1:].contiguous(), 4, cfg
    if case == "contiguity":
        return temp.t().contiguous().t(), power, 4, cfg
    if case == "sweeps":
        return temp, power, -1, cfg
    if case == "smem":
        # the budget is registers now: 128 x 128 tiles at tt 8 take 5
        # columns a lane and 18 warps, over the 352 threads 5 columns allow
        return temp, power, 4, dict(cfg, block_h=128, block_w=128, tt=8)
    return temp, power, 4, dict(cfg, block_w=48)               # "menu"


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "sweeps",
                                  "smem", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    temp, power, n, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.hotspot(temp, power, n, cfg)
