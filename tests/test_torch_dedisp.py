"""The port's dedispersion against the JAX package's: the delay table, the
torch oracle against the jnp oracle, the plain version against the Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it), the space,
and CPU dispatch.  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Samples are drawn with numpy from a seed in f32; the delay table is the
JAX package's, handed to both packages (the port's own table differs from
it by one sample in 0.14 % of the entries at the reference's shape, 0.02 %
once clipped as the problem clips it: XLA rounds ``jnp.linspace`` in a way
that depends on how it vectorises it on the host; ROADMAP queue 3).

Tolerances:

* the delay table: equal at the small shape; at the reference's shape no
  entry off by more than one sample, at most ``DELAY_SHARE`` 0.5 % off,
  and at most ``CLIPPED_SHARE`` 0.05 % once clipped at T - t_out as the
  problem clips it (measured 0.14 % and 0.02 %).
* oracle vs oracle: ``ORACLE_TOL`` 1e-6 rel-L2 (f32 sums over channels,
  each package in its own order; measured 0 at the small shape).
* plain version vs Pallas: exact (0 mismatches) in both acc_dtypes: both
  add the channels one after another in order, rounding each sum to the
  accumulator's dtype.  The control: with an f32 accumulator the plain
  version differs from a bf16 Pallas run.  The Pallas kernel is compiled
  with XLA's excess precision off, so that bf16 is rounded where the
  reference's code says.
* plain version vs the torch oracle: the JAX package's ``TOLS["dedisp"]``,
  1e-3 (f32) and 2e-2 (bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.dedisp import kernel as jkernel  # noqa: E402
from repro.kernels.dedisp.ref import dedisp_reference as jnp_reference  # noqa: E402
from repro.kernels.dedisp.ref import make_delays as jnp_delays  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.dedisp import kernel, ops  # noqa: E402
from repro_torch.kernels.dedisp.ref import dedisp_reference, make_delays  # noqa: E402
from repro_torch.kernels.dedisp.space import (  # noqa: E402
    SMALL_SHAPE, TILE_SHAPES, DedispProblem, build_space, dims, numpy_inputs,
    tile_configs)

TOLS = {"f32": 1e-3, "bf16": 2e-2}     # tests/test_kernels.py TOLS["dedisp"]
ORACLE_TOL = 1e-6
DELAY_SHARE = 5e-3
CLIPPED_SHARE = 5e-4


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


SMALL = dims(SMALL_SHAPE)
#: more DMs and samples than the small shape, so that block_d reaches 128
#: and time_chunk takes 256 and 512 (C, D, t_out, T, DM step)
MID = (40, 150, 600, 900, 0.2)


def both(seed, c, d, t_out, t_in, dm_step):
    """The same samples, and the JAX package's delay table clipped as the
    reference clips it, as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, c, d, t_out, t_in, dm_step)
    x["delays"] = np.minimum(np.asarray(jnp_delays(c, d, dm_step=dm_step)),
                             t_in - t_out).astype(np.int32)
    return ({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in x.items()},
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in x.items()})


def test_delay_table_is_the_references_at_the_small_shape():
    c, d, _, _, step = SMALL
    got = make_delays(c, d, dm_step=step)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jnp_delays(c, d, dm_step=step)))


def test_delay_table_within_one_sample_at_the_full_shape():
    """At 1536 x 2048 the port's f32 table follows the reference's within
    one sample; the frequencies differ in their last bit (the module's
    docstring says why)."""
    c, d, *_ = dims(DedispProblem.default_shape)
    got = make_delays(c, d).astype(np.int64)
    want = np.asarray(jnp_delays(c, d)).astype(np.int64)
    off = got != want
    assert np.abs(got - want).max() <= 1
    assert off.mean() <= DELAY_SHARE
    # 55 % of the clipped delays sit at the clip, 8192 (the space's
    # docstring), and there fewer differ
    clipped = np.minimum(got, 8192)
    assert 0.5 < (clipped == 8192).mean() < 0.6
    assert (clipped != np.minimum(want, 8192)).mean() <= CLIPPED_SHARE


@pytest.mark.parametrize("shape", [SMALL, MID], ids=["small", "mid"])
def test_torch_oracle_matches_jnp_oracle(shape):
    t, j = both(1, *shape)
    got = dedisp_reference(t["x"], t["delays"], t["t_out"])
    want = jnp_reference(j["x"], j["delays"], j["t_out"])
    assert got.dtype == torch.float32 and got.shape == (shape[1], shape[2])
    assert rel_l2(got.numpy(), want) <= ORACLE_TOL


def _cfg(bd, bc, tc, ud, acc):
    return {"block_d": bd, "block_c": bc, "time_chunk": tc, "unroll_d": ud,
            "acc_dtype": acc}


#: every value of every parameter (time_chunk: every value the space has
#: at t_out = 600)
PALLAS_CASES = [
    (SMALL, _cfg(8, 1, 0, 1, "f32")),
    (SMALL, _cfg(16, 2, 0, 2, "bf16")),
    (SMALL, _cfg(8, 64, 0, 8, "bf16")),
    (MID, _cfg(32, 4, 256, 4, "f32")),
    (MID, _cfg(64, 8, 512, 8, "bf16")),
    (MID, _cfg(128, 16, 0, 8, "f32")),
    (MID, _cfg(16, 32, 256, 1, "bf16")),
]


def pallas(j, cfg):
    """The Pallas kernel in interpret mode with XLA's excess precision off,
    so bf16 values are rounded where the reference's code rounds them."""
    f = jax.jit(functools.partial(jkernel.dedisp, t_out=j["t_out"],
                                  interpret=True, **cfg),
                compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(f(j["x"], j["delays"]))


@pytest.mark.parametrize("shape,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(shape, cfg):
    t, j = both(2, *shape)
    got = kernel.dedisp_plain(t["x"], t["delays"], t["t_out"], **cfg).numpy()
    want = pallas(j, cfg)
    assert int((got != want).sum()) == 0
    if cfg["acc_dtype"] == "bf16":
        # the acc_dtype control: an f32 accumulator gives other outputs
        f32 = kernel.dedisp_plain(t["x"], t["delays"], t["t_out"],
                                  **dict(cfg, acc_dtype="f32")).numpy()
        assert int((f32 != want).sum()) > 0
    oracle = dedisp_reference(t["x"], t["delays"], t["t_out"]).numpy()
    assert rel_l2(got, oracle) <= TOLS[cfg["acc_dtype"]]


def test_layout_fits_every_admitted_config():
    """A block's threads, samples a thread and passes: at most 512 adding
    threads, a row whole warps (so a warp shares its DMs), a compiled
    (unroll_d, samples) tile, and a ring of at least two steps."""
    prob = DedispProblem(device="cpu")
    c, _, t_out, t_in, _ = dims(prob.shape)
    for cfg in prob.space.compiled().valid_configs():
        tc = cfg["time_chunk"] or t_out
        nx, rows, st = kernel.layout(cfg["block_d"], cfg["unroll_d"], tc)
        assert nx * rows <= kernel.MAX_THREADS and nx >= kernel.MIN_ROW
        assert nx % 32 == 0
        assert (cfg["unroll_d"], st) in kernel.tiles()
        assert kernel.config_stages(cfg, c, t_out, t_in) >= 2
    assert kernel.layout(8, 8, 4096) == (512, 1, 8)
    assert kernel.layout(128, 8, 256) == (32, 16, 8)
    # a row of whole warps: 160 samples take 5 warps, 100 take 4
    assert kernel.layout(8, 8, 160)[0] == 160
    assert kernel.layout(8, 8, 100)[0] == 128


def test_ring_bytes_by_hand():
    """The ring the space charges, counted by hand at the reference's shape
    (T - t_out = 8192): a slot is a pass plus 8192 plus the 16-byte
    rounding at both ends of a window; a step is block_c slots, block_c
    delay slices and two 8-byte mbarriers; the ring has as many steps as
    fit beside 8 B a channel of delay bounds, at most 8."""
    # block_d 8, unroll_d 8: one row of 512 threads, 8 samples each
    assert kernel.slot_floats(512, 8, 8192) == 4096 + 8192 + 8 == 12296
    assert kernel.stage_bytes(8, 2, 12296) == 2 * (12296 + 8) * 4 + 16
    assert kernel.win_bytes(1536) == 12288 and kernel.win_bytes(7) == 64
    assert kernel.stages(1536, 8, 2, 12296) == (232448 - 12288) // 98448 == 2
    assert kernel.stages(1536, 8, 1, 12296) == 4
    assert kernel.stages(1536, 8, 4, 12296) == 1         # refused
    # the default: 2 rows of 256 threads, 16 samples of 4 DMs each (64
    # accumulators), a pass of 4096
    cfg = ops.DEFAULT_CONFIG
    assert kernel.layout(cfg["block_d"], cfg["unroll_d"], 4096) \
        == (256, 2, 16)
    assert kernel.config_stages(cfg, 1536, 4096, 12288) == 2
    assert kernel.stages(12, 8, 64, kernel.slot_floats(160, 1, 256)) == 2


def test_reads_per_add_on_the_reference_table():
    """Window reads a sample-add of the kernel: once per run of equal
    delays among a thread's ``unroll_d`` DMs.  The reference's table (the
    JAX package's, 1536 x 2048, clipped at 8192) grows with DM, so a run
    is a distinct delay: 0.4936 reads at unroll_d 8, where 55 % of the
    delays sit at the clip."""
    c, d, *_ = dims(DedispProblem.default_shape)
    table = np.minimum(np.asarray(jnp_delays(c, d)), 8192)
    assert (np.diff(table, axis=1) >= 0).all()
    assert round(kernel.reads_per_add(table, 8), 4) == 0.4936
    got = [round(kernel.reads_per_add(table, u), 4) for u in (1, 2, 4)]
    assert got == [1.0, 0.7107, 0.5659]
    # distinct delays, counted apart: the same where runs are distinct
    g = np.sort(table.reshape(c, -1, 8), axis=-1)
    distinct = (1 + (g[..., 1:] != g[..., :-1]).sum(-1)).sum() / table.size
    assert kernel.reads_per_add(table, 8) == distinct
    # a table out of order reads once per run, more than once per distinct
    shuffled = np.random.default_rng(0).permuted(table, axis=1)
    assert kernel.reads_per_add(shuffled, 8) > distinct
    # every DM one delay: one read serves 8; all distinct: one read each
    assert kernel.reads_per_add(np.zeros((4, 16), np.int32), 8) == 1 / 8
    assert kernel.reads_per_add(
        np.tile(np.arange(16, dtype=np.int32), (4, 1)), 8) == 1.0
    # a ragged last group repeats its last delay, as the kernel stages it
    assert kernel.reads_per_add(np.arange(12, dtype=np.int32)[None], 8) \
        == 12 / 16


def test_tile_shapes_reach_every_compiled_tile():
    """The two shapes the card tests and ``chip_smoke.py`` use reach every
    compiled (unroll_d, samples a thread), each by an admitted config."""
    seen = {}
    for c, d, t_out, t_in, _ in TILE_SHAPES:
        sp = build_space(d, t_out, t_in, c)
        for tile, cfg in tile_configs(c, d, t_out, t_in).items():
            assert sp.satisfies(cfg)
            seen[tile] = cfg
    assert set(seen) == set(kernel.tiles())


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("shape", [DedispProblem.default_shape, SMALL_SHAPE],
                         ids=["full", "small"])
def test_space_compiles_and_audits_clean(shape):
    c, d, t_out, t_in, _ = dims(shape)
    sp = build_space(d, t_out, t_in, c)
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
    x = torch.empty((c, t_in))
    delays = torch.zeros((c, d), dtype=torch.int32)
    for cfg in sp.compiled().valid_configs():
        ops.check(x, delays, t_out, cfg)


def test_space_sizes():
    """336 of 480 configs at the default shape: unroll_d dividing block_d,
    at most 16 rows of DMs a block, and a ring of two steps of 34 to 41 KB
    slots (a pass plus T - t_out = 8192 samples) in 227 KB, which leaves
    block_c 1 and 2 of the menu.  (The design that read x through L1 had
    1176 of 1680: every block_c to 64.)  102 of 112 at the small shape."""
    prob = DedispProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (480, 336)
    assert prob.space.param("block_c").values == (1, 2)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)
    small = DedispProblem(shape=SMALL_SHAPE, device="cpu").space
    assert (small.cardinality, small.compiled().n_valid) == (112, 102)


def test_problem_inputs_keep_the_delays_integral():
    x = DedispProblem(device="cpu").make_inputs(seed=0, small=True)
    assert x["delays"].dtype == torch.int32 and x["x"].dtype == torch.float32
    c, d, t_out, t_in, _ = SMALL
    assert x["delays"].shape == (c, d) and x["t_out"] == t_out
    assert int(x["delays"].max()) <= t_in - t_out


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, *SMALL)
    before = ops.dedisp.launches
    for _, cfg in PALLAS_CASES[:3]:
        got = ops.dedisp(t["x"], t["delays"], t["t_out"], cfg)
        assert torch.equal(got, kernel.dedisp_plain(t["x"], t["delays"],
                                                    t["t_out"], **cfg))
    assert ops.dedisp.launches == before


def _bad(case):
    t, _ = both(4, *SMALL)
    x, delays, t_out = t["x"], t["delays"], t["t_out"]
    cfg = dict(ops.DEFAULT_CONFIG, block_d=8)
    if case == "dtype":
        return x, delays.float(), t_out, cfg
    if case == "channels":
        return x, delays[1:].contiguous(), t_out, cfg
    if case == "t_out":
        return x, delays, x.shape[1] + 1, cfg
    if case == "unroll":
        return x, delays, t_out, dict(cfg, block_d=8, unroll_d=16)
    if case == "rows":
        return x, delays, t_out, dict(cfg, block_d=128, unroll_d=1)
    if case == "ring":
        # T - t_out of 30 000: two slots of a step outgrow 227 KB
        wide = torch.zeros((x.shape[0], t_out + 30000))
        return wide, delays, t_out, dict(cfg, block_c=1)
    return x, delays, t_out, dict(cfg, block_c=3)               # "menu"


@pytest.mark.parametrize("case", ["dtype", "channels", "t_out", "unroll",
                                  "rows", "ring", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    x, delays, t_out, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.dedisp(x, delays, t_out, cfg)
