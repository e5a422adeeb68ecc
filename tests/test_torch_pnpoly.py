"""The port's point in polygon against the JAX package's: the torch oracle
against the jnp oracle, the plain version against the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) in all twelve
(between_method, use_method) variants, the space, and CPU dispatch.  The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed in f32 and handed to both packages.
Every comparison is exact: the output is an integer (the JAX package's
tolerance for pnpoly is 0).

One known difference from the reference (ROADMAP, queue 3): the
reference's between_method 1, ``(y1 - py) * (y2 - py) < 0``, counts no
crossing for a point exactly level with a vertex whose edges run on up and
down, where the other variants and the reference's own oracle count one.
At the reference's 2 000 000 points such points exist: for seed 0, 15 lie
exactly level with a vertex and the reference's method 1 calls one of them
wrongly (``chip_smoke.py`` counts both).  The port's method 1 takes the
half-open test where the product is 0, so all twelve variants agree with
the oracle; ``test_a_point_level_with_a_vertex`` shows both behaviours.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.pnpoly import kernel as jkernel  # noqa: E402
from repro.kernels.pnpoly.ref import pnpoly_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.pnpoly import kernel, ops  # noqa: E402
from repro_torch.kernels.pnpoly.ref import pnpoly_reference  # noqa: E402
from repro_torch.kernels.pnpoly.space import (  # noqa: E402
    SMALL_SHAPE, PnpolyProblem, build_space, laid_out, numpy_inputs)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores, which slowed these
    small CPU ops by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(seed, n, v):
    """The same f32 inputs as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, n, v)
    return ({k: torch.from_numpy(a) for k, a in x.items()},
            {k: jnp.asarray(a) for k, a in x.items()})


@pytest.mark.parametrize("seed,n,v", [(1, 1536, 17), (2, 4096, 64),
                                      (3, 20000, 600)],
                         ids=["small", "v64", "v600"])
def test_torch_oracle_matches_jnp_oracle(seed, n, v):
    t, j = both(seed, n, v)
    got = pnpoly_reference(t["points"], t["poly"])
    want = np.asarray(jnp_reference(j["points"], j["poly"]))
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < n                  # some inside, some outside


def _cfg(bp, unroll, between, use, pre, layout):
    return {"block_points": bp, "unroll_v": unroll, "between_method": between,
            "use_method": use, "precompute_slope": pre,
            "coord_layout": layout}


#: the twelve variants, with the other parameters taking every value
VARIANT_CASES = [
    _cfg(bp, unroll, b, u, (b + u) % 2, ("soa", "aos")[(b * 3 + u) % 2])
    for (b, u), bp, unroll in zip(
        [(b, u) for b in kernel.BETWEEN_METHODS for u in kernel.USE_METHODS],
        (32, 64, 128, 256, 512, 1024, 2048, 4096, 128, 256, 512, 1024),
        (1, 2, 3, 4, 6, 8, 1, 2, 3, 4, 6, 8))]


@pytest.mark.parametrize("cfg", VARIANT_CASES,
                         ids=[f"b{c['between_method']}u{c['use_method']}"
                              for c in VARIANT_CASES])
def test_plain_version_matches_pallas_kernel(cfg):
    """Exactly, in each of the twelve variants (0 mismatches), and each
    agrees with the oracle."""
    t, j = both(4, *SMALL_SHAPE.values())
    got = kernel.pnpoly_plain(laid_out(t["points"], cfg), t["poly"], **cfg)
    want = np.asarray(jkernel.pnpoly(j["points"], j["poly"], interpret=True,
                                     **cfg))[0]
    assert got.dtype == torch.int32
    assert int((got.numpy() != want).sum()) == 0
    assert torch.equal(got, pnpoly_reference(t["points"], t["poly"]))


def test_all_twelve_variants_agree_at_a_larger_shape():
    t, _ = both(5, 50000, 600)
    want = pnpoly_reference(t["points"], t["poly"])
    for cfg in VARIANT_CASES:
        got = kernel.pnpoly_plain(laid_out(t["points"], cfg), t["poly"],
                                  **cfg)
        assert torch.equal(got, want), cfg


def test_a_point_level_with_a_vertex():
    """Points exactly level with each vertex, left of the polygon (so
    outside): the reference's between_method 1 misses the crossing at a
    vertex whose edges run on up and down, and calls such a point inside;
    the port's method 1 counts it, as method 0 and the oracle do."""
    t, j = both(6, 8, 17)
    ys = t["poly"][1]
    pts = torch.stack([torch.full_like(ys, -1.19), ys]).contiguous()
    oracle = pnpoly_reference(pts, t["poly"])
    assert oracle.sum() == 0              # left of the polygon: outside
    jpts = jnp.asarray(pts.numpy())
    base = _cfg(128, 1, 0, 1, 0, "soa")
    for b in kernel.BETWEEN_METHODS:
        cfg = dict(base, between_method=b)
        assert torch.equal(kernel.pnpoly_plain(pts, t["poly"], **cfg), oracle)
        pallas = np.asarray(jkernel.pnpoly(jpts, j["poly"], interpret=True,
                                           **cfg))[0]
        if b == 1:      # the reference's fault
            assert (pallas != oracle.numpy()).sum() > 0
        else:
            assert np.array_equal(pallas, oracle.numpy())


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("shape", [PnpolyProblem.default_shape, SMALL_SHAPE],
                         ids=["full", "small"])
def test_space_compiles_and_audits_clean(shape):
    sp = build_space(shape["n"], shape["v"])
    rep = audit_space(rebuild(sp, jspace))
    checks = {f.check for f in rep.findings}
    assert rep.ok, rep.render()
    assert not checks & {"unsatisfiable", "dead-value", "disconnected"}
    assert rep.n_components == 1
    # the scalar predicates and their vec= forms are the same function
    scalar_only = tspace.SearchSpace(
        sp.params, [tspace.Constraint(c.name, c.fn) for c in sp.constraints],
        name=sp.name + "_scalar")
    assert np.array_equal(sp.compiled().mask, scalar_only.compiled().mask)
    # every admitted config fits the kernel's launch check
    pts = torch.empty((2, 8))
    poly = torch.empty((2, shape["v"]))
    for cfg in sp.compiled().valid_configs():
        ops.check(laid_out(pts, cfg), poly, cfg)


def test_full_space_size():
    """2304 configs, all admitted at the default shape: the blocks mask the
    ragged end and the 600 vertices fit the constant copy."""
    prob = PnpolyProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (2304, 2304)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)
    assert build_space(10, 2).compiled().n_valid == 2 * 2304 // 6


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(7, *SMALL_SHAPE.values())
    before = ops.pnpoly.launches
    for cfg in VARIANT_CASES[:4]:
        pts = laid_out(t["points"], cfg)
        got = ops.pnpoly(pts, t["poly"], cfg)
        assert torch.equal(got, kernel.pnpoly_plain(pts, t["poly"], **cfg))
    assert ops.pnpoly.launches == before


def _bad(case):
    t, _ = both(8, *SMALL_SHAPE.values())
    pts, poly = t["points"], t["poly"]
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "dtype":
        return pts.double(), poly, cfg
    if case == "layout":
        return pts.t().contiguous(), poly, cfg           # (N, 2) for "soa"
    if case == "contiguity":
        return pts.t().contiguous().t(), poly, cfg
    if case == "poly_shape":
        return pts, torch.cat([poly, poly[:1]]), cfg     # (3, V)
    if case == "vertices":
        return pts, torch.zeros((2, kernel.MAX_V + 1)), cfg
    return pts, poly, dict(cfg, block_points=3000)       # "menu"


@pytest.mark.parametrize("case", ["dtype", "layout", "contiguity",
                                  "poly_shape", "vertices", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    pts, poly, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.pnpoly(pts, poly, cfg)
