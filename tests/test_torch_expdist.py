"""The port's ExpDist against the JAX package's: the torch oracle against the
jnp oracle, the plain version against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), the space, and CPU dispatch.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed in f32 and handed to both packages.

Tolerances, relative error of the scalar:

* oracle vs oracle: ``ORACLE_TOL`` 1e-6 (f32 terms summed in another
  order; measured 0 at the small shape).
* plain version vs Pallas: ``PALLAS_TOL`` 1e-6 in both compute dtypes
  (measured at most 6.4e-8: the same terms, summed in another order, and
  exp2 rounded otherwise).  The control: the f32 plain version misses a
  bf16 Pallas run by about 1e-5, ten times the bound.  The Pallas kernel is
  compiled with XLA's excess precision off, so that bf16 is rounded where
  the reference's code says.
* plain version vs the torch oracle: the JAX package's ``TOLS["expdist"]``,
  1e-3 (f32) and 2e-2 (bf16), and against an f64 oracle too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.expdist import kernel as jkernel  # noqa: E402
from repro.kernels.expdist.ref import expdist_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.expdist import kernel, ops  # noqa: E402
from repro_torch.kernels.expdist.ref import expdist_reference  # noqa: E402
from repro_torch.kernels.expdist.space import (  # noqa: E402
    SMALL_SHAPE, ExpdistProblem, build_space, numpy_inputs)

TOLS = {"f32": 1e-3, "bf16": 2e-2}     # tests/test_kernels.py TOLS["expdist"]
PALLAS_TOL = 1e-6
ORACLE_TOL = 1e-6
ARGS = ("a", "b", "sa", "sb")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores, which slowed these
    small CPU ops by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def both(seed, ka, kb):
    """The same f32 inputs as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, ka, kb)
    return ([torch.from_numpy(x[k]) for k in ARGS],
            [jnp.asarray(x[k]) for k in ARGS])


SMALL = tuple(SMALL_SHAPE.values())
#: more points a_i than one chunk of the oracle and the plain version
WIDE = (1500, 700)
#: nine j tiles of 128, so that n_y_blocks takes 1, 2, 4 and 8
TALL = (200, 1100)


@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["small", "wide"])
def test_torch_oracle_matches_jnp_oracle(shape):
    t, j = both(1, *shape)
    got = expdist_reference(*t)
    want = float(jnp_reference(*j))
    assert got.dtype == torch.float32 and got.shape == ()
    assert rel(got, want) <= ORACLE_TOL
    f64 = expdist_reference(*(v.double() for v in t))
    assert rel(got, f64) <= ORACLE_TOL


def _cfg(bi, bj, col, ny, uj, ev, cd):
    return {"block_i": bi, "block_j": bj, "use_column": col,
            "n_y_blocks": ny, "unroll_j": uj, "exp_variant": ev,
            "compute_dtype": cd}


#: every value of every parameter (n_y_blocks: every value the space has
#: at kb = 1100)
PALLAS_CASES = [
    (SMALL, _cfg(32, 128, 0, 2, 1, "exp", "f32")),
    (SMALL, _cfg(64, 256, 1, 1, 2, "exp2", "bf16")),
    (SMALL, _cfg(128, 512, 0, 1, 4, "exp", "bf16")),
    (SMALL, _cfg(256, 1024, 1, 1, 1, "exp2", "f32")),
    (SMALL, _cfg(512, 2048, 0, 1, 2, "exp", "f32")),
    (TALL, _cfg(32, 128, 0, 4, 4, "exp2", "bf16")),
    (TALL, _cfg(64, 128, 0, 8, 2, "exp", "f32")),
    (WIDE, _cfg(512, 256, 0, 2, 4, "exp2", "bf16")),
]


def pallas(j, cfg):
    """The Pallas kernel in interpret mode with XLA's excess precision off,
    so bf16 values are rounded where the reference's code rounds them."""
    f = jax.jit(functools.partial(jkernel.expdist, interpret=True, **cfg),
                compiler_options={"xla_allow_excess_precision": False})
    return float(f(*j))


@pytest.mark.parametrize("shape,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(shape, cfg):
    t, j = both(2, *shape)
    got = kernel.expdist_plain(*t, **cfg)
    want = pallas(j, cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    assert rel(got, want) <= PALLAS_TOL
    if cfg["compute_dtype"] == "bf16":
        # the compute_dtype control: f32 misses by far more than the bound
        f32 = kernel.expdist_plain(*t, **dict(cfg, compute_dtype="f32"))
        assert rel(f32, want) > 5 * PALLAS_TOL
    oracle = expdist_reference(*(v.double() for v in t))
    assert rel(got, oracle) <= TOLS[cfg["compute_dtype"]]


def test_column_blocks_are_the_references():
    """njb: 1 with use_column, else n_y_blocks cut to the j tiles."""
    assert kernel.n_col_blocks(65536, 2048, 1, 1) == 1
    assert kernel.n_col_blocks(65536, 2048, 0, 8) == 8
    assert kernel.n_col_blocks(320, 256, 0, 8) == 2


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("shape", [ExpdistProblem.default_shape, SMALL_SHAPE],
                         ids=["full", "small"])
def test_space_compiles_and_audits_clean(shape):
    sp = build_space(shape["kb"])
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
    a = torch.empty((2, shape["ka"]))
    b = torch.empty((2, shape["kb"]))
    sa, sb = torch.empty(shape["ka"]), torch.empty(shape["kb"])
    for cfg in sp.compiled().valid_configs():
        ops.check(a, b, sa, sb, cfg)


def test_space_sizes():
    """2700 of 6000 configs at the default shape: n_y_blocks 1 with
    use_column, and at most the j tiles there are."""
    prob = ExpdistProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (6000, 2700)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, *SMALL)
    before = (ops.expdist.launches, ops.expdist.device_launches)
    for _, cfg in PALLAS_CASES[:4]:
        got = ops.expdist(*t, cfg)
        assert torch.equal(got, kernel.expdist_plain(*t, **cfg))
    assert (ops.expdist.launches, ops.expdist.device_launches) == before


def _bad(case):
    (a, b, sa, sb), _ = both(4, *SMALL)
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "dtype":
        return a.double(), b, sa, sb, cfg
    if case == "shape":
        return a, b, sa[1:], sb, cfg
    if case == "contiguity":
        return a.t().contiguous().t(), b, sa, sb, cfg
    if case == "column":
        return a, b, sa, sb, dict(cfg, use_column=1, n_y_blocks=2)
    if case == "unroll":
        return a, b, sa, sb, dict(cfg, unroll_j=3)
    return a, b, sa, sb, dict(cfg, block_i=16)                  # "menu"


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "column",
                                  "unroll", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    *args, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.expdist(*args, cfg)
