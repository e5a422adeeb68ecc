"""The port's N-body against the JAX package's: the torch oracle against the
jnp oracle, the plain version against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), the space, and CPU dispatch.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed in f32 and handed to both packages.

Tolerances, rel-L2:

* oracle vs oracle: ``ORACLE_TOL`` 1e-6 (the same f32 math, summed in
  another order).
* plain version vs Pallas: ``PALLAS_TOL`` 1e-6, measured 1.0e-7 to 1.3e-7
  (XLA and PyTorch sum in other orders), for f32 and bf16 alike.  The
  Pallas kernel is compiled with XLA's excess precision off: by default XLA
  on the CPU keeps the bf16 differences ``xj - xi`` in f32, which the
  reference's code rounds to bf16 (and the TPU, which stores them as bf16,
  does too); with it on, the plain version misses by 6.5e-4 and a plain
  version that skips that rounding matches.  The control: an f32 plain
  version misses a bf16 Pallas run by more than both tight tolerances.
* plain version vs the torch oracle: the JAX package's ``TOLS["nbody"]``,
  1e-3 (f32) and 8e-2 (bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import space as jspace  # noqa: E402
from repro.kernels.nbody import kernel as jkernel  # noqa: E402
from repro.kernels.nbody.ref import nbody_reference as jnp_reference  # noqa: E402
from repro.staticcheck.spaceaudit import audit_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kernels.nbody import kernel, ops  # noqa: E402
from repro_torch.kernels.nbody.ref import nbody_reference  # noqa: E402
from repro_torch.kernels.nbody.space import (  # noqa: E402
    SMALL_SHAPE, NbodyProblem, build_space, numpy_inputs)

TOLS = {"f32": 1e-3, "bf16": 8e-2}     # tests/test_kernels.py TOLS["nbody"]
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


def both(seed, n):
    """The same f32 inputs as torch CPU tensors and as jnp arrays."""
    x = numpy_inputs(seed, n)
    return ({k: torch.from_numpy(a) for k, a in x.items()},
            {k: jnp.asarray(a) for k, a in x.items()})


@pytest.mark.parametrize("seed,n", [(1, 512), (2, 1024)])
def test_torch_oracle_matches_jnp_oracle(seed, n):
    t, j = both(seed, n)
    got = nbody_reference(t["pos"], t["mass"])
    want = jnp_reference(j["pos"], j["mass"])
    assert got.dtype == torch.float32 and got.shape == (3, n)
    assert rel_l2(got.numpy(), want) <= ORACLE_TOL
    # the f64 oracle the chip run also reports
    f64 = nbody_reference(t["pos"].double(), t["mass"].double())
    assert f64.dtype == torch.float64
    assert rel_l2(got.numpy(), f64.numpy()) <= ORACLE_TOL


def _cfg(bi, bj, layout, uj, rsqrt, dtype):
    return {"block_i": bi, "block_j": bj, "layout": layout, "unroll_j": uj,
            "rsqrt_method": rsqrt, "compute_dtype": dtype}


#: every value of every parameter; block_j of 2048 and 4096 at N = 4096
PALLAS_CASES = [
    (512, _cfg(32, 128, "soa", 1, "exact", "f32")),
    (512, _cfg(64, 256, "aos", 2, "approx", "f32")),
    (512, _cfg(128, 512, "soa", 4, "exact", "bf16")),
    (512, _cfg(256, 128, "aos", 8, "approx", "bf16")),
    (512, _cfg(512, 256, "soa", 2, "approx", "bf16")),
    (1024, _cfg(128, 1024, "aos", 4, "exact", "f32")),
    (4096, _cfg(256, 2048, "soa", 8, "approx", "f32")),
    (4096, _cfg(512, 4096, "aos", 1, "exact", "bf16")),
]


def pallas(j, cfg):
    """The Pallas kernel in interpret mode with XLA's excess precision off,
    so bf16 values are rounded where the reference's code rounds them."""
    f = jax.jit(functools.partial(jkernel.nbody, interpret=True, **cfg),
                compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(f(j["pos"], j["mass"]))


def plain(t, cfg):
    if cfg["layout"] == "aos":
        return kernel.nbody_plain(kernel.to_aos(t["pos"], t["mass"]), None,
                                  **cfg)
    return kernel.nbody_plain(t["pos"], t["mass"], **cfg)


@pytest.mark.parametrize("n,cfg", PALLAS_CASES,
                         ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
def test_plain_version_matches_pallas_kernel(n, cfg):
    t, j = both(3, n)
    got = plain(t, cfg)
    want = pallas(j, cfg)
    err = rel_l2(got.numpy(), want)
    assert err <= PALLAS_TOL, err
    assert rel_l2(got.numpy(), nbody_reference(t["pos"], t["mass"]).numpy()) \
        <= TOLS[cfg["compute_dtype"]]
    if cfg["compute_dtype"] == "bf16":
        # the compute_dtype control: the f32 plain version misses a bf16
        # Pallas run by more than both tight tolerances, so neither this
        # comparison nor the kernel's on the card (kernel.PLAIN_TOL) would
        # pass a version that skipped the bf16 roundings
        f32 = plain(t, dict(cfg, compute_dtype="f32"))
        miss = rel_l2(f32.numpy(), want)
        assert miss > max(PALLAS_TOL, kernel.PLAIN_TOL), miss


def test_the_differences_are_rounded_to_bf16():
    """With XLA's default excess precision the Pallas run keeps the bf16
    differences in f32: the plain version then misses it by more than
    ``PALLAS_TOL``, and a version that rounds only the positions matches.
    So the tight comparison above does check the rounding of the
    differences."""
    t, j = both(4, 512)
    cfg = PALLAS_CASES[2][1]
    excess = np.asarray(jkernel.nbody(j["pos"], j["mass"], interpret=True,
                                      **cfg))
    assert rel_l2(plain(t, cfg).numpy(), excess) > PALLAS_TOL
    positions_only = kernel.nbody_plain(
        t["pos"].to(torch.bfloat16).float(), t["mass"],
        **dict(cfg, compute_dtype="f32"))
    assert rel_l2(positions_only.numpy(), excess) <= PALLAS_TOL


def rebuild(space, mod):
    return mod.SearchSpace(
        [mod.Param(p.name, tuple(p.values)) for p in space.params],
        [mod.Constraint(c.name, c.fn, vec=c.vec) for c in space.constraints],
        name=space.name)


@pytest.mark.parametrize("n", [NbodyProblem.default_shape["n"],
                               SMALL_SHAPE["n"]], ids=["full", "small"])
def test_space_compiles_and_audits_clean(n):
    sp = build_space(n)
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
    pos, mass = torch.empty((3, n)), torch.empty(n)
    bodies = torch.empty((n, 4))
    for cfg in sp.compiled().valid_configs():
        if cfg["layout"] == "aos":
            ops.check(bodies, None, cfg)
        else:
            ops.check(pos, mass, cfg)


def test_space_sizes():
    """960 configs, all admitted at N = 131 072; at N = 512 the block_j
    menu stops at 512 (half of them)."""
    prob = NbodyProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (960, 960)
    assert build_space(SMALL_SHAPE["n"]).compiled().n_valid == 480
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(5, 512)
    before = ops.nbody.launches
    for _, cfg in PALLAS_CASES[:4]:
        if cfg["layout"] == "aos":
            args = (kernel.to_aos(t["pos"], t["mass"]), None)
        else:
            args = (t["pos"], t["mass"])
        assert torch.equal(ops.nbody(*args, cfg), plain(t, cfg))
    assert ops.nbody.launches == before


def _bad(case):
    t, _ = both(6, 512)
    pos, mass = t["pos"], t["mass"]
    cfg = dict(ops.DEFAULT_CONFIG, block_j=256)
    if case == "dtype":
        return pos.double(), mass, cfg
    if case == "aos_with_mass":
        return kernel.to_aos(pos, mass), mass, dict(cfg, layout="aos")
    if case == "layout":
        return kernel.to_aos(pos, mass), None, cfg        # (N, 4) for "soa"
    if case == "mass_shape":
        return pos, mass[:256].contiguous(), cfg
    if case == "divisibility":
        return pos[:, :500].contiguous(), mass[:500].contiguous(), cfg
    return pos, mass, dict(cfg, block_i=1024)             # "menu"


@pytest.mark.parametrize("case", ["dtype", "aos_with_mass", "layout",
                                  "mass_shape", "divisibility", "menu"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    pos, mass, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.nbody(pos, mass, cfg)
