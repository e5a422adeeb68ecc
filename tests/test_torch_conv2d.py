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
from repro_torch.kernels.conv2d import kernel, ops  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_reference  # noqa: E402
from repro_torch.kernels.conv2d.space import (  # noqa: E402
    SMALL_SHAPE, Conv2dProblem, build_space, numpy_inputs)

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
    assert set(kernel.VARIANTS) == {"f5_u1", "f5_u5", "f15_u1", "f15_u3",
                                    "f15_u5", "f15_u15"}


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
    """4608 of 8960 configs at the default shape: a block of 32 to 512
    threads with row_chunk dividing block_h."""
    prob = Conv2dProblem(device="cpu")
    assert (prob.space.cardinality, prob.space.compiled().n_valid) \
        == (8960, 4608)
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, *SMALL)
    before = ops.conv2d.launches
    for _, cfg in PALLAS_CASES[:4]:
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
