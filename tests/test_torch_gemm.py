"""The port's GEMM against the JAX package's: the torch oracle against the
jnp oracle, the plain version against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), and CPU dispatch.  The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn with numpy from a seed, rounded to bf16 once, and handed to
both packages, so both see the same values.  Tolerances are the JAX
package's (``tests/test_kernels.py`` ``TOLS["gemm"]``): rel-L2 5e-3 for an
f32 accumulator, 2e-2 for a bf16 one.  The plain version is also held
within ``PALLAS_TOL`` of the Pallas kernel.  That tight bound is what checks
the ``acc_dtype`` semantics: rounding the accumulator to bf16 once per k
block moves the result by less than ``TOLS`` allows, but by far more than
``PALLAS_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.matmul import kernel as jkernel  # noqa: E402
from repro.kernels.matmul.ref import gemm_reference as jnp_reference  # noqa: E402
from repro_torch.kernels.matmul import kernel, ops  # noqa: E402
from repro_torch.kernels.matmul.ref import gemm_reference  # noqa: E402
from repro_torch.kernels.matmul.space import (GemmProblem,  # noqa: E402
                                              inputs_from_numpy, numpy_inputs)

TOLS = {"f32": 5e-3, "bf16": 2e-2}
#: plain version vs Pallas interpret: the same steps, but XLA and PyTorch
#: associate some f32 sums differently, which flips an occasional bf16
#: rounding of the output
PALLAS_TOL = 1e-4


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


def both(seed, m, n, k):
    """The same bf16 inputs as torch CPU tensors and as jnp arrays."""
    t = inputs_from_numpy(numpy_inputs(seed, m, n, k), device="cpu")
    j = {key: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         if isinstance(v, torch.Tensor) else v for key, v in t.items()}
    return t, j


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,n,k,alpha,beta", [
    (64, 64, 128, 1.0, 1.0), (128, 64, 256, 0.75, 0.5), (64, 128, 64, 2.0, 0.0)])
def test_torch_oracle_matches_jnp_oracle(m, n, k, alpha, beta):
    t, j = both(1, m, n, k)
    got = gemm_reference(t["a"], t["b"], t["c"], alpha, beta)
    want = jnp_reference(j["a"], j["b"], j["c"], alpha, beta)
    assert got.dtype == torch.bfloat16
    assert rel_l2(as_np(got), as_np(want)) <= TOLS["f32"]


def _cfg(bm, bn, bk, uk, order, sk, acc, layout, warps=4):
    return {"block_m": bm, "block_n": bn, "block_k": bk, "unroll_k": uk,
            "warps": warps, "grid_order": order, "split_k": sk,
            "acc_dtype": acc, "rhs_layout": layout}


#: split_k 1/2/4, both layouts, both accumulators, unroll_k 1/2, both orders
PALLAS_CONFIGS = [
    _cfg(64, 64, 32, 1, "mn", 1, "f32", "kn"),
    _cfg(64, 64, 32, 2, "nm", 1, "bf16", "nk"),
    _cfg(128, 64, 64, 1, "mn", 2, "bf16", "kn", warps=8),
    _cfg(64, 128, 32, 2, "nm", 2, "f32", "nk"),
    _cfg(64, 64, 64, 2, "mn", 4, "f32", "kn"),
    _cfg(128, 128, 32, 1, "nm", 4, "bf16", "nk", warps=8),
    _cfg(64, 64, 32, 1, "nm", 1, "bf16", "kn"),
    _cfg(128, 64, 64, 2, "mn", 1, "f32", "nk"),
]


@pytest.mark.parametrize("cfg", PALLAS_CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(PALLAS_CONFIGS))])
def test_plain_version_matches_pallas_kernel(cfg):
    """Same semantics, step for step: bf16 accumulator rounding per k block,
    split-k slices rounded to bf16 and summed in f32."""
    t, j = both(2, 128, 128, 256)
    b_t = t["b"] if cfg["rhs_layout"] == "kn" else t["b"].t().contiguous()
    b_j = j["b"] if cfg["rhs_layout"] == "kn" else j["b"].T
    got = kernel.gemm_plain(t["a"], b_t, t["c"], alpha=0.75, beta=0.5, **cfg)
    pallas_cfg = {key: v for key, v in cfg.items() if key != "warps"}
    want = jkernel.gemm(j["a"], b_j, j["c"], alpha=0.75, beta=0.5,
                        interpret=True, **pallas_cfg)
    err = rel_l2(as_np(got), as_np(want))
    assert err <= TOLS[cfg["acc_dtype"]]
    assert err <= PALLAS_TOL
    if cfg["acc_dtype"] == "bf16":
        # the control: with an f32 accumulator the plain version misses the
        # Pallas result by more than both tight tolerances, so neither the
        # Pallas comparison nor the kernel's on the card (kernel.PLAIN_TOL)
        # would pass a version that skipped the bf16 rounding
        f32 = kernel.gemm_plain(t["a"], b_t, t["c"], alpha=0.75, beta=0.5,
                                **dict(cfg, acc_dtype="f32"))
        miss = rel_l2(as_np(f32), as_np(want))
        assert miss > max(PALLAS_TOL, kernel.PLAIN_TOL), miss


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    t, _ = both(3, 128, 128, 256)
    before = ops.gemm.launches
    for cfg in PALLAS_CONFIGS[:3]:
        b = t["b"] if cfg["rhs_layout"] == "kn" else t["b"].t().contiguous()
        got = ops.gemm(t["a"], b, t["c"], 0.75, 0.5, cfg)
        want = kernel.gemm_plain(t["a"], b, t["c"], alpha=0.75, beta=0.5,
                                 **cfg)
        assert torch.equal(got, want)
    assert ops.gemm.launches == before


def test_default_config_is_in_the_space():
    prob = GemmProblem(device="cpu")
    assert prob.space.satisfies(ops.DEFAULT_CONFIG)


def _bad(case):
    t, _ = both(4, 128, 128, 256)
    a, b, c = t["a"], t["b"], t["c"]
    cfg = dict(ops.DEFAULT_CONFIG)
    if case == "layout":
        return a, b.t().contiguous(), c, cfg             # (N, K) for "kn"
    if case == "contiguity":
        return a.t().contiguous().t(), b, c, cfg
    if case == "divisibility":
        return a, b, c, dict(cfg, block_m=256)
    if case == "split_depth":
        return a, b, c, dict(cfg, split_k=8, block_k=64)
    return a[:, :2].contiguous(), b, c, cfg          # "shape"


@pytest.mark.parametrize("case", ["layout", "contiguity", "divisibility",
                                  "split_depth", "shape"])
def test_dispatch_raises_on_what_the_kernel_cannot_take(case):
    a, b, c, cfg = _bad(case)
    with pytest.raises(ValueError):
        ops.gemm(a, b, c, 1.0, 1.0, cfg)
