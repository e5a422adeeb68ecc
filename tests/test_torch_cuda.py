"""The port on a Hopper card: the CUDA GEMM against its plain version, and the
measured evaluator.  Marked ``cuda``; each test skips on a host without an
sm_90 device.  This file imports no JAX, so it also runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.matmul import kernel, ops  # noqa: E402
from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem  # noqa: E402
from repro_torch.quickstart import TOLS, rel_l2  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_version(hopper, seed):
    prob = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    x = prob.make_inputs(seed=seed, small=True)
    b_nk = x["b"].t().contiguous()
    for cfg in prob.space.sample_distinct(8, seed):
        b = x["b"] if cfg["rhs_layout"] == "kn" else b_nk
        before = ops.gemm.launches
        got = ops.gemm(x["a"], b, x["c"], x["alpha"], x["beta"], cfg)
        want = kernel.gemm_plain(x["a"], b, x["c"], alpha=x["alpha"],
                                 beta=x["beta"], **cfg)
        torch.cuda.synchronize()
        assert ops.gemm.launches == before + 1
        err = rel_l2(got, want)
        assert err <= TOLS[cfg["acc_dtype"]], cfg
        assert err <= kernel.PLAIN_TOL, (err, cfg)
        if cfg["acc_dtype"] == "bf16" \
                and SMALL_SHAPE["k"] // cfg["split_k"] > cfg["block_k"]:
            # more than one k block per slice: the bf16 rounding shows, and
            # the kernel is nearer the bf16-accumulator plain version
            f32 = kernel.gemm_plain(x["a"], b, x["c"], alpha=x["alpha"],
                                    beta=x["beta"], **dict(cfg, acc_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


def test_measured_evaluator_times_the_kernel(hopper):
    prob = GemmProblem(shape=SMALL_SHAPE, device="cuda")
    before = ops.gemm.launches
    t = prob.evaluate(ops.DEFAULT_CONFIG)
    assert t.ok and t.arch == prob.arch != "cpu"
    assert ops.gemm.launches - before == prob.warmup + prob.repeats
    assert 0 < t.info["min_s"] <= t.objective <= t.info["max_s"]
