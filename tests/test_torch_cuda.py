"""The port on a Hopper card: the CUDA GEMM and flash attention against their
plain versions, and the measured evaluator.  Marked ``cuda``; each test
skips on a host without an sm_90 device.  This file imports no JAX, so it
also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.attention import ops as fops  # noqa: E402
from repro_torch.kernels.attention.space import AttentionProblem  # noqa: E402
from repro_torch.kernels.attention.space import (  # noqa: E402
    inputs_from_numpy, numpy_inputs)
from repro_torch.kernels.matmul import kernel, ops  # noqa: E402
from repro_torch.kernels.matmul.space import SMALL_SHAPE, GemmProblem  # noqa: E402
from repro_torch.quickstart import rel_l2, tolerance  # noqa: E402

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
        assert err <= tolerance("gemm_h100", cfg), cfg
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


@pytest.mark.parametrize("shape,causal", [
    ((4, 2, 256, 256, 64), True), ((4, 2, 256, 256, 64), False),
    ((4, 2, 128, 256, 64), True), ((8, 2, 256, 128, 128), True)],
    ids=["small", "full_mask", "tq<tk", "tq>tk_d128"])
def test_attention_kernel_matches_plain_version(hopper, shape, causal):
    prob = AttentionProblem(shape=dict(zip(("hq", "hkv", "tq", "tk", "d"),
                                           shape)), device="cuda")
    x = inputs_from_numpy(numpy_inputs(0, *shape), "cuda")
    q, k, v = x["q"], x["k"], x["v"]
    for cfg in prob.space.sample_distinct(8, 1):
        before = fops.attention.launches
        got = fops.attention(q, k, v, causal=causal, config=cfg)
        want = fkernel.flash_attention_plain(q, k, v, causal=causal, **cfg)
        torch.cuda.synchronize()
        assert fops.attention.launches == before + 1
        assert torch.isfinite(got).all()
        err = rel_l2(got, want)
        assert err <= tolerance(prob.name, cfg), cfg
        assert err <= fkernel.PLAIN_TOL, (err, cfg)
        if cfg["acc_dtype"] == "bf16" and shape[3] > cfg["block_kv"]:
            # more than one kv tile: the bf16 rounding shows, and the kernel
            # is nearer the bf16-accumulator plain version
            f32 = fkernel.flash_attention_plain(
                q, k, v, causal=causal, **dict(cfg, acc_dtype="f32"))
            assert rel_l2(got, f32) > err, cfg


def test_attention_measured_evaluator_times_the_kernel(hopper):
    prob = AttentionProblem(shape=AttentionProblem.small_shape,
                            device="cuda")
    before = fops.attention.launches
    t = prob.evaluate(fops.DEFAULT_CONFIG)
    assert t.ok and t.arch == prob.arch != "cpu"
    assert fops.attention.launches - before == prob.warmup + prob.repeats
    assert 0 < t.info["min_s"] <= t.objective <= t.info["max_s"]
