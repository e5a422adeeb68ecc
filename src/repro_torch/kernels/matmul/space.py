"""The ``gemm_h100`` problem: a Hopper search space and a measured evaluator.

The space speaks the kernel's vocabulary (``csrc/gemm.cu``): output tile
``block_m`` x ``block_n``, k-block depth ``block_k``, ``unroll_k`` sub-dots
per k block, ``warps`` per block, the block raster ``grid_order``,
``split_k``, the accumulator's stored dtype and B's layout.  Its
constraints admit exactly the configs the compiled libraries can launch:
every admitted config launches, so a failed launch is a fault in the space
or the kernel, never a silently invalid trial.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import SMEM_PER_BLOCK, KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"m": 256, "n": 256, "k": 512}


def build_space(m: int, n: int, k: int) -> SearchSpace:
    """The ``gemm_h100`` space for an (m, n, k) problem."""
    params = [
        Param("block_m", kernel.BLOCK_MN),
        Param("block_n", kernel.BLOCK_MN),
        Param("block_k", kernel.BLOCK_K),
        Param("unroll_k", kernel.UNROLL_K),
        Param("warps", kernel.WARPS),
        Param("grid_order", ("mn", "nm")),
        Param("split_k", (1, 2, 4, 8)),
        Param("acc_dtype", ("f32", "bf16")),
        Param("rhs_layout", ("kn", "nk")),
    ]
    acc_cap = kernel.MAX_ACC_PER_THREAD

    def smem_ok(c: Config) -> bool:
        return kernel.smem_bytes(c["block_m"], c["block_n"], c["block_k"],
                                 c["warps"], int(c["rhs_layout"] == "nk")) \
            <= SMEM_PER_BLOCK

    def smem_ok_vec(c: dict) -> np.ndarray:
        return kernel.smem_bytes(c["block_m"], c["block_n"], c["block_k"],
                                 c["warps"],
                                 (c["rhs_layout"] == "nk").astype(np.int64)) \
            <= SMEM_PER_BLOCK

    constraints = [
        # the reference's fits_shape, tightened to what the kernel needs:
        # every block divides its dimension, and each k slice holds whole
        # k blocks
        Constraint("fits_shape", lambda c: c["block_m"] <= m
                   and c["block_n"] <= n and c["split_k"] * c["block_k"] <= k
                   and m % c["block_m"] == 0 and n % c["block_n"] == 0
                   and k % c["split_k"] == 0
                   and (k // c["split_k"]) % c["block_k"] == 0,
                   vec=lambda c: (c["block_m"] <= m) & (c["block_n"] <= n)
                   & (c["split_k"] * c["block_k"] <= k)
                   & (m % c["block_m"] == 0) & (n % c["block_n"] == 0)
                   & (k % c["split_k"] == 0)
                   & ((k // c["split_k"]) % c["block_k"] == 0)),
        # a sub-dot is at least one 16-deep WMMA fragment
        Constraint("unroll_divides", lambda c: c["block_k"] % c["unroll_k"] == 0
                   and c["block_k"] // c["unroll_k"] >= 16,
                   vec=lambda c: (c["block_k"] % c["unroll_k"] == 0)
                   & (c["block_k"] // c["unroll_k"] >= 16)),
        Constraint("smem", smem_ok, vec=smem_ok_vec),
        # f32 accumulators per thread within the register budget (128 keeps
        # every compiled tile free of spills; chip_smoke.py checks that)
        Constraint("registers", lambda c: c["block_m"] * c["block_n"]
                   <= acc_cap * 32 * c["warps"],
                   vec=lambda c: c["block_m"] * c["block_n"]
                   <= acc_cap * 32 * c["warps"]),
        # 2 x warps/2 warps, each a whole number of 16x16 fragments
        Constraint("warp_tiling", lambda c: c["block_m"] % 32 == 0
                   and c["block_n"] % (8 * c["warps"]) == 0,
                   vec=lambda c: (c["block_m"] % 32 == 0)
                   & (c["block_n"] % (8 * c["warps"]) == 0)),
    ]
    return SearchSpace(params, constraints, name="gemm_h100")


def numpy_inputs(seed: int, m: int, n: int, k: int) -> dict:
    """A, B (K, N) and C drawn from N(0, 1) with numpy; alpha 0.75 and beta
    0.5 as in the JAX package's ``make_inputs``."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((m, k), np.float32),
            "b": rng.standard_normal((k, n), np.float32),
            "c": rng.standard_normal((m, n), np.float32),
            "alpha": 0.75, "beta": 0.5}


class GemmProblem(KernelProblem):
    kernel_name = "gemm_h100"
    # paper-scale shape (CLBlast benchmarks tune 4096^3-class GEMMs)
    default_shape = {"m": 4096, "n": 4096, "k": 4096}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use
    _b_nk: torch.Tensor | None = None

    def build_space(self) -> SearchSpace:
        return build_space(self.shape["m"], self.shape["n"], self.shape["k"])

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(
            numpy_inputs(seed, dims["m"], dims["n"], dims["k"]),
            self.device if device is None else device)

    def run_reference(self, config: Config, inputs: dict):
        return ref.gemm_reference(inputs["a"], inputs["b"], inputs["c"],
                                  inputs["alpha"], inputs["beta"])

    def run_kernel(self, config: Config, inputs: dict):
        b = inputs["b"]
        b_in = b if config["rhs_layout"] == "kn" else b.t().contiguous()
        return ops.gemm(inputs["a"], b_in, inputs["c"], inputs["alpha"],
                        inputs["beta"], config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.gemm`` call at the problem's shape; B is laid out for
        the config before timing starts."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        if config["rhs_layout"] == "kn":
            b = x["b"]
        else:
            if self._b_nk is None:
                self._b_nk = x["b"].t().contiguous()
            b = self._b_nk
        a, c, alpha, beta = x["a"], x["c"], x["alpha"], x["beta"]
        return lambda: ops.gemm(a, b, c, alpha, beta, config)
