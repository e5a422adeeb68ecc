"""The ``gemm_h100`` problem: a Hopper search space and a measured evaluator.

The space speaks the kernel's vocabulary (``csrc/gemm.cu``): output tile
``block_m`` x ``block_n``, k-block depth ``block_k``, ``unroll_k`` wgmma
commit groups per k block, ``warps`` consumer warps per block, ``stages``
buffers in the TMA ring, the block raster ``grid_order``, ``split_k``, the
accumulator's stored dtype and B's layout.  Its
constraints admit exactly the configs the compiled libraries can launch:
every admitted config launches, so a failed launch is a fault in the space
or the kernel, never a silently invalid trial.
:meth:`GemmProblem.feature_math` gives the Hopper cost model the kernel's
counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import (SMEM_PER_BLOCK, KernelProblem, bound_regs, cdiv,
                      inputs_from_numpy)
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
        Param("stages", kernel.STAGES),
        Param("grid_order", ("mn", "nm")),
        Param("split_k", (1, 2, 4, 8)),
        Param("acc_dtype", ("f32", "bf16")),
        Param("rhs_layout", ("kn", "nk")),
    ]
    acc_cap = kernel.MAX_ACC_PER_THREAD

    def smem_ok(c) -> bool | np.ndarray:
        return kernel.smem_bytes(c["block_m"], c["block_n"], c["block_k"],
                                 c["stages"]) <= SMEM_PER_BLOCK

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
        # a commit group is at least one 16-deep wgmma
        Constraint("unroll_divides", lambda c: c["block_k"] % c["unroll_k"] == 0
                   and c["block_k"] // c["unroll_k"] >= 16,
                   vec=lambda c: (c["block_k"] % c["unroll_k"] == 0)
                   & (c["block_k"] // c["unroll_k"] >= 16)),
        Constraint("smem", smem_ok, vec=smem_ok),
        # f32 accumulators per consumer thread within the register budget
        # (128 keeps every compiled tile free of spills; chip_smoke.py
        # checks that)
        Constraint("registers", lambda c: c["block_m"] * c["block_n"]
                   <= acc_cap * 32 * c["warps"],
                   vec=lambda c: c["block_m"] * c["block_n"]
                   <= acc_cap * 32 * c["warps"]),
        # each consumer warpgroup takes whole 64-row wgmmas of N 64..256:
        # two split block_m >= 128 by rows, else block_n >= 128 by columns
        Constraint("wgmma_tiling", lambda c: c["warps"] == 4
                   or c["block_m"] >= 128 or c["block_n"] >= 128,
                   vec=lambda c: (c["warps"] == 4) | (c["block_m"] >= 128)
                   | (c["block_n"] >= 128)),
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

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/gemm.cu``): 2 m n k FLOPs on the
        tensor cores in m64 x N x k16 wgmmas (N the block's columns a
        consumer warpgroup takes), A's and B's smem words each wgmma reads,
        the epilogue's two f32 instructions an output and, with a bf16
        accumulator, three a stored accumulator a k block (its rounding
        and the wait before it); A, B, C and the output once from HBM, A
        and B again from L2 for every other block column and row; with
        split-k the (split_k, M, N) partials and ``combine_split``'s
        PyTorch ops (2 split_k + 2 launches, each over M N values).  A
        block's registers are its launch bound's: the space keeps the
        accumulators within ``kernel.MAX_ACC_PER_THREAD``, so none
        spill."""
        m, n, k = self.shape["m"], self.shape["n"], self.shape["k"]
        bm, bn, bk = c["block_m"], c["block_n"], c["block_k"]
        sk, warps = c["split_k"], c["warps"]
        wg = warps // 4
        # two consumer warpgroups split block_m >= 128 by rows, else
        # block_n by columns
        n_issue = np.where((wg == 2) & (bm < 128), bn // 2, bn)
        flops = 2.0 * m * n * k
        wgmmas = flops / (2.0 * 64 * n_issue * 16)
        gm, gn = cdiv(m, bm), cdiv(n, bn)
        bf16_acc = c["acc_dtype"] == "bf16"
        f32 = 2.0 * m * n + np.where(bf16_acc, 3.0 * m * n * (k // bk), 0.0)
        split = sk > 1
        # A and B once; C read and the output written (4 B an output), or
        # the bf16 partials written and combined: each part read as bf16
        # and turned f32 (6 B), added into the f32 sum (12 B), then beta C
        # and the cast (24 B)
        hbm = 2.0 * (m * k + k * n) + np.where(
            split, 20.0 * m * n * sk + 24.0 * m * n, 4.0 * m * n)
        threads = 128 * (wg + 1)
        return {"tc_flops": flops, "tile_m": 64, "tile_n": n_issue,
                "tile_k": 16, "f32_inst": f32,
                "smem_words": wgmmas * (64 * 16 + n_issue * 16) / 2.0,
                "hbm_bytes": hbm,
                "l2_bytes": 2.0 * m * k * (gn - 1) + 2.0 * k * n * (gm - 1),
                "smem_per_block": kernel.smem_bytes(bm, bn, bk, c["stages"]),
                "threads": threads, "regs": bound_regs(threads),
                "blocks": gm * gn * sk, "stages": c["stages"],
                "launches": np.where(split, 2 * sk + 3, 1)}

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
