"""The ``expdist_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/expdist.cu``), with Hopper's ranges:

* ``block_i`` (32 to 512): points a_i per block, one a thread.  512
  threads at most keep 128 registers a thread; the reference's 8 and 16
  are below a warp.
* ``block_j`` (128 to 2048): points b_j per tile staged in shared memory,
  12 B each (x, y, sb^2), so 1.5 KB to 24 KB a block.
* ``use_column`` and ``n_y_blocks``: one column of blocks walking every j
  tile in order, or ``n_y_blocks`` columns each walking every
  ``n_y_blocks``-th tile; a (gi, njb) array of partials either way.  The
  reference's constraints stay: ``n_y_blocks`` is 1 with ``use_column``,
  and at most the number of j tiles (more would be cut to it).
* ``unroll_j`` (1, 2, 4): terms per unrolled step of the inner loop; it
  divides ``block_j``.  The reference's floor of 128 lanes a chunk is a
  TPU one and is dropped.
* ``exp_variant`` (exp, exp2) and ``compute_dtype`` (f32, bf16), as the
  reference.

Blocks mask the ragged ends, so no block needs to divide the point
counts.  The constraints admit exactly the configs the compiled library
launches.  :meth:`ExpdistProblem.feature_math` gives the Hopper cost model
the kernel's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, cdiv, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"ka": 384, "kb": 320}


def build_space(kb: int) -> SearchSpace:
    """The ``expdist_h100`` space for ``kb`` points b."""
    # n_y_blocks beyond the largest j grid (smallest block_j) can never be
    # admitted: the reference trims them from the menu too
    max_grid = cdiv(kb, min(kernel.BLOCK_J))
    params = [
        Param("block_i", kernel.BLOCK_I),
        Param("block_j", kernel.BLOCK_J),
        Param("use_column", (0, 1)),
        Param("n_y_blocks", tuple(v for v in kernel.N_Y_BLOCKS
                                  if v <= max_grid)),
        Param("unroll_j", kernel.UNROLL_J),
        Param("exp_variant", ("exp", "exp2")),
        Param("compute_dtype", ("f32", "bf16")),
    ]
    constraints = [
        Constraint("column_implies_single",
                   lambda c: not c["use_column"] or c["n_y_blocks"] == 1,
                   vec=lambda c: (c["use_column"] == 0)
                   | (c["n_y_blocks"] == 1)),
        Constraint("unroll_divides", lambda c: c["block_j"]
                   % c["unroll_j"] == 0,
                   vec=lambda c: c["block_j"] % c["unroll_j"] == 0),
        Constraint("njb_le_grid", lambda c: c["n_y_blocks"]
                   <= cdiv(kb, c["block_j"]),
                   vec=lambda c: c["n_y_blocks"] <= -(-kb // c["block_j"])),
    ]
    return SearchSpace(params, constraints, name="expdist_h100")


def numpy_inputs(seed: int, ka: int, kb: int) -> dict:
    """Points a, b N(0, 1) and uncertainties sa, sb U(0.5, 1.5), drawn with
    numpy in f32 as the JAX package's ``make_inputs`` draws them with
    ``jax.random``."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((2, ka), np.float32),
            "b": rng.standard_normal((2, kb), np.float32),
            "sa": rng.uniform(0.5, 1.5, ka).astype(np.float32),
            "sb": rng.uniform(0.5, 1.5, kb).astype(np.float32)}


class ExpdistProblem(KernelProblem):
    kernel_name = "expdist_h100"
    #: the reference's shape: 65 536 points in each set
    default_shape = {"ka": 65536, "kb": 65536}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use

    def build_space(self) -> SearchSpace:
        return build_space(self.shape["kb"])

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/expdist.cu``): every pair of every
        block (the ragged ends computed too) at 10 f32 instructions and two
        special-function results (the bound's count), 2 more for
        ``exp_variant`` exp's scaling and range step, 6 for the bf16
        roundings, 2 for the j point's shared loads (a broadcast of 3
        words) and 3 of loop a chunk of ``unroll_j``; two launches (the
        second adds the partials); a, b, sa, sb and the partials cross HBM
        once, and each block streams its share of the j points through
        L2, a tile of ``block_j`` at a time behind a barrier (a
        synchronised step)."""
        ka, kb = self.shape["ka"], self.shape["kb"]
        bi, bj = c["block_i"], c["block_j"]
        njb = np.where(c["use_column"] == 1, 1,
                       np.maximum(1, np.minimum(c["n_y_blocks"],
                                                cdiv(kb, bj))))
        gi = cdiv(ka, bi)
        pairs = gi * bi * (1.0 * cdiv(kb, bj) * bj)
        per_pair = (12.0 + np.where(c["exp_variant"] == "exp", 2.0, 0.0)
                    + np.where(c["compute_dtype"] == "bf16", 6.0, 0.0)
                    + 3.0 / c["unroll_j"])
        return {"f32_inst": pairs * per_pair, "sfu_ops": 2.0 * pairs,
                "smem_words": pairs * 3.0 / 32.0,
                "steps": -(-cdiv(kb, bj) // njb),
                "hbm_bytes": 4.0 * (3 * ka + 3 * kb) + 8.0 * gi * njb,
                "l2_bytes": 12.0 * gi * float(kb),
                "smem_per_block": 12 * bj, "threads": bi,
                "regs": 32 + 4 * c["unroll_j"], "blocks": gi * njb,
                "launches": 2}

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(numpy_inputs(seed, dims["ka"], dims["kb"]),
                                 self.device if device is None else device,
                                 dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return ref.expdist_reference(inputs["a"], inputs["b"], inputs["sa"],
                                     inputs["sb"])

    def run_kernel(self, config: Config, inputs: dict):
        return ops.expdist(inputs["a"], inputs["b"], inputs["sa"],
                           inputs["sb"], config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.expdist`` call at the problem's shape."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        return lambda: ops.expdist(x["a"], x["b"], x["sa"], x["sb"], config)
