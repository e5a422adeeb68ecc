"""The ``hotspot_h100`` problem: a Hopper search space and a measured
evaluator.

The objective is the whole simulation, ``n_total`` sweeps in ceil(n /
tt) launches.  The space keeps the reference's parameters and their
meanings (``csrc/hotspot.cu``), with Hopper's ranges:

* ``block_h`` x ``block_w`` (8 to 128 each): the output tile of one block.
  The block computes it with its halo in whole warps: a lane holds
  ``kernel.ROWS`` (8) rows x C columns in registers, C = ceil((block_w +
  2 tt) / 32) (1 to 5), and the block stacks ceil((block_h + 2 tt) / 8)
  warps.  The reference's 256 to 1024 do not fit the register file.
* ``tt`` (1 to 10): sweeps per launch, with a halo ``tt`` deep.
* ``unroll_t`` (1, 2): sweeps per unrolled chunk of the sweep loop; it
  divides ``tt`` (the reference's constraint), and the last launch snaps it
  down to a divisor of its own sweep count.  With the state in registers an
  unrolled chunk saves only the loop and keeps the edge buffers' parity
  static, so the reference's 3 to 10 are not compiled, and at 5 columns a
  lane (block_w 128) two sweeps unrolled spill, so only 1 is.
* ``power_smem``: 1 holds the power tile on chip for the whole launch, now
  in registers beside the temperature; 0 reads it from device memory (via
  L1) at every sweep.  It is the reference's ``keep_power_vmem``, renamed
  for what it means here.
* ``acc_dtype`` (f32, bf16) and ``grid_order`` (row- or column-major block
  raster), as the reference.

The budget is the register file: a block of C columns a lane may have at
most ``kernel.MAX_THREADS[C]`` threads (the kernel's launch bound, which
caps ptxas at 65 536 / that many registers a lane), which replaces the
reference's VMEM budget.  Shared memory holds only each warp's edge rows,
under 48 KB for every admitted tile.  The reference's ``halo_sane`` (2 tt
<= block_h + 8) is dropped: the kernel launches those tiles, at the cost
of halo work.  Blocks clamp their tiles into the domain, so no tile needs
to divide it.  The constraints admit exactly the configs the compiled
library can launch.  :meth:`HotspotProblem.feature_math` gives the Hopper
cost model the kernel's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, bound_regs, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``
#: takes 4 sweeps on a 40 x 136 domain)
SMALL_SHAPE = {"h": 40, "w": 136, "n_total": 4}


def build_space() -> SearchSpace:
    """The ``hotspot_h100`` space (the same at every shape)."""
    params = [
        Param("block_h", kernel.BLOCK_H),
        Param("block_w", kernel.BLOCK_W),
        Param("tt", kernel.TT),
        Param("unroll_t", kernel.UNROLL_T),
        Param("power_smem", (0, 1)),
        Param("acc_dtype", ("f32", "bf16")),
        Param("grid_order", ("rm", "cm")),
    ]

    def registers_ok(c):
        return kernel.fits(c["block_h"], c["block_w"], c["tt"]) \
            & kernel.compiled(c["block_w"], c["tt"], c["unroll_t"])

    constraints = [
        Constraint("unroll_divides_tt", lambda c: c["tt"] % c["unroll_t"] == 0,
                   vec=lambda c: c["tt"] % c["unroll_t"] == 0),
        Constraint("registers", lambda c: bool(registers_ok(c)),
                   vec=registers_ok),
    ]
    return SearchSpace(params, constraints, name="hotspot_h100")


def numpy_inputs(seed: int, h: int, w: int, n: int) -> dict:
    """Temperature 60 + 20 U(0, 1) and power U(0, 1) on the domain padded by
    ``n`` on every side, drawn with numpy in f32 as the JAX package's
    ``make_inputs`` draws them with ``jax.random``; ``n`` sweeps, and the
    central crop ``n`` deep is what is compared."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * n, w + 2 * n
    temp = (60 + 20 * rng.random((hp, wp), np.float32)).astype(np.float32)
    return {"temp": temp, "power": rng.random((hp, wp), np.float32),
            "n_sweeps": n, "crop": n}


def crop(out: torch.Tensor, c: int) -> torch.Tensor:
    return out[c:out.shape[0] - c, c:out.shape[1] - c]


class HotspotProblem(KernelProblem):
    kernel_name = "hotspot_h100"
    #: the reference's shape: a 2048 x 2048 domain, 600 sweeps (padded by
    #: 600 on every side, so 3248 x 3248 is computed)
    default_shape = {"h": 2048, "w": 2048, "n_total": 600}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use

    def build_space(self) -> SearchSpace:
        return build_space()

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/hotspot.cu``): ceil(n / tt)
        launches over the padded domain, each block sweeping its whole
        register block (warps x 8 rows x 32 C columns, halo and waste
        included) every sweep, at 9 f32 instructions a cell (14 in bf16,
        whose operations do not fuse) and one more where power is read
        through L1 (``power_smem`` 0); a lane's edge exchange a sweep
        (16 shuffles, 4 C shared-memory operations, its barrier, 3 of loop
        a chunk of ``unroll_t``), each sweep a synchronised step;
        temperature and power read and
        temperature written through HBM every launch, the blocks' halos
        again from L2."""
        n = self.shape["n_total"]
        hh, ww = self.shape["h"] + 2 * n, self.shape["w"] + 2 * n
        bh, bw, tt = c["block_h"], c["block_w"], c["tt"]
        cols, wy = kernel.cols(bw, tt), kernel.warps(bh, tt)
        launches = -(-n // tt)
        blocks = (-(-hh // bh)) * (-(-ww // bw))
        lanes = blocks * wy * 32 * float(n)          # lane-sweeps
        cells = lanes * kernel.ROWS * cols
        per_cell = (np.where(c["acc_dtype"] == "bf16", 14.0, 9.0)
                    + np.where(c["power_smem"] == 1, 0.0, 1.0))
        per_lane = 16.0 + 4.0 * cols + 2.0 + 3.0 / c["unroll_t"]
        most = np.select([cols == k for k in kernel.COLS],
                         [kernel.MAX_THREADS[k] for k in kernel.COLS])
        return {"f32_inst": cells * per_cell + lanes * per_lane,
                "smem_words": lanes * 4.0 * cols,
                "ilp": kernel.ROWS * cols, "steps": n,
                "hbm_bytes": 12.0 * hh * ww * launches,
                "l2_bytes": (8.0 * blocks * (bh + 2 * tt) * (bw + 2 * tt)
                             - 8.0 * hh * ww) * launches,
                # two parities of a top and a bottom edge row a warp
                "smem_per_block": 2 * 2 * wy * 32 * cols * 4,
                "threads": 32 * wy, "regs": bound_regs(most),
                "blocks": blocks, "launches": launches}

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(
            numpy_inputs(seed, *(dims[k] for k in ("h", "w", "n_total"))),
            self.device if device is None else device, dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return crop(ref.hotspot_reference(inputs["temp"], inputs["power"],
                                          inputs["n_sweeps"]),
                    inputs["crop"])

    def run_kernel(self, config: Config, inputs: dict):
        return crop(ops.hotspot(inputs["temp"], inputs["power"],
                                inputs["n_sweeps"], config), inputs["crop"])

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.hotspot`` call at the problem's shape: all the sweeps."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        return lambda: ops.hotspot(x["temp"], x["power"], x["n_sweeps"],
                                   config)
