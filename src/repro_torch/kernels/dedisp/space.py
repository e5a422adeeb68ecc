"""The ``dedisp_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/dedisp.cu``), with Hopper's ranges:

* ``block_d`` (8 to 128): DMs per block.  The reference's 256 and 512
  cannot be admitted here (below).
* ``block_c`` (1 to 64): channels per step; the step's slice of the delay
  table, block_c x block_d int32 (at most 32 KB), is staged in shared
  memory.
* ``time_chunk`` (0 for the whole of t_out, else 256 up to t_out): output
  samples per block, walked in passes of (threads along time) x (samples
  a thread).
* ``unroll_d`` (1, 2, 4, 8): DMs a thread accumulates in registers; it
  divides ``block_d``.  A block has block_d / unroll_d rows of threads, a
  row along time at least a warp wide and the block at most 512 threads,
  so at most 16 rows; a thread holds at most 32 accumulators (unroll_d x
  its samples, at most 16 samples), so no compiled tile spills.
* ``acc_dtype`` (f32, bf16), as the reference.

The samples x are read through the L1 cache, not staged: one channel's
window for a DM block is time_chunk plus the delay span of the block's
DMs, which reaches 8192 samples at the reference's shape (55 % of its
delays are clipped there), so the shared-memory constraint bounds only the
delay slice, which always fits.  The reference's VMEM budget, which ruled
out staging whole channels, has no counterpart.  Blocks mask the ragged
ends.  The constraints admit exactly the configs the compiled library
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``:
#: 12 channels, 24 DMs, 160 samples out of 416, DM step 0.05)
SMALL_SHAPE = {"c": 12, "d": 24, "t_out": 160, "t_in": 416, "dm_step": 0.05}
#: samples beyond t_out at the reference's shape: the largest delay
MAX_DELAY = 8192


def dims(shape: dict) -> tuple:
    """(C, D, t_out, T, dm_step) of a shape; T and the DM step default to the
    reference's t_out + 8192 and 1.0."""
    return (shape["c"], shape["d"], shape["t_out"],
            shape.get("t_in", shape["t_out"] + MAX_DELAY),
            shape.get("dm_step", 1.0))


def build_space(d: int, t_out: int) -> SearchSpace:
    """The ``dedisp_h100`` space for ``d`` DMs and ``t_out`` samples out."""
    rows = kernel.MAX_THREADS // kernel.MIN_ROW
    # the menus trimmed to the shape: a block of more DMs than there are,
    # or a chunk longer than t_out (0 already means all of it), is a dead
    # row, as the reference trims its time_chunk menu
    params = [
        Param("block_d", tuple(v for v in kernel.BLOCK_D if v <= d)
              or kernel.BLOCK_D[:1]),
        Param("block_c", kernel.BLOCK_C),
        Param("time_chunk", tuple(v for v in kernel.TIME_CHUNK
                                  if v <= t_out)),
        Param("unroll_d", kernel.UNROLL_D),
        Param("acc_dtype", ("f32", "bf16")),
    ]
    constraints = [
        Constraint("unroll_divides",
                   lambda c: c["block_d"] % c["unroll_d"] == 0,
                   vec=lambda c: c["block_d"] % c["unroll_d"] == 0),
        Constraint("rows", lambda c: c["block_d"] // c["unroll_d"] <= rows,
                   vec=lambda c: c["block_d"] // c["unroll_d"] <= rows),
    ]
    return SearchSpace(params, constraints, name="dedisp_h100")


def numpy_inputs(seed: int, c: int, d: int, t_out: int, t_in: int,
                 dm_step: float) -> dict:
    """Samples x N(0, 1) (C, T) drawn with numpy in f32, as the JAX
    package's ``make_inputs`` draws them with ``jax.random``, and the delay
    table (:func:`ref.make_delays`) clipped to T - t_out, as the reference
    clips it."""
    rng = np.random.default_rng(seed)
    delays = np.minimum(ref.make_delays(c, d, dm_step=dm_step), t_in - t_out)
    return {"x": rng.standard_normal((c, t_in), np.float32),
            "delays": delays.astype(np.int32), "t_out": t_out}


class DedispProblem(KernelProblem):
    kernel_name = "dedisp_h100"
    #: the reference's shape: 1536 channels, 2048 DMs, 4096 samples out of
    #: 4096 + 8192 (ARTS-like, cut 8x in time by the reference)
    default_shape = {"c": 1536, "d": 2048, "t_out": 4096}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use

    def build_space(self) -> SearchSpace:
        return build_space(self.shape["d"], self.shape["t_out"])

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        return inputs_from_numpy(
            numpy_inputs(seed, *dims(SMALL_SHAPE if small else self.shape)),
            self.device if device is None else device, dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return ref.dedisp_reference(inputs["x"], inputs["delays"],
                                    inputs["t_out"])

    def run_kernel(self, config: Config, inputs: dict):
        return ops.dedisp(inputs["x"], inputs["delays"], inputs["t_out"],
                          config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.dedisp`` call at the problem's shape."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        return lambda: ops.dedisp(x["x"], x["delays"], x["t_out"], config)
