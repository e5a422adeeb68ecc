"""The ``conv2d_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/conv2d.cu``), with Hopper's ranges:

* ``block_h`` (1 to 64) x ``block_w`` (16 to 256): the output tile of one
  block.  Its input tile, halo included, is staged in shared memory:
  (block_h + F - 1) x (block_w + F - 1) f32, at most 84 KB at F = 15.  The
  reference's tiles up to 256 x 4096 fit a TPU's VMEM, not 227 KB of
  shared memory.
* ``row_chunk`` (1, 2, 4, 8): output rows a thread computes, so a block
  runs block_w x (block_h / row_chunk) threads; it divides ``block_h``,
  and a block has 32 to 512 threads (at most 512 keep 128 registers a
  thread, so no tile spills).  The reference's 0 (all rows at once) is a
  TPU vector-register choice with no thread to hold it.
* ``unroll_fh``, ``unroll_fw`` (1, 3, 5, 15): taps per unrolled chunk of
  the filter's rows and columns, divisors of F as the reference's.
* ``acc_dtype`` (f32, bf16) and ``filter_smem`` (the filter in shared
  memory, or in ``__constant__`` memory: the paper's read-only choice).

Blocks mask the ragged edge, so no tile needs to divide the output.  The
constraints admit exactly the configs the compiled libraries can launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import SMEM_PER_BLOCK, KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"h": 48, "w": 160, "fh": 5, "fw": 5}


def build_space(h: int, w: int, fh: int, fw: int) -> SearchSpace:
    """The ``conv2d_h100`` space for an (h, w) image and an (fh, fw)
    filter."""
    oh, ow = h - fh + 1, w - fw + 1
    # the menus trimmed to the shape, as the reference's fits_shape and
    # unroll_divides constraints trim them
    params = [
        Param("block_h", tuple(b for b in kernel.BLOCK_H if b <= oh)),
        Param("block_w", tuple(b for b in kernel.BLOCK_W if b <= ow)),
        Param("unroll_fh", tuple(u for u in kernel.UNROLL if fh % u == 0)),
        Param("unroll_fw", tuple(u for u in kernel.UNROLL if fw % u == 0)),
        Param("row_chunk", kernel.ROW_CHUNK),
        Param("acc_dtype", ("f32", "bf16")),
        Param("filter_smem", (0, 1)),
    ]
    lo, hi = kernel.MIN_THREADS, kernel.MAX_THREADS

    def threads_ok(c):
        t = kernel.threads(c["block_h"], c["block_w"], c["row_chunk"])
        return (lo <= t) & (t <= hi)

    constraints = [
        Constraint("row_chunk_divides",
                   lambda c: c["block_h"] % c["row_chunk"] == 0,
                   vec=lambda c: c["block_h"] % c["row_chunk"] == 0),
        Constraint("threads", lambda c: bool(threads_ok(c)), vec=threads_ok),
        Constraint("smem", lambda c: kernel.smem_bytes(
            c["block_h"], c["block_w"], fh, c["filter_smem"])
            <= SMEM_PER_BLOCK,
            vec=lambda c: kernel.smem_bytes(
                c["block_h"], c["block_w"], fh, c["filter_smem"])
            <= SMEM_PER_BLOCK),
    ]
    return SearchSpace(params, constraints, name="conv2d_h100")


def numpy_inputs(seed: int, h: int, w: int, fh: int, fw: int) -> dict:
    """Image and filter drawn from N(0, 1) with numpy in f32, as the JAX
    package's ``make_inputs`` draws them with ``jax.random``."""
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((h, w), np.float32),
            "filt": rng.standard_normal((fh, fw), np.float32)}


class Conv2dProblem(KernelProblem):
    kernel_name = "conv2d_h100"
    #: the reference's shape: a 4096 x 4096 image, a 15 x 15 filter
    default_shape = {"h": 4096, "w": 4096, "fh": 15, "fw": 15}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use

    def build_space(self) -> SearchSpace:
        return build_space(*(self.shape[k] for k in ("h", "w", "fh", "fw")))

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(
            numpy_inputs(seed, *(dims[k] for k in ("h", "w", "fh", "fw"))),
            self.device if device is None else device, dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return ref.conv2d_reference(inputs["image"], inputs["filt"])

    def run_kernel(self, config: Config, inputs: dict):
        return ops.conv2d(inputs["image"], inputs["filt"], config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.conv2d`` call at the problem's shape."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        image, filt = self._inputs["image"], self._inputs["filt"]
        return lambda: ops.conv2d(image, filt, config)
