"""The ``conv2d_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/conv2d.cu``), with Hopper's ranges, and adds ``col_chunk``:

* ``block_h`` (8 to 64) x ``block_w`` (32 to 256): the output tile of one
  block.  Its input tile, halo included, is staged in shared memory:
  (block_h + F - 1) rows of block_w + F - 1 f32, padded to a multiple of 4,
  at most 86 KB at F = 15.  The reference's tiles up to 256 x 4096 fit a
  TPU's VMEM, not 227 KB of shared memory.  block_h 1 to 4 are gone: the
  14 halo rows a tile stages at F 15 are 4.5 to 15 times the rows it
  computes.  block_w 16 is gone: with at least ``kernel.ROW_THREADS``
  threads a row it admitted only col_chunk 1.
* ``row_chunk`` (1, 2, 4, 8) x ``col_chunk`` (1, 2, 4): the outputs a
  thread computes in registers, the tile_size_y and tile_size_x of the BAT
  convolution.  A block runs (block_w / col_chunk) x (block_h / row_chunk)
  threads: 128 to the tile's launch bound, ``kernel.max_threads`` (512, so
  128 registers a thread; 384 and 168 registers for the bf16 8 x 4 tile,
  which spilled at 128), at least ``kernel.ROW_THREADS`` of them along a
  row.  col_chunk 8 is gone: its 22-value windows spilled at every
  register bound tried (128, 168 and 255), and it was never faster than 4
  in the first card run.  The reference's row_chunk 0 (all rows at once) is
  a TPU vector-register choice with no thread to hold it.
* ``unroll_fh``, ``unroll_fw`` (1, 3, 5, 15): taps per unrolled chunk of
  the filter's rows and columns, divisors of F as the reference's.  A chunk
  of unroll_fh rows reads row_chunk + unroll_fh - 1 input rows, so rolled
  rows re-read the rows their chunks share; a rolled column chunk loads its
  own window.  Fully unrolled, the taps are straight-line code, row_chunk x
  col_chunk x F^2 FMAs a thread.
* ``acc_dtype`` (f32, bf16) and ``filter_smem`` (the filter in shared
  memory, or in ``__constant__`` memory: the paper's read-only choice).

Every row_chunk and col_chunk divides every block_h and block_w of the
menus.  Blocks mask the ragged edge, so no tile needs to divide the
output.  The constraints admit exactly the configs the compiled libraries
can launch.  :meth:`Conv2dProblem.feature_math` gives the Hopper cost model
the kernel's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import (SMEM_PER_BLOCK, KernelProblem, bound_regs,
                      inputs_from_numpy)
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"h": 48, "w": 160, "fh": 5, "fw": 5}
#: (h, w, fh, fw) at which every compiled tile is held against the plain
#: version: outputs that no block divides, with rows of a multiple of 4
#: floats (staged by cp.async) and without (staged by plain loads)
TILE_SHAPES = ((101, 308, 5, 5), (101, 307, 5, 5), (300, 604, 15, 15),
               (301, 603, 15, 15))


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
        Param("col_chunk", kernel.COL_CHUNK),
        Param("acc_dtype", ("f32", "bf16")),
        Param("filter_smem", (0, 1)),
    ]
    lo = kernel.MIN_THREADS

    def threads_ok(c):
        t = kernel.threads(c["block_h"], c["block_w"], c["row_chunk"],
                           c["col_chunk"])
        return (lo <= t) & (t <= kernel.max_threads(
            c["row_chunk"], c["col_chunk"], c["acc_dtype"]))

    def row_ok(c):
        return c["block_w"] // c["col_chunk"] >= kernel.ROW_THREADS

    def smem_ok(c):
        return kernel.smem_bytes(c["block_h"], c["block_w"], fh,
                                 c["filter_smem"]) <= SMEM_PER_BLOCK

    constraints = [
        Constraint("threads", lambda c: bool(threads_ok(c)), vec=threads_ok),
        Constraint("row_threads", lambda c: bool(row_ok(c)), vec=row_ok),
        Constraint("smem", lambda c: bool(smem_ok(c)), vec=smem_ok),
    ]
    return SearchSpace(params, constraints, name="conv2d_h100")


def tile_configs(h: int, w: int, fh: int, fw: int) -> list[dict]:
    """One admitted config for every compiled tile at this shape: each
    (unroll_fh, row_chunk x col_chunk, unroll_fw, acc_dtype, filter_smem)
    the libraries hold for the filter's size, with the admitted block
    shapes cycled."""
    space = build_space(h, w, fh, fw)
    cfgs = space.valid_configs()
    out = []
    for i, (uh, (rc, cc), uw, acc, fs) in enumerate(
            (uh, t, uw, acc, fs)
            for uh in space.param("unroll_fh").values for t in kernel.TILES
            for uw in space.param("unroll_fw").values
            for acc in ("f32", "bf16") for fs in (0, 1)):
        fits = [c for c in cfgs if (c["unroll_fh"], c["row_chunk"],
                                    c["col_chunk"], c["unroll_fw"],
                                    c["acc_dtype"], c["filter_smem"])
                == (uh, rc, cc, uw, acc, fs)]
        out.append(fits[i % len(fits)])
    return out


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

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/conv2d.cu``): F^2 taps an output of
        every block (the ragged edge computed too), each one FFMA (in bf16
        a bf16x2 multiply and add for two columns, so two instructions a
        tap at col_chunk 1); the shared words of
        :func:`~repro_torch.kernels.conv2d.kernel.loads_per_fma` (the menus
        hold only divisors of F, which it would snap to), the image's
        loaded col_chunk words an instruction, the filter's (with
        ``filter_smem``) read by a whole warp at once; the rolled chunks'
        per-lane constant filter loads (one a filter value and chunk of
        outputs) and 4 of loop a trip; staging each block's tile with its
        halo from L2, a 16-byte copy and its wait per 4 words, behind one
        barrier (a synchronised step); the image and output cross HBM
        once."""
        h, w, f = self.shape["h"], self.shape["w"], self.shape["fh"]
        oh, ow = h - f + 1, w - f + 1
        bh, bw = c["block_h"], c["block_w"]
        ry, rx = c["row_chunk"], c["col_chunk"]
        uh, uw, fs = c["unroll_fh"], c["unroll_fw"], c["filter_smem"]
        blocks = (-(-oh // bh)) * (-(-ow // bw))
        taps = blocks * bh * bw * float(f * f)
        image = (ry + uh - 1) * (rx + uw - 1) / (ry * rx * uh * uw)
        words = image + fs / (32.0 * rx)
        rolled = (uh < f) | (uw < f)
        per_tap = (np.where((c["acc_dtype"] == "bf16") & (rx == 1), 2.0, 1.0)
                   + image / rx + fs / (4.0 * rx)
                   + np.where(rolled & (fs == 0), 1.0 / (ry * rx), 0.0)
                   + 4.0 / (ry * rx * uh * uw))
        staged = blocks * (bh + f - 1) * kernel.pitch(bw, f) * 4.0
        threads = kernel.threads(bh, bw, ry, rx)
        cap = bound_regs(kernel.max_threads(ry, rx, c["acc_dtype"]))
        return {"f32_inst": taps * per_tap + staged / 8.0,
                "smem_words": taps * words, "ilp": ry * rx, "steps": 1,
                "hbm_bytes": 4.0 * (h * w + oh * ow + f * f),
                "l2_bytes": staged - 4.0 * h * w,
                "smem_per_block": kernel.smem_bytes(bh, bw, f, fs),
                "threads": threads,
                "regs": np.minimum(cap, 24 + ry * rx + 2 * (rx + uw - 1)),
                "blocks": blocks}

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
