"""The ``nbody_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/nbody.cu``), with Hopper's ranges:

* ``block_i`` (32 to 512): bodies i per block, one a thread.  512 threads
  at most keep 128 registers a thread, so no tile spills; the reference's
  8 and 16 are below a warp.
* ``block_j`` (128 to 4096): bodies j staged per tile in shared memory,
  16 B each, so 2 KB to 64 KB a block (the TPU's VMEM budget bounded the
  reference at 2048).
* ``layout``: three position rows plus mass (SoA) or one float4 a body
  (AoS) in device memory.
* ``unroll_j`` (1, 2, 4, 8): bodies per unrolled chunk of the inner loop;
  it divides ``block_j``.  The reference's floor of 128 lanes a chunk is a
  TPU one and is dropped.
* ``rsqrt_method`` (exact, approx) and ``compute_dtype`` (f32, bf16), as
  the reference.

The kernel does not mask a ragged end, so both blocks divide N.  Its
constraints admit exactly the configs the compiled library can launch.
:meth:`NbodyProblem.feature_math` gives the Hopper cost model the kernel's
counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"n": 512}


def build_space(n: int) -> SearchSpace:
    """The ``nbody_h100`` space for ``n`` bodies."""
    # the menus trimmed to blocks that divide N, as the reference's
    # blocks_fit_n trims them
    params = [
        Param("block_i", tuple(b for b in kernel.BLOCK_I if n % b == 0)),
        Param("block_j", tuple(b for b in kernel.BLOCK_J if n % b == 0)),
        Param("layout", ("soa", "aos")),
        Param("unroll_j", kernel.UNROLL_J),
        Param("rsqrt_method", ("exact", "approx")),
        Param("compute_dtype", ("f32", "bf16")),
    ]
    constraints = [
        # the reference's blocks_fit_n, tightened to what the kernel needs:
        # both blocks divide N
        Constraint("blocks_divide_n", lambda c: n % c["block_i"] == 0
                   and n % c["block_j"] == 0,
                   vec=lambda c: (n % c["block_i"] == 0)
                   & (n % c["block_j"] == 0)),
        Constraint("unroll_divides", lambda c: c["block_j"] % c["unroll_j"]
                   == 0,
                   vec=lambda c: c["block_j"] % c["unroll_j"] == 0),
    ]
    return SearchSpace(params, constraints, name="nbody_h100")


def numpy_inputs(seed: int, n: int) -> dict:
    """Positions N(0, 1) and masses U(0.5, 1.5), drawn with numpy in f32 as
    the JAX package's ``make_inputs`` draws them with ``jax.random``."""
    rng = np.random.default_rng(seed)
    return {"pos": rng.standard_normal((3, n), np.float32),
            "mass": rng.uniform(0.5, 1.5, n).astype(np.float32)}


class NbodyProblem(KernelProblem):
    kernel_name = "nbody_h100"
    #: the reference's shape: 131 072 bodies
    default_shape = {"n": 131072}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use
    _aos: torch.Tensor | None = None

    def build_space(self) -> SearchSpace:
        return build_space(self.shape["n"])

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/nbody.cu``): N^2 pairs, each 17 f32
        instructions and an rsqrt with ``rsqrt_method`` approx (the
        bound's count), 10 more and a second special-function result for
        the exact path's square root and division, 12 more for the bf16
        roundings, the j body's shared load, and 7 of loop a chunk of
        ``unroll_j``; the body is read from shared memory by a whole warp
        at once (a broadcast); every block stages all N bodies through L2
        (3 instructions a body), a tile of ``block_j`` at a time behind a
        barrier (a synchronised step); the bodies and the output cross
        HBM once."""
        n = self.shape["n"]
        bi, bj, uj = c["block_i"], c["block_j"], c["unroll_j"]
        pairs = float(n) * n
        exact = c["rsqrt_method"] == "exact"
        per_pair = (18.0 + np.where(exact, 10.0, 0.0)
                    + np.where(c["compute_dtype"] == "bf16", 12.0, 0.0)
                    + 7.0 / uj + 3.0 / bi)
        return {"f32_inst": pairs * per_pair,
                "sfu_ops": pairs * np.where(exact, 2.0, 1.0),
                "smem_words": pairs * 4.0 / 32.0, "steps": n // bj,
                "hbm_bytes": 28.0 * n, "l2_bytes": 16.0 * n * (n // bi - 1),
                "smem_per_block": 16 * bj, "threads": bi,
                "regs": 32 + 2 * uj, "blocks": n // bi}

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(numpy_inputs(seed, dims["n"]),
                                 self.device if device is None else device,
                                 dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return ref.nbody_reference(inputs["pos"], inputs["mass"])

    def run_kernel(self, config: Config, inputs: dict):
        if config["layout"] == "aos":
            return ops.nbody(kernel.to_aos(inputs["pos"], inputs["mass"]),
                             None, config)
        return ops.nbody(inputs["pos"], inputs["mass"], config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.nbody`` call at the problem's shape; the bodies are
        laid out for the config before timing starts."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        if config["layout"] == "soa":
            pos, mass = x["pos"], x["mass"]
        else:
            if self._aos is None:
                self._aos = kernel.to_aos(x["pos"], x["mass"])
            pos, mass = self._aos, None
        return lambda: ops.nbody(pos, mass, config)
