"""The ``pnpoly_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/pnpoly.cu``):

* ``block_points`` (32 to 4096, powers of two): points per block.  A block
  runs min(block_points, 512) threads, so above 512 each thread takes 2, 4
  or 8 points; 512 threads at most keep 128 registers a thread, and every
  compiled tile free of spills.  The reference's 128 to 4096 is widened
  down to one warp.
* ``unroll_v`` (1, 2, 3, 4, 6, 8): edges per unrolled chunk of the edge
  loop, the rest in a remainder loop, as the reference's.
* ``between_method`` (0 to 3) and ``use_method`` (0 to 2): the twelve
  variants of the test, compiled as separate code paths.
* ``precompute_slope``: slopes once per block into shared memory (V floats,
  2.4 KB at the reference's 600 vertices), or a division per point and
  edge.
* ``coord_layout``: the points as two rows (SoA) or as float2 pairs (AoS).

The vertices sit in 32 KB of ``__constant__`` memory (at most 4096) and
blocks mask the ragged end, so no config is ruled out by the shape but the
reference's own ``unroll_v <= V``: its constraints admit exactly the
configs the compiled libraries can launch.  :meth:`PnpolyProblem.feature_math`
gives the Hopper cost model the kernel's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"n": 1536, "v": 17}


def build_space(n: int, v: int) -> SearchSpace:
    """The ``pnpoly_h100`` space for ``n`` points and a ``v``-gon."""
    if not 1 <= v <= kernel.MAX_V:
        raise ValueError(f"pnpoly_h100: the kernel holds 1 to {kernel.MAX_V} "
                         f"vertices, not {v}")
    params = [
        Param("block_points", kernel.BLOCK_POINTS),
        Param("unroll_v", kernel.UNROLL_V),
        Param("between_method", kernel.BETWEEN_METHODS),
        Param("use_method", kernel.USE_METHODS),
        Param("precompute_slope", (0, 1)),
        Param("coord_layout", ("soa", "aos")),
    ]
    constraints = [
        Constraint("unroll_le_v", lambda c: c["unroll_v"] <= v,
                   vec=lambda c: c["unroll_v"] <= v),
    ]
    return SearchSpace(params, constraints, name="pnpoly_h100")


#: f32 instructions a point and edge of each ``between_method``
#: (``csrc/pnpoly.cu`` ``between``: two compares and their xor; two
#: differences, their product and four tests; two compares, two
#: conversions and integer subtract, abs and compare; min, max and two
#: compares and their and) and ``use_method`` (a predicate toggle, an
#: add, a multiply)
BETWEEN_INST = (3.0, 9.0, 7.0, 5.0)
USE_INST = (2.0, 1.0, 1.0)


def numpy_inputs(seed: int, n: int, v: int) -> dict:
    """An irregular star polygon and ``n`` points, drawn with numpy in f32
    as the JAX package's ``make_inputs`` draws them with ``jax.random``:
    sorted angles U(0, 2 pi), radii 0.4 + U(0, 0.6), points U(-1.2, 1.2)."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, v).astype(np.float32))
    rad = np.float32(0.4) + rng.uniform(0.0, 0.6, v).astype(np.float32)
    poly = np.stack([rad * np.cos(ang), rad * np.sin(ang)])
    pts = rng.uniform(-1.2, 1.2, (2, n)).astype(np.float32)
    return {"points": pts, "poly": poly.astype(np.float32)}


def laid_out(points: torch.Tensor, config: Config) -> torch.Tensor:
    """``points`` (2, N) as ``config["coord_layout"]`` stores them."""
    return points if config["coord_layout"] == "soa" \
        else points.t().contiguous()


class PnpolyProblem(KernelProblem):
    kernel_name = "pnpoly_h100"
    #: the reference's shape: 2 000 000 points against a 600-gon
    default_shape = {"n": 2_000_000, "v": 600}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use
    _aos: torch.Tensor | None = None

    def build_space(self) -> SearchSpace:
        return build_space(self.shape["n"], self.shape["v"])

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/pnpoly.cu``): for every point of
        every block (the ragged end computed too) and edge, the crossing
        (three rounded operations), its compare, the between test and the
        parity update (:data:`BETWEEN_INST`, :data:`USE_INST`); for every
        thread and edge, shared by its ``points_per_thread`` points, four
        constant loads and the next vertex's index (7), the slope (a
        broadcast shared load with ``precompute_slope``, else two
        differences, a select and a division with its reciprocal, 12 and
        a special-function result) and 3 of loop a chunk of ``unroll_v``;
        with ``precompute_slope`` the slopes' barrier a synchronised step;
        the points and flags cross HBM once."""
        n, v = self.shape["n"], self.shape["v"]
        bp, pre = c["block_points"], c["precompute_slope"]
        t = np.minimum(bp, kernel.MAX_THREADS)
        ppt = bp // t
        blocks = -(-n // bp)
        edges = blocks * t * float(v)          # thread-edges
        per_point = (4.0 + np.asarray(BETWEEN_INST)[c["between_method"]]
                     + np.asarray(USE_INST)[c["use_method"]])
        per_edge = 7.0 + np.where(pre == 1, 1.0, 12.0) + 3.0 / c["unroll_v"]
        return {"f32_inst": edges * (ppt * per_point + per_edge),
                "sfu_ops": np.where(pre == 1, blocks * float(v), edges),
                "smem_words": np.where(pre == 1, edges / 32.0, 0.0),
                "ilp": ppt, "steps": pre,
                "hbm_bytes": 12.0 * n, "smem_per_block": 4 * v * pre,
                "threads": t, "regs": 24 + 6 * ppt, "blocks": blocks}

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's); the points are (2, N)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(numpy_inputs(seed, dims["n"], dims["v"]),
                                 self.device if device is None else device,
                                 dtype=torch.float32)

    def run_reference(self, config: Config, inputs: dict):
        return ref.pnpoly_reference(inputs["points"], inputs["poly"])

    def run_kernel(self, config: Config, inputs: dict):
        return ops.pnpoly(laid_out(inputs["points"], config), inputs["poly"],
                          config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.pnpoly`` call at the problem's shape; the points are
        laid out for the config before timing starts."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        if config["coord_layout"] == "soa":
            pts = x["points"]
        else:
            if self._aos is None:
                self._aos = laid_out(x["points"], config)
            pts = self._aos
        poly = x["poly"]
        return lambda: ops.pnpoly(pts, poly, config)
