"""The ``dedisp_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters and their meanings
(``csrc/dedisp.cu``), with Hopper's ranges:

* ``block_d`` (8 to 128): DMs per block.  The reference's 256 and 512
  cannot be admitted here (below).
* ``block_c`` (1 to 64): channels per step.  The kernel stages each
  channel's window of x in a slot of a ring in shared memory, the slot
  sized by the shape: a pass of samples plus T - t_out, the widest span of
  delays any table can have.  The ring has as many steps as fit (2 to 8).
  At the reference's shape a slot is 34 to 41 KB, so only ``block_c`` 1
  and 2 leave room for two steps; the menu keeps the values that some
  config fits at the shape.
* ``time_chunk`` (0 for the whole of t_out, else 256 up to t_out): output
  samples per block, walked in passes of (threads along time) x (samples
  a thread).
* ``unroll_d`` (1, 2, 4, 8): DMs a thread accumulates in registers, and
  over which it reads a window once per distinct delay; it divides
  ``block_d``.  A block has block_d / unroll_d rows of threads, a row along
  time whole warps and the block at most 512 threads, so at most 16 rows;
  a thread holds at most 64 accumulators (unroll_d x its samples, at most
  16 samples), so no compiled tile spills.
* ``acc_dtype`` (f32, bf16), as the reference.

The shared-memory constraint (a ring of two steps of slots beside each
channel's delay bounds in 232 448 B, ``kernel.stages``) replaces the
reference's VMEM budget.  Blocks mask the ragged
ends.  The constraints admit exactly the configs the compiled library
launches.  :meth:`DedispProblem.feature_math` gives the Hopper cost model
the kernel's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import KernelProblem, inputs_from_numpy, per_value
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


def build_space(d: int, t_out: int, t_in: int | None = None,
                c: int | None = None) -> SearchSpace:
    """The ``dedisp_h100`` space for ``d`` DMs and ``t_out`` samples out of
    ``t_in`` (default t_out + 8192, the reference's) in ``c`` channels
    (default the reference's 1536)."""
    t_in = t_out + MAX_DELAY if t_in is None else t_in
    c = DedispProblem.default_shape["c"] if c is None else c
    rows = kernel.MAX_THREADS // kernel.MIN_ROW

    def fits(bd, bc, tc, ud):
        return bd % ud == 0 and bd // ud <= rows and kernel.config_stages(
            {"block_d": bd, "block_c": bc, "time_chunk": tc, "unroll_d": ud},
            c, t_out, t_in) >= 2

    # the menus trimmed to the shape: a block of more DMs than there are,
    # a chunk longer than t_out (0 already means all of it), or a step of
    # more channels than any block's ring holds is a dead row, as the
    # reference trims its time_chunk menu
    block_d = tuple(v for v in kernel.BLOCK_D if v <= d) or kernel.BLOCK_D[:1]
    time_chunk = tuple(v for v in kernel.TIME_CHUNK if v <= t_out)
    block_c = tuple(bc for bc in kernel.BLOCK_C
                    if any(fits(bd, bc, tc, ud) for bd in block_d
                           for tc in time_chunk for ud in kernel.UNROLL_D))
    params = [
        Param("block_d", block_d),
        Param("block_c", block_c),
        Param("time_chunk", time_chunk),
        Param("unroll_d", kernel.UNROLL_D),
        Param("acc_dtype", ("f32", "bf16")),
    ]

    def smem_ok(cfg):
        return kernel.config_stages(cfg, c, t_out, t_in) >= 2

    def smem_vec(cols):
        return np.array([smem_ok({k: cols[k][i] for k in (
            "block_d", "block_c", "time_chunk", "unroll_d")})
            for i in range(len(cols["block_d"]))], dtype=bool)

    constraints = [
        Constraint("unroll_divides",
                   lambda c: c["block_d"] % c["unroll_d"] == 0,
                   vec=lambda c: c["block_d"] % c["unroll_d"] == 0),
        Constraint("rows", lambda c: c["block_d"] // c["unroll_d"] <= rows,
                   vec=lambda c: c["block_d"] // c["unroll_d"] <= rows),
        Constraint("smem", smem_ok, vec=smem_vec),
    ]
    return SearchSpace(params, constraints, name="dedisp_h100")


#: two shapes (C, D, t_out, T, DM step) at which, together, every compiled
#: (unroll_d, samples a thread) runs: a long t_out for 16 samples a thread
#: at unroll_d 2, a t_out of 48 for one sample at unroll_d 1
TILE_SHAPES = ((24, 128, 2048, 2560, 0.5), (24, 64, 48, 300, 0.5))


def tile_configs(c: int, d: int, t_out: int, t_in: int) -> dict:
    """For each compiled (unroll_d, samples a thread) that an admitted
    config runs at this shape, the first such config in the space's order
    (block_c its largest where the ring holds it)."""
    space = build_space(d, t_out, t_in, c)
    out: dict = {}
    for cfg in sorted(space.valid_configs(),
                      key=lambda k: -k["block_c"]):
        nx, _, st = kernel.layout(cfg["block_d"], cfg["unroll_d"],
                                  cfg["time_chunk"] or t_out)
        out.setdefault((cfg["unroll_d"], st), cfg)
    return out


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

    def __init__(self, *args, **kwargs):
        self._table: np.ndarray | None = None
        self._reads: dict[int, float] = {}
        super().__init__(*args, **kwargs)

    def build_space(self) -> SearchSpace:
        c, d, t_out, t_in, _ = dims(self.shape)
        return build_space(d, t_out, t_in, c)

    def _delays(self) -> np.ndarray:
        """The shape's delay table, as :func:`numpy_inputs` clips it."""
        if self._table is None:
            c, d, t_out, t_in, dm_step = dims(self.shape)
            self._table = np.minimum(ref.make_delays(c, d, dm_step=dm_step),
                                     t_in - t_out)
        return self._table

    def _reads_per_add(self, unroll_d: int) -> float:
        """:func:`kernel.reads_per_add` on the shape's delay table."""
        if unroll_d not in self._reads:
            self._reads[unroll_d] = kernel.reads_per_add(self._delays(),
                                                         unroll_d)
        return self._reads[unroll_d]

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/dedisp.cu``): every channel's add
        into every (DM, sample) of every pass of every block (``layout``),
        each an f32 add (3 more in bf16, rounding every sum) and the
        window words :func:`kernel.reads_per_add` says it reads on the
        shape's delay table; every block stages, pass by pass, each
        channel into a slot of its ring of ``config_stages`` steps, its
        thread 0 issuing each step's copies and every warp waiting on each
        step's mbarrier, so the copies do not overlap the adds
        (serialization 1), and each step is a synchronised step (passes x
        ceil(C / block_c) a block).  A step's L2 traffic is counted as its
        whole slots (``slot_floats``: the pass and T - t_out samples), not
        the narrower window of this table's delays that the kernel copies:
        a choice fitted to the card's rows, which the model ranks better
        counted so (PERF.md, the cost model's findings).  x, the delays and the output cross HBM
        once."""
        ch, d, t_out, t_in, _ = dims(self.shape)
        bd, bc, ud = c["block_d"], c["block_c"], c["unroll_d"]
        tc = np.where(c["time_chunk"] == 0, t_out, c["time_chunk"])

        def shape_of(bd_, ud_, tc_):
            nx, rows, st = kernel.layout(bd_, ud_, tc_)
            return nx, rows, st, kernel.slot_floats(nx, st, t_in - t_out)

        nx, rows, st, slot = (per_value(lambda *a, i=i: shape_of(*a)[i],
                                        bd, ud, tc) for i in range(4))
        stages = per_value(lambda *a: kernel.config_stages(
            dict(zip(("block_d", "block_c", "time_chunk", "unroll_d"), a)),
            ch, t_out, t_in), bd, bc, c["time_chunk"], ud)
        blocks = (-(-d // bd)) * (-(-t_out // tc))
        passes = -(-tc // (nx * st))
        adds = blocks * bd * passes * nx * st * float(ch)
        reads = per_value(self._reads_per_add, ud)
        return {"f32_inst": adds * (1.0 + reads + np.where(
                    c["acc_dtype"] == "bf16", 3.0, 0.0)),
                "smem_words": adds * reads, "ilp": ud * st,
                "steps": passes * -(-ch // bc),
                "hbm_bytes": 4.0 * (ch * t_in + ch * d + d * t_out),
                "l2_bytes": 4.0 * (blocks * passes * ch * slot - ch * t_in),
                "smem_per_block": stages * kernel.stage_bytes(bd, bc, slot)
                + kernel.win_bytes(ch),
                "threads": nx * rows, "regs": 32 + ud * st,
                "blocks": blocks, "stages": stages, "serialization": 1.0}

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
