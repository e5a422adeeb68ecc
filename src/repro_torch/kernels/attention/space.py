"""The ``flash_attention_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters (``block_q``, ``block_kv``,
``block_h``, ``skip_masked``, ``acc_dtype``) with Hopper's ranges
(``csrc/flash_attention.cu``).  A block stacks ``block_h`` heads of
``block_q`` rows into whole 64-row ``wgmma`` tiles, one consumer warpgroup
each, so ``block_h * block_q`` is 64 or 128; a kv tile is at most 128 rows, so that S, P and the output
accumulator fit one consumer thread's registers without spills at d = 128.
Every block divides its dimension: the kernel does not pad, since padded K
rows would enter the softmax.  Its constraints admit exactly the configs
the compiled libraries can launch, so a failed launch is a fault in the
space or the kernel, never a silently invalid trial.
:meth:`AttentionProblem.feature_math` gives the Hopper cost model the
kernel's counts.
"""

from __future__ import annotations

import numpy as np

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import (SMEM_PER_BLOCK, KernelProblem, bound_regs,
                      inputs_from_numpy, per_value)
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"hq": 4, "hkv": 2, "tq": 256, "tk": 256, "d": 64}


def build_space(hq: int, hkv: int, tq: int, tk: int,
                d: int) -> SearchSpace:
    """The ``flash_attention_h100`` space for one shape."""
    g = hq // hkv
    # the reference's menu trimmed to the GQA group, as it trims it; and
    # block_q trimmed to the values some block_h makes whole warpgroups of
    block_h = tuple(v for v in (1, 2, 4, 8) if v <= g and g % v == 0)
    params = [
        Param("block_q", tuple(q for q in kernel.BLOCK_Q
                               if any(q * h in kernel.ROWS
                                      for h in block_h))),
        Param("block_kv", kernel.BLOCK_KV),
        Param("block_h", block_h),
        Param("skip_masked", (0, 1)),
        Param("acc_dtype", ("f32", "bf16")),
    ]

    def whole(c):
        r = kernel.block_rows(c["block_q"], c["block_h"])
        return (r == kernel.ROWS[0]) | (r == kernel.ROWS[1])

    def smem_ok(c):
        return kernel.smem_bytes(c["block_q"], c["block_h"], c["block_kv"],
                                 d) <= SMEM_PER_BLOCK

    constraints = [
        # the reference's fits, tightened to what the kernel needs: every
        # block divides its dimension
        Constraint("fits_shape", lambda c: tq % c["block_q"] == 0
                   and tk % c["block_kv"] == 0,
                   vec=lambda c: (tq % c["block_q"] == 0)
                   & (tk % c["block_kv"] == 0)),
        Constraint("gqa_group", lambda c: g % c["block_h"] == 0,
                   vec=lambda c: g % c["block_h"] == 0),
        # a block is whole warpgroups: 64 or 128 stacked rows, one
        # consumer warpgroup per 64 (wgmma's M)
        Constraint("warpgroups", lambda c: bool(whole(c)), vec=whole),
        Constraint("smem", lambda c: bool(smem_ok(c)), vec=smem_ok),
        # S, P and O of a consumer thread within the register budget
        Constraint("registers", lambda c: kernel.frag_regs(c["block_kv"], d)
                   <= kernel.MAX_FRAG_REGS,
                   vec=lambda c: kernel.frag_regs(c["block_kv"], d)
                   <= kernel.MAX_FRAG_REGS),
    ]
    return SearchSpace(params, constraints, name="flash_attention_h100")


def kv_tiles(tq: int, tk: int, block_q: int, block_kv: int,
             skip_masked: int) -> int:
    """kv tiles one head's q tiles compute, summed: with ``skip_masked``
    a q tile stops at the tile holding its last row's last visible column
    (the causal mask aligned to the bottom right), else it takes all."""
    full = tk // block_kv
    if not skip_masked:
        return (tq // block_q) * full
    last = np.arange(1, tq // block_q + 1) * block_q + (tk - tq)
    return int(np.clip(-(-last // block_kv), 0, full).sum())


def numpy_inputs(seed: int, hq: int, hkv: int, tq: int, tk: int, d: int,
                 causal: bool = True) -> dict:
    """q, k and v drawn from N(0, 1) with numpy, as the JAX package's
    ``make_inputs`` draws them with ``jax.random``."""
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((hq, tq, d), np.float32),
            "k": rng.standard_normal((hkv, tk, d), np.float32),
            "v": rng.standard_normal((hkv, tk, d), np.float32),
            "causal": causal}


class AttentionProblem(KernelProblem):
    kernel_name = "flash_attention_h100"
    #: the reference's shape: one Llama-3-8B layer over a 4k context (32 q
    #: heads, 8 kv heads, head dim 128), causal
    default_shape = {"hq": 32, "hkv": 8, "tq": 4096, "tk": 4096, "d": 128}
    small_shape = SMALL_SHAPE
    _inputs: dict | None = None      # full-shape inputs, made at first use

    def build_space(self) -> SearchSpace:
        return build_space(*(self.shape[k]
                             for k in ("hq", "hkv", "tq", "tk", "d")))

    def feature_math(self, c: dict) -> dict:
        """The kernel's counts (``csrc/flash_attention.cu``, causal): the
        (row, column) pairs of every kv tile it computes, each 2 d FLOPs
        for S = Q K^T and 4 d for P V with P as bf16 hi + lo, in m64 x
        block_kv x k16 wgmmas; about 6 f32 instructions and an exponential
        a pair for the online softmax, the accumulator's rescale (d a row
        a tile) and with a bf16 accumulator its two conversions; Q's and
        K's smem words for S and V's for P V (P comes from registers); q,
        k, v and the output once from HBM, K and V again from L2 for every
        block after the first.  A block's registers are its launch
        bound's: the space keeps ``kernel.frag_regs`` within
        ``kernel.MAX_FRAG_REGS``, so none spill."""
        hq, hkv, tq, tk, d = (self.shape[k] for k in
                              ("hq", "hkv", "tq", "tk", "d"))
        bq, bkv, bh = c["block_q"], c["block_kv"], c["block_h"]
        tiles = per_value(lambda q, kv, sk: kv_tiles(tq, tk, q, kv, sk),
                          bq, bkv, c["skip_masked"])
        pairs = hq * tiles * bq * bkv
        rescale = pairs * d / bkv
        f32 = 6.0 * pairs + rescale + np.where(c["acc_dtype"] == "bf16",
                                                2.0 * rescale, 0.0)
        words = ((64 + bkv) * d / 2.0 + d * bkv) / (64.0 * bkv)
        threads = 128 * (kernel.warpgroups(bq, bh) + 1)
        return {"tc_flops": 6.0 * d * pairs, "tile_m": 64, "tile_n": bkv,
                "tile_k": 16, "f32_inst": f32, "sfu_ops": pairs,
                "smem_words": pairs * words,
                "hbm_bytes": 4.0 * d * (hq * tq + hkv * tk),
                "l2_bytes": 4.0 * d * (hq // bh) * tiles * bkv
                - 4.0 * d * hkv * tk,
                "smem_per_block": kernel.smem_bytes(bq, bh, bkv, d),
                "threads": threads, "regs": bound_regs(threads),
                "blocks": (hq // bh) * (tq // bq), "stages": kernel.STAGES}

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        """Inputs at the small correctness shape, or at :attr:`shape`, on
        ``device`` (default: the problem's)."""
        dims = SMALL_SHAPE if small else self.shape
        return inputs_from_numpy(
            numpy_inputs(seed, *(dims[k] for k in
                                 ("hq", "hkv", "tq", "tk", "d"))),
            self.device if device is None else device)

    def run_reference(self, config: Config, inputs: dict):
        return ref.mha_reference(inputs["q"], inputs["k"], inputs["v"],
                                 causal=inputs["causal"])

    def run_kernel(self, config: Config, inputs: dict):
        return ops.attention(inputs["q"], inputs["k"], inputs["v"],
                             causal=inputs["causal"], config=config)

    # -- measured evaluator ----------------------------------------------- #
    def make_runner(self, config: Config):
        """One ``ops.attention`` call at the problem's shape."""
        if self._inputs is None:
            self._inputs = self.make_inputs(seed=0, small=False)
        x = self._inputs
        q, k, v, causal = x["q"], x["k"], x["v"], x["causal"]
        return lambda: ops.attention(q, k, v, causal=causal, config=config)
