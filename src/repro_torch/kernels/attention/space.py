"""The ``flash_attention_h100`` problem: a Hopper search space and a measured
evaluator.

The space keeps the reference's parameters (``block_q``, ``block_kv``,
``block_h``, ``skip_masked``, ``acc_dtype``) with Hopper's ranges
(``csrc/flash_attention.cu``): a warp owns 16 query rows of one head, so a
block runs ``block_h * block_q / 16`` warps, at most 8; a kv tile is at
most 128 rows, so that S, the output accumulator and Q fit one thread's
registers without spills at d = 128.  Every block divides its dimension:
the kernel does not pad, since padded K rows would enter the softmax.  Its
constraints admit exactly the configs the compiled libraries can launch, so
a failed launch is a fault in the space or the kernel, never a silently
invalid trial.
"""

from __future__ import annotations

import numpy as np

from ...core.space import Config, Constraint, Param, SearchSpace
from ..common import SMEM_PER_BLOCK, KernelProblem, inputs_from_numpy
from . import kernel, ops, ref

#: the JAX package's small correctness shape (its ``make_inputs(small=True)``)
SMALL_SHAPE = {"hq": 4, "hkv": 2, "tq": 256, "tk": 256, "d": 64}


def build_space(hq: int, hkv: int, tq: int, tk: int,
                d: int) -> SearchSpace:
    """The ``flash_attention_h100`` space for one shape."""
    g = hq // hkv
    params = [
        Param("block_q", kernel.BLOCK_Q),
        Param("block_kv", kernel.BLOCK_KV),
        # the reference's menu trimmed to the GQA group, as it trims it
        Param("block_h", tuple(v for v in (1, 2, 4, 8)
                               if v <= g and g % v == 0)),
        Param("skip_masked", (0, 1)),
        Param("acc_dtype", ("f32", "bf16")),
    ]
    max_warps = max(kernel.WARPS)
    constraints = [
        # the reference's fits, tightened to what the kernel needs: every
        # block divides its dimension
        Constraint("fits_shape", lambda c: tq % c["block_q"] == 0
                   and tk % c["block_kv"] == 0,
                   vec=lambda c: (tq % c["block_q"] == 0)
                   & (tk % c["block_kv"] == 0)),
        Constraint("gqa_group", lambda c: g % c["block_h"] == 0,
                   vec=lambda c: g % c["block_h"] == 0),
        # a block of at most 8 warps of 16 rows each (one warp per 16 rows
        # of one head, its accumulator in registers)
        Constraint("warps", lambda c: kernel.warps(c["block_q"], c["block_h"])
                   <= max_warps,
                   vec=lambda c: kernel.warps(c["block_q"], c["block_h"])
                   <= max_warps),
        Constraint("smem", lambda c: kernel.smem_bytes(c["block_kv"], d)
                   <= SMEM_PER_BLOCK,
                   vec=lambda c: kernel.smem_bytes(c["block_kv"], d)
                   <= SMEM_PER_BLOCK),
        Constraint("registers", lambda c: kernel.frag_regs(c["block_kv"], d)
                   <= kernel.MAX_FRAG_REGS,
                   vec=lambda c: kernel.frag_regs(c["block_kv"], d)
                   <= kernel.MAX_FRAG_REGS),
    ]
    return SearchSpace(params, constraints, name="flash_attention_h100")


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
