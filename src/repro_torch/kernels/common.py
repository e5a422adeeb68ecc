"""Shared infrastructure for the port's tunable kernels.

Port of ``repro.kernels.common``.  Each kernel package provides:
  ``ref.py``    — a torch oracle doing the reference's math in f32,
  ``kernel.py`` — the hand-written CUDA kernel's launcher, parameterized by
                  a config from its space, and its plain PyTorch version,
  ``ops.py``    — the public wrapper: the kernel for CUDA tensors, the
                  plain version for CPU tensors, and a launch counter,
  ``space.py``  — the :class:`KernelProblem`: a Hopper search space and the
                  measured evaluator.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core.problem import MeasuredProblem
from ..core.space import Config, SearchSpace
from ..device import resolve

#: shared memory one block may use on Hopper (227 KiB of the SM's 256 KiB,
#: above 48 KiB only as opted-in dynamic shared memory).  Takes the place
#: of the JAX package's TPU VMEM budget, ``PORTABLE_VMEM``.
SMEM_PER_BLOCK = 232_448


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def inputs_from_numpy(arrays: dict, device=None,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The port's inputs from numpy ones: floating arrays become ``dtype``
    tensors (default bf16) and integer arrays int32 tensors (a table of
    indices or delays stays integral), on ``device`` (default ``"cuda"``);
    other values pass through.  With it the tests feed both packages the
    same values."""
    dev = resolve(device)

    def tensor(v: np.ndarray) -> torch.Tensor:
        if np.issubdtype(v.dtype, np.integer):
            return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)) \
            .to(dev, dtype)

    return {k: tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


class KernelProblem(MeasuredProblem):
    """A tunable kernel bound to a concrete input shape and a device.

    ``device`` defaults to ``"cuda"`` and raises on a host with no card
    (pass ``device="cpu"`` to run the plain versions, as the tests do);
    trials are recorded under the device's arch id, as in
    :class:`MeasuredProblem`.
    """

    #: subclasses set these
    default_shape: dict[str, int] = {}
    kernel_name: str = "kernel"

    def __init__(self, shape: dict[str, int] | None = None, device=None,
                 repeats: int = 5, warmup: int = 2):
        dev = resolve(device)       # before the space: no card, no work
        self.shape = dict(self.default_shape)
        if shape:
            self.shape.update(shape)
        super().__init__(self.build_space(), self.make_runner,
                         name=self.kernel_name, repeats=repeats,
                         warmup=warmup, device=dev)

    def build_space(self) -> SearchSpace:
        raise NotImplementedError

    def make_runner(self, config: Config) -> Callable[[], Any]:
        """A zero-argument callable running ``config`` once at
        :attr:`shape` on :attr:`device` (what the evaluator times)."""
        raise NotImplementedError

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        raise NotImplementedError

    def run_reference(self, config: Config, inputs: dict) -> Any:
        raise NotImplementedError

    def run_kernel(self, config: Config, inputs: dict) -> Any:
        raise NotImplementedError
