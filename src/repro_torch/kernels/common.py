"""Shared infrastructure for the port's tunable kernels.

Port of ``repro.kernels.common``.  Each kernel package provides:
  ``ref.py``    — a torch oracle doing the reference's math in f32,
  ``kernel.py`` — the hand-written CUDA kernel's launcher, parameterized by
                  a config from its space, and its plain PyTorch version,
  ``ops.py``    — the public wrapper: the kernel for CUDA tensors, the
                  plain version for CPU tensors, and a launch counter,
  ``space.py``  — the :class:`KernelProblem`: a Hopper search space, the
                  measured evaluator and the features the Hopper cost
                  model (``core/costmodel.py``) turns into seconds.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.costmodel import FeatureBatch, KernelFeatures
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


def admits(space: SearchSpace, config: Config) -> bool:
    """Whether ``space`` holds ``config``: each value in its parameter's
    menu and every constraint met."""
    return all(config[p.name] in p.values for p in space.params) \
        and space.satisfies(config)


def _distance(config: Config, default: Config) -> tuple[int, float]:
    """How far ``config`` is from ``default``: the parameters that differ,
    then, among those, how far apart their values are (log2 of the ratio
    of two positive numbers, else 1)."""
    n, spread = 0, 0.0
    for name, want in default.items():
        got = config[name]
        if got == want:
            continue
        n += 1
        numeric = all(isinstance(x, (int, float)) and not isinstance(x, bool)
                      and x > 0 for x in (got, want))
        spread += abs(math.log2(got / want)) if numeric else 1.0
    return n, spread


def fitting_config(space: SearchSpace, default: Config,
                   keep: Sequence[str] = ()) -> Config | None:
    """The config an op runs at the shape ``space`` was built for when its
    caller names none: ``default`` where the space admits it, else the
    admitted config nearest to it (fewest parameters changed, then the
    nearest values, then the space's order) among those that keep
    ``default``'s values of ``keep`` (the parameters that change the
    function's numerics or the operands' layout, not just its tiling).
    ``None`` where no such config fits."""
    if admits(space, default):
        return dict(default)
    same = [c for c in space.valid_configs()
            if all(c[k] == default[k] for k in keep)]
    if not same:
        return None
    return dict(min(same, key=lambda c: _distance(c, default)))


@functools.lru_cache(maxsize=1024)
def _fitting_at(build_space: Callable[..., SearchSpace], shape: tuple,
                default: tuple, keep: tuple) -> Config | None:
    try:
        space = build_space(**dict(shape))
    except ValueError:              # a parameter with no value at the shape
        return None
    return fitting_config(space, dict(default), keep)


def config_at(build_space: Callable[..., SearchSpace], shape: dict,
              default: Config, keep: Sequence[str] = ()) -> Config | None:
    """:func:`fitting_config` over ``build_space(**shape)``, or None where
    no config fits (a space with no value of some parameter at the shape
    included).  One cache serves every op, keyed by the space builder, the
    shape, the default and ``keep``, so that a call does not rebuild the
    space; treat the dict as read-only."""
    return _fitting_at(build_space, tuple(shape.items()),
                       tuple(default.items()), tuple(keep))


config_at.cache_info = _fitting_at.cache_info
config_at.cache_clear = _fitting_at.cache_clear


def resolve_config(op: str, build_space: Callable[..., SearchSpace],
                   shape: dict, default: Config, keep: Sequence[str],
                   device: torch.device) -> Config:
    """The config of a call that names none: :func:`config_at` at the
    call's shape.  Where no config of the kernel's space fits, the CPU runs
    ``default``, which the plain version takes with a ragged last tile (its
    tiling decides where a tile ends, not what it computes); any other
    device raises a ValueError that names the shape."""
    cfg = config_at(build_space, shape, default, keep)
    if cfg is not None:
        return dict(cfg)
    if device.type != "cpu":
        dims = ", ".join(f"{k}={v}" for k, v in shape.items())
        raise ValueError(f"{op}: no config of the kernel's space fits "
                         f"{dims}")
    return dict(default)


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


def bound_regs(threads):
    """The most registers a thread may have under a launch bound of
    ``threads`` a block, one block an SM: the 65 536 of an SM, allocated
    per warp in units of 256, at most 255 (works on numpy columns too)."""
    warps = -(-np.asarray(threads) // 32)
    return np.minimum(255, 65536 // (warps * 256) * 8)


def per_value(fn: Callable[..., float], *cols) -> np.ndarray:
    """``fn`` of each row's values of ``cols`` (scalars or equal-length
    columns), called once per distinct row: for a count that the kernel
    module computes with scalar code (a loop, a table), in a feature
    column."""
    arrays = [np.atleast_1d(np.asarray(c)) for c in cols]
    n = max(len(a) for a in arrays)
    rows = list(zip(*(np.broadcast_to(a, (n,)).tolist() for a in arrays)))
    done = {r: float(fn(*r)) for r in set(rows)}
    out = np.array([done[r] for r in rows], dtype=np.float64)
    return out if any(np.ndim(c) for c in cols) else out[0]


class KernelProblem(MeasuredProblem):
    """A tunable kernel bound to a concrete input shape and a device.

    Two evaluators: the measured one on the card, under the device's arch
    id (``device`` defaults to ``"cuda"`` and raises on a host with no
    card; pass ``device="cpu"`` to run the plain versions, as the tests
    do), and the Hopper cost model under the ids of
    ``core.costmodel.ARCH_NAMES``, host arithmetic on :meth:`feature_math`
    that needs no card (a model-only caller builds the problem with
    ``device="cpu"``).
    """

    #: subclasses set these
    default_shape: dict[str, int] = {}
    kernel_name: str = "kernel"
    #: the features do not depend on the arch id: SXM and PCIe share
    #: Hopper's per-SM limits, and the ids differ only in their rates
    arch_independent_features = True

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

    # -- the cost model's features ----------------------------------------- #
    def feature_math(self, c: dict) -> dict:
        """The kernel's :class:`FeatureBatch` columns at :attr:`shape` from
        a config's values ``c``: each a numpy scalar (one config) or a
        column (many).  One expression serves :meth:`features` and
        :meth:`feature_columns`, so both give the cost model the same
        floats."""
        raise NotImplementedError

    def features(self, config: Config, arch: str) -> KernelFeatures:
        f = self.feature_math({k: np.asarray(v) for k, v in config.items()})
        tile = tuple(int(f.pop(k, FeatureBatch.DEFAULTS[k]))
                     for k in ("tile_m", "tile_n", "tile_k"))
        return KernelFeatures(wgmma_tile=tile,
                              **{k: float(v) for k, v in f.items()})

    def feature_columns(self, cols: dict, arch: str) -> FeatureBatch:
        n = len(next(iter(cols.values())))
        return FeatureBatch.from_columns(n, **self.feature_math(cols))

    # -- correctness hooks ------------------------------------------------ #
    def make_inputs(self, seed: int = 0, small: bool = True,
                    device=None) -> dict:
        raise NotImplementedError

    def run_reference(self, config: Config, inputs: dict) -> Any:
        raise NotImplementedError

    def run_kernel(self, config: Config, inputs: dict) -> Any:
        raise NotImplementedError
