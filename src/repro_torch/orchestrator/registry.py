"""Problem registry: name -> TunableProblem factory, resolved lazily.

Sessions are pure data, so the orchestrator needs to turn a problem *name*
back into a live :class:`TunableProblem`.  Kernel problems import torch
and their kernel packages, so factories are referenced by dotted path and
imported only on use — ``repro_torch.orchestrator`` stays importable (CLI
``status``, tests) without pulling in the whole kernel stack.

The eight kernel problems carry the names of the port's benchmark registry
(``repro_torch.kernels.BENCHMARKS``).  Their factories take the problem's
keyword arguments: ``device`` (default ``"cuda"``, which raises on a host
with no card; ``"cpu"`` runs the plain versions or, under a cost-model arch
id, the model), ``shape``, ``repeats`` and ``warmup``.

Two toy problems (``toy_quad``, ``toy_rastrigin``) are registered for
smoke tests and CLI demos; they need nothing beyond the core.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable

from ..core.problem import FunctionProblem, TunableProblem
from ..core.space import Param, SearchSpace

#: problem name -> "module:attr" of a zero-arg (or kwargs) factory
PROBLEM_PATHS: dict[str, str] = {
    "gemm_h100": "repro_torch.kernels.matmul.space:GemmProblem",
    "nbody_h100": "repro_torch.kernels.nbody.space:NbodyProblem",
    "pnpoly_h100": "repro_torch.kernels.pnpoly.space:PnpolyProblem",
    "conv2d_h100": "repro_torch.kernels.conv2d.space:Conv2dProblem",
    "hotspot_h100": "repro_torch.kernels.hotspot.space:HotspotProblem",
    "dedisp_h100": "repro_torch.kernels.dedisp.space:DedispProblem",
    "expdist_h100": "repro_torch.kernels.expdist.space:ExpdistProblem",
    "flash_attention_h100":
        "repro_torch.kernels.attention.space:AttentionProblem",
}


def _toy_quad(n_params: int = 4, k: int = 8) -> TunableProblem:
    space = SearchSpace([Param(f"p{i}", tuple(range(k)))
                         for i in range(n_params)], name="toy_quad")

    def fn(cfg, arch):
        return 1.0 + sum((cfg[f"p{i}"] - 2) ** 2 for i in range(n_params))

    return FunctionProblem(space, fn, name="toy_quad")


def _toy_rastrigin(n_params: int = 4, k: int = 10) -> TunableProblem:
    space = SearchSpace([Param(f"p{i}", tuple(range(k)))
                         for i in range(n_params)], name="toy_rastrigin")

    def fn(cfg, arch):
        tot = 0.0
        for i in range(n_params):
            x = (cfg[f"p{i}"] - 3) * 0.7
            tot += x * x - 3.0 * math.cos(2 * math.pi * x) + 3.0
        return 1.0 + tot

    return FunctionProblem(space, fn, name="toy_rastrigin")


TOY_FACTORIES: dict[str, Callable[..., TunableProblem]] = {
    "toy_quad": _toy_quad,
    "toy_rastrigin": _toy_rastrigin,
}


def problem_names() -> list[str]:
    return sorted([*PROBLEM_PATHS, *TOY_FACTORIES])


def make_problem(name: str, **kwargs) -> TunableProblem:
    """Instantiate a registered problem by name (lazy import).  A toy runs
    nowhere, so it ignores a ``device`` (the CLI's ``--device``, given to
    every problem of a campaign)."""
    if name in TOY_FACTORIES:
        kwargs.pop("device", None)
        return TOY_FACTORIES[name](**kwargs)
    if name not in PROBLEM_PATHS:
        raise KeyError(f"unknown problem {name!r}; "
                       f"registered: {', '.join(problem_names())}")
    mod_name, attr = PROBLEM_PATHS[name].split(":")
    factory = getattr(importlib.import_module(mod_name), attr)
    return factory(**kwargs)


def host_problem(name: str, **kwargs) -> TunableProblem:
    """:func:`make_problem` with a kernel problem built on the CPU, whatever
    ``kwargs`` say of its device: its shape and space are the card's, and
    building it needs no card and measures nothing.  For callers that read
    a problem's space or shape, or ask the cost model's ids (``lint
    --spaces``, the servedb builder and lookup, the surrogate's harvests
    and warm starts)."""
    if name in PROBLEM_PATHS:
        kwargs = dict(kwargs, device="cpu")
    return make_problem(name, **kwargs)
