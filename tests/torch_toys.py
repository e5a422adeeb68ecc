"""Toy problems the port's orchestrator tests send to spawned worker
processes.  They live in a module of their own, which imports nothing but
``repro_torch``, so that a spawned child unpickling one imports neither
JAX nor a test module's fixtures."""

from __future__ import annotations

import os

from repro_torch.core.problem import MeasuredProblem, Trial, TunableProblem
from repro_torch.core.space import Param, SearchSpace


def toy_space(name: str) -> SearchSpace:
    return SearchSpace([Param("a", (0, 1, 2, 3))], name=name)


class WorkerKiller(TunableProblem):
    """Config ``a == 1`` kills its worker process (a simulated segfault)."""

    name = "killer"

    def __init__(self):
        super().__init__(toy_space("k"))

    def evaluate(self, config, arch=None):
        if config["a"] == 1:
            os._exit(13)
        return Trial(config, float(config["a"] + 1), arch)


class DeviceAssert(MeasuredProblem):
    """A measured toy: config ``a == 1`` indexes a CUDA tensor out of range,
    a device-side assert that leaves the process's CUDA context unusable."""

    def __init__(self, device=None):
        super().__init__(toy_space("device_assert"), self.runner,
                         name="device_assert", repeats=3, warmup=1,
                         device=device)

    def runner(self, config):
        import torch
        x = torch.arange(64, dtype=torch.float32, device=self.device)
        i = torch.tensor([10_000 if config["a"] == 1 else config["a"]],
                         device=self.device)
        return lambda: x[i].sum()
