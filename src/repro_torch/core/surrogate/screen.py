"""Surrogate screening: answer predicted-poor candidates from the model.

The second tuner seam (see ``tuners/base.py``): a screen ranks each fresh
candidate batch with a trained :class:`~.model.KernelSurrogate` and
replaces the predicted-poor slice with model-estimated trials.  Estimated
trials are real :class:`~repro_torch.core.problem.Trial` objects — journaled,
told, budget-consuming — but flagged with :data:`ESTIMATED_INFO` so every
downstream consumer (benchmarks counting *measured* evaluations, harvest's
leakage guard, resumed sessions) can tell them from measurements.

Decision rules are deterministic and batch-shape-stable:

* batches of two or more rank in-batch: the predicted-top
  ``ceil(measure_frac * n)`` are measured, the rest estimated;
* singleton batches (sequential tuners) measure when the prediction beats
  the space-wide ``measure_frac`` quantile threshold, and a consecutive-
  estimate cap (``max_defer``) forces a real measurement so a walk can
  never run on model fumes indefinitely.
"""

from __future__ import annotations

import math

import numpy as np

from ..problem import Trial
from ..space import SearchSpace
from .model import KernelSurrogate

#: provenance flag carried (and journaled) by every model-estimated trial
ESTIMATED_INFO = {"estimated": True, "provenance": "surrogate-screen"}

#: threshold-calibration sample cap for very large valid sets
_CALIBRATION_CAP = 65536


class SurrogateScreen:
    """Measurement screen over one (space, arch) pair."""

    def __init__(self, model: KernelSurrogate, space: SearchSpace,
                 arch: str, *, measure_frac: float = 0.25,
                 max_defer: int = 7):
        if not 0.0 < measure_frac <= 1.0:
            raise ValueError("measure_frac must be in (0, 1]")
        self.model = model
        self.space = space
        self.arch = arch
        self.measure_frac = float(measure_frac)
        self.max_defer = max(1, int(max_defer))
        self.n_measured = 0
        self.n_estimated = 0
        self._deferred = 0
        # singleton-batch threshold: the measure_frac quantile of the
        # model's predictions over the (capped) valid space — deterministic,
        # computed once
        comp = space.compile_eagerly()
        if comp is not None:
            cand = comp.valid_rows
            if len(cand) > _CALIBRATION_CAP:
                step = len(cand) // _CALIBRATION_CAP + 1
                cand = cand[::step]
        else:
            cand = np.asarray(
                sorted({space.flat_index(c)
                        for c in space.sample_distinct(4096, seed=0)}),
                dtype=np.int64)
        preds = model.predict_rows(space, cand, arch)
        self._tau = float(np.quantile(preds, self.measure_frac))

    def _estimate_trial(self, row: int, pred: float) -> Trial:
        return Trial(None, float(pred), self.arch, valid=True,
                     info=dict(ESTIMATED_INFO), row=int(row),
                     space=self.space)

    def screen_rows(self, rows, arch: str | None = None
                    ) -> list[Trial | None]:
        """Decide each candidate: ``None`` == measure it, a Trial == the
        model's answer.  ``arch`` must match the screen's (it rides along
        so callers can assert the pairing)."""
        arch = self.arch if arch is None else arch
        if arch != self.arch:
            raise ValueError(f"screen calibrated for {self.arch!r}, "
                             f"asked to screen {arch!r}")
        rows = [int(r) for r in rows]
        if not rows:
            return []
        preds = self.model.predict_rows(self.space, rows, self.arch)
        out: list[Trial | None] = [None] * len(rows)
        if len(rows) == 1:
            pred = float(preds[0])
            if pred <= self._tau or self._deferred >= self.max_defer:
                self._deferred = 0
                self.n_measured += 1
            else:
                self._deferred += 1
                self.n_estimated += 1
                out[0] = self._estimate_trial(rows[0], pred)
            return out
        n_measure = math.ceil(self.measure_frac * len(rows))
        order = np.argsort(preds, kind="stable")
        for rank, i in enumerate(order):
            if rank < n_measure:
                self.n_measured += 1
            else:
                self.n_estimated += 1
                out[i] = self._estimate_trial(rows[i], float(preds[i]))
        self._deferred = 0
        return out
