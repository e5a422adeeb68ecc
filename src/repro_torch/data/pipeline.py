"""Deterministic, resumable, shardable synthetic token pipeline.

The port of ``repro.data.pipeline``, a copy (it is pure numpy): the same
``(seed, step, row)`` gives the same bytes in both packages.  ``batch_at``
returns numpy arrays; the train loop moves them to its device.

Design goals (the fault-tolerance contract):

* **Stateless addressing** — ``batch_at(step)`` is a pure function of
  ``(seed, step)`` built on counter-based Philox streams.  Restarting from a
  checkpoint needs only the step index; no iterator state, no file offsets.
* **Host sharding** — each host materializes only its slice of the global
  batch (``host_id``/``n_hosts``), so the pipeline scales to any process
  count and is *elastic*: a restart on a different host grid re-slices the
  same deterministic global batch.
* **Learnable structure** — tokens are drawn from a fixed order-1 Markov
  chain (plus a copy-span task), so a ~100M model trained for a few hundred
  steps shows a clearly decreasing loss.  Uniform
  noise would hide optimizer bugs behind a flat loss.

The "labels" are next-token targets (shift-by-one, final position masked with
-100-style ``-1``), matching Model.train_loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    #: Markov-chain branching factor: each token has this many plausible
    #: successors (smaller => lower entropy => faster visible learning).
    branching: int = 16
    #: fraction of each sequence occupied by a copy-span (position-robust
    #: second task; exercises long-range attention)
    copy_frac: float = 0.25


class SyntheticPipeline:
    """Deterministic batches: ``pipeline[step] -> {"tokens", "labels"}``."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"{n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # Fixed Markov structure: successor table derived from the seed only
        # (identical on every host, never stored in checkpoints).
        rng = np.random.Generator(np.random.Philox(key=cfg.seed))
        v, b = cfg.vocab, cfg.branching
        self._succ = rng.integers(0, v, size=(v, b), dtype=np.int64)
        logits = rng.standard_normal((v, b))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        self._succ_p = e / e.sum(axis=1, keepdims=True)
        self._succ_cdf = np.cumsum(self._succ_p, axis=1)

    # ------------------------------------------------------------------ #
    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        """Counter-based stream: (seed, step, global_row) -> Philox."""
        return np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[0, 0, step, row]))

    def _sequence(self, step: int, global_row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng_for(step, global_row)
        t = cfg.seq_len
        u = rng.random(t)                      # one uniform per position
        toks = np.empty(t, dtype=np.int64)
        toks[0] = rng.integers(0, cfg.vocab)
        # vectorized Markov walk is inherently sequential; keep the python
        # loop but on numpy scalars (fast enough: ~1e6 tok/s/host)
        cdf, succ = self._succ_cdf, self._succ
        cur = int(toks[0])
        for i in range(1, t):
            j = int(np.searchsorted(cdf[cur], u[i], side="right"))
            cur = int(succ[cur, min(j, succ.shape[1] - 1)])
            toks[i] = cur
        # copy-span: repeat an earlier window verbatim in the second half
        span = int(t * cfg.copy_frac)
        if span >= 4 and t >= 4 * span:
            src = int(rng.integers(0, t // 2 - span))
            dst = int(rng.integers(t // 2, t - span))
            toks[dst:dst + span] = toks[src:src + span]
        return toks

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local slice of global batch ``step``."""
        cfg = self.cfg
        rows = range(self.host_id * self.local_batch,
                     (self.host_id + 1) * self.local_batch)
        toks = np.stack([self._sequence(step, r) for r in rows])
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int64)], axis=1)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __getitem__(self, step: int) -> dict[str, np.ndarray]:
        return self.batch_at(step)

    # ------------------------------------------------------------------ #
    def entropy_floor(self) -> float:
        """Per-token cross-entropy floor of the Markov source in nats —
        the asymptote a correct training run approaches."""
        p = self._succ_p
        h_rows = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        return float(h_rows.mean())


def make_pipeline(cfg: DataConfig, host_id: int = 0,
                  n_hosts: int = 1) -> SyntheticPipeline:
    return SyntheticPipeline(cfg, host_id, n_hosts)
