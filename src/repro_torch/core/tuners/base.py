"""Tuner interface: every optimizer in the suite implements ``ask``/``tell``.

The runner drives the loop, enforces the evaluation budget, deduplicates
configs (cached objective lookups are free — matching how BAT replays
recorded search spaces), and records the full trace for convergence analysis.

Index-native protocol
---------------------
Every tuner also speaks a *row* protocol over the compiled space
(:class:`~repro_torch.core.spacetable.CompiledSpace`): :meth:`Tuner.ask_rows`
proposes flat row indices and :meth:`Tuner.tell_rows` receives
``(rows, objectives)`` arrays — no per-config dicts anywhere in the loop.
When the space compiles (``compile_eagerly``), a tuner that implements the
row methods becomes :attr:`Tuner.index_native` and the dict methods
(``ask``/``tell``/``ask_batch``/``tell_batch``) turn into thin
decode/encode bridges, so every existing caller keeps working.  When the
space does not compile, the legacy scalar implementations
(:meth:`ask_scalar`/:meth:`tell_scalar`) run instead — they stay in the
tree both as the fallback and as the bit-exactness oracle: an index-native
trajectory must equal the scalar trajectory for the same seed, draw for
draw (property-tested in ``tests/test_tuners.py``).

The rng-stream contract
-----------------------
A tuner owns exactly one rng (``self.rng``, seeded from the spec) and the
resume/replay machinery of the orchestrator reconstructs its state by
re-asking through the tuner.  For that to be exact, every implementation
must satisfy:

1. **Draws happen only inside ask/tell** (``ask``/``ask_rows``/``tell``/
   ``tell_rows``/``__init__``), never lazily from properties or repr.
2. **The draw sequence is a pure function of the told history and the
   proposal index.**  No draws may depend on wall-clock, worker count,
   completion order, or cache-hit patterns in the runner.
3. **Batch regrouping must concatenate, not reshape, the stream**: the
   draws of ``ask_rows(n)`` must be the concatenation of the draws the
   proposals would consume one at a time, so a budget-truncated final
   batch (the runner asks ``min(width, remaining)``) consumes a prefix.
   Concretely: draw per proposed config, in proposal order — never draw
   "n" of anything up front as a function of ``n``.  SurrogateBO's batched
   qLCB acquisition draws its per-slot kappa jitter one slot at a time for
   exactly this reason.
4. **Construction draws are part of the stream** (GridSearch's shuffle):
   they happen in ``__init__`` deterministically, before any ask.

The index-native paths replicate the scalar draw sequences exactly:
``rng.choice(seq)`` and ``rng.randrange(len(seq))`` consume the same
``_randbelow`` call, ``rng.sample(pop, k)`` depends only on ``len(pop)``,
and ``rng.shuffle`` only on the list length — so row-arithmetic rewrites
of value-choice/rejection loops are draw-for-draw identical.

Surrogate seams (warm start + screening)
----------------------------------------
Two optional seams let a trained cross-session surrogate
(``repro_torch.core.surrogate``) steer any tuner without per-tuner code:

* **Warm start** (:meth:`Tuner.set_warm_start`): a queue of predicted-top
  rows proposed *before* the subclass's own ask stream.  While the queue
  drains, :meth:`propose_rows`/:meth:`ask`/:meth:`ask_batch` serve warm
  rows and the subclass ask methods are never called — zero rng draws —
  then tells flow through ``tell_rows`` as usual, so population tuners
  absorb the warm rows as their initial generation.  When the last warm
  row has been told, :meth:`_adopt_warm_best` hands the measured-best warm
  row to sequential walkers (annealing, local search) as their walk state.
  With no warm start installed every entry point is a pass-through, so
  cold runs stay bit-identical to a tuner without the seam.
* **Screening** (``screen=`` on :func:`run_tuner` /
  ``run_session``): a screen ranks each fresh batch with the surrogate and
  answers the predicted-poor slice with model-estimated trials instead of
  measurements; estimated trials carry ``info={"estimated": True,
  "provenance": "surrogate-screen"}`` and are journaled like any other
  trial, so resumed sessions replay them estimate-for-estimate.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Sequence

from ...telemetry.trace import span
from ..problem import DEFAULT_ARCH, Trial, TunableProblem
from ..space import Config, SearchSpace


@dataclass
class TuneResult:
    """Full trace of one tuner run on one problem/arch."""

    tuner: str
    problem: str
    arch: str
    seed: int
    trials: list[Trial] = field(default_factory=list)

    @property
    def best(self) -> Trial:
        ok = [t for t in self.trials if t.ok]
        if not ok:
            return Trial({}, math.inf, self.arch, valid=False)
        return min(ok, key=lambda t: t.objective)

    def best_curve(self) -> list[float]:
        """Best-so-far objective after each evaluation (convergence curve)."""
        out, best = [], math.inf
        for t in self.trials:
            if t.ok:
                best = min(best, t.objective)
            out.append(best)
        return out

    @property
    def evaluations(self) -> int:
        return len(self.trials)


def _objective_of(trial: Trial) -> float:
    """The row-protocol encoding of a trial outcome: seconds, ``inf`` for
    anything that did not produce a usable measurement."""
    return trial.objective if trial.ok else math.inf


def sample_positions(rng: random.Random, n: int, k: int) -> list[int]:
    """Draw-for-draw reimplementation of ``rng.sample(range(n), k)``.

    ``random.Random.sample`` spends most of its time on isinstance/ABC
    ceremony; the index-native tuners call it per bred child, so this strips
    it to the two draw algorithms CPython actually runs (pool shuffle for
    ``n <= setsize``, rejection set otherwise) with the identical
    ``_randbelow`` call sequence.  Property-tested against the real
    ``sample`` in ``tests/test_tuners.py`` — if a future CPython changes the
    algorithm, that test (and every trajectory-equivalence test) fails
    loudly rather than silently diverging.
    """
    if not 0 <= k <= n:
        raise ValueError("sample larger than population or is negative")
    randbelow = rng._randbelow
    setsize = 21
    if k > 5:
        setsize += 4 ** math.ceil(math.log(k * 3, 4))
    if n <= setsize:
        pool = list(range(n))
        result = [0] * k
        for i in range(k):
            j = randbelow(n - i)
            result[i] = pool[j]
            pool[j] = pool[n - i - 1]
        return result
    if k == 0:
        return []
    if k <= 3:
        # set-free unrolling of the rejection algorithm (identical draws:
        # membership in {j1, j2} == the or-chain) — tournament/donor
        # selection calls this per bred child
        j1 = randbelow(n)
        if k == 1:
            return [j1]
        j2 = randbelow(n)
        while j2 == j1:
            j2 = randbelow(n)
        if k == 2:
            return [j1, j2]
        j3 = randbelow(n)
        while j3 == j1 or j3 == j2:
            j3 = randbelow(n)
        return [j1, j2, j3]
    selected: set[int] = set()
    selected_add = selected.add
    result = [0] * k
    for i in range(k):
        j = randbelow(n)
        while j in selected:
            j = randbelow(n)
        selected_add(j)
        result[i] = j
    return result


class Tuner:
    """Base optimizer.  Subclasses implement either the scalar pair
    (:meth:`ask_scalar` / :meth:`tell_scalar`) or, preferably, both it and
    the index-native pair (:meth:`ask_rows` / :meth:`tell_rows`).

    The batched protocol (:meth:`ask_batch` / :meth:`tell_batch`) is what the
    orchestrator's worker pool drives: ask a batch, evaluate it in parallel,
    tell the results back *in ask order*.  :attr:`max_parallel_asks` declares
    how many configs a tuner can safely propose before seeing any result —
    1 for strictly sequential tuners (local search, annealing, BO), the
    population size for generational tuners, ``None`` (unbounded) when asks
    are independent of tells (random, grid).
    """

    name: str = "tuner"
    #: max configs safely asked before a tell; ``None`` == unbounded.
    max_parallel_asks: int | None = 1

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self.rng = random.Random(seed)
        self.seed = seed
        # compile once (no-op above the policy limit): every ask/tell then
        # hits the O(1) valid-mask paths for sample/satisfies/neighbors.
        # Compiled draws are bit-identical to the legacy rejection draws, so
        # trajectories do not depend on whether compilation happened.  Tests
        # force the scalar oracle by clearing ``_comp`` after construction.
        self._comp = space.compile_eagerly()
        # warm-start state (inert until set_warm_start): queued rows still
        # to propose, told-count bookkeeping, and the measured-best warm row
        self._warm_queue: list[int] = []
        self._warm_pending = 0
        self._warm_active = False
        self._warm_adopted = False
        self._warm_best_obj = math.inf
        self._warm_best_row: int | None = None

    # -- warm-start seam --------------------------------------------------- #
    def set_warm_start(self, rows: Sequence[int] | None) -> None:
        """Install predicted-top ``rows`` (flat indices) to propose before
        the subclass's own ask stream.  ``None``/empty is a no-op: the run
        stays draw-for-draw identical to a tuner that never saw this call.
        Rows are deduplicated (order-preserving) and invalid rows dropped —
        a stale model trained on another space revision must not inject
        constraint-violating configs."""
        queue: list[int] = []
        seen: set[int] = set()
        for r in rows or ():
            r = int(r)
            if r in seen:
                continue
            seen.add(r)
            if self._comp is not None:
                if not (0 <= r < self._comp.n_total
                        and bool(self._comp.mask[r])):
                    continue
            elif not (0 <= r < self.space.cardinality
                      and self.space.satisfies(self.space.from_flat_index(r))):
                continue
            queue.append(r)
        self._warm_queue = queue
        self._warm_active = bool(queue)
        self._warm_adopted = not queue

    @property
    def warm_started(self) -> bool:
        """True when a (non-empty) warm start was installed."""
        return self._warm_active

    def _warm_take(self, n: int) -> list[int]:
        take = self._warm_queue[:n]
        del self._warm_queue[:len(take)]
        self._warm_pending += len(take)
        return take

    def _warm_account(self, row: int, obj: float) -> None:
        self._warm_pending -= 1
        if math.isfinite(obj) and obj < self._warm_best_obj:
            self._warm_best_obj, self._warm_best_row = obj, int(row)

    def _warm_maybe_adopt(self) -> None:
        if (self._warm_active and not self._warm_adopted
                and not self._warm_queue and self._warm_pending <= 0):
            self._warm_adopted = True
            if self._warm_best_row is not None:
                self._adopt_warm_best(self._warm_best_row,
                                      self._warm_best_obj)

    def _adopt_warm_best(self, row: int, obj: float) -> None:
        """Called once, after every warm row has been told, with the
        measured-best warm row.  Population tuners ignore it (the warm rows
        already seeded their population through ``tell``); sequential
        walkers override it to start the walk there."""

    def _absorb_warm_rows(self, rows: Sequence[int],
                          objectives: Sequence[float]) -> None:
        """How warm tells reach the subclass.  Default: straight through
        ``tell_rows`` — population tuners absorb warm rows as their seeding
        generation.  A tuner whose tell bookkeeping is keyed to its *own*
        asks (PSO's particle queue) overrides this to absorb the results
        without consuming that bookkeeping."""
        self.tell_rows(rows, objectives)

    def _absorb_warm_scalar(self, trial: Trial) -> None:
        """Scalar-path twin of :meth:`_absorb_warm_rows`."""
        self.tell_scalar(trial)

    def propose_rows(self, n: int) -> list[int]:
        """Warm-start-aware row entry point — what runners call.  Serves
        queued warm rows first (no subclass ask, no rng draws), then
        delegates to :meth:`ask_rows`.  A warm batch never mixes with
        subclass proposals, so tell accounting stays positional."""
        if self._warm_queue:
            return self._warm_take(max(1, n))
        return self.ask_rows(n)

    def report_rows(self, rows: Sequence[int],
                    objectives: Sequence[float]) -> None:
        """Warm-start-aware tell entry point (pairs with
        :meth:`propose_rows`).  Forwards everything to :meth:`tell_rows`
        (so populations absorb warm rows), tracking the measured-best warm
        row for :meth:`_adopt_warm_best`."""
        if self._warm_pending > 0:
            # warm batches never mix with subclass proposals, so a batch
            # with warm tells pending is entirely warm
            for r, o in zip(rows[:self._warm_pending], objectives):
                self._warm_account(int(r), float(o))
            self._absorb_warm_rows(rows, objectives)
            self._warm_maybe_adopt()
            return
        self.tell_rows(rows, objectives)

    # -- index-native dispatch -------------------------------------------- #
    @property
    def index_native(self) -> bool:
        """True when this tuner runs on compiled-space rows: the space
        compiled and the subclass implements the row protocol."""
        return (self._comp is not None
                and type(self).ask_rows is not Tuner.ask_rows)

    def ask_rows(self, n: int) -> list[int]:
        """Propose up to ``n`` flat row indices (valid rows only).  Only
        called when :attr:`index_native`; must consume the same rng draws as
        ``n`` scalar asks (see the rng-stream contract above).

        A tuner whose exhaustion flips mid-batch may legally return fewer
        rows than asked — including none at all.  Callers must treat an
        empty batch exactly like :meth:`finished` and stop asking."""
        raise NotImplementedError

    def tell_rows(self, rows: Sequence[int],
                  objectives: Sequence[float]) -> None:
        """Report objectives for asked rows, in ask order.  Non-finite
        objective == failed/invalid trial."""
        pass

    # -- scalar implementations (fallback + bit-exactness oracle) --------- #
    def ask_scalar(self) -> Config:
        raise NotImplementedError

    def tell_scalar(self, trial: Trial) -> None:
        pass

    # -- public dict protocol (all callers) ------------------------------- #
    def _decode_warm(self, rows: Sequence[int]) -> list[Config]:
        if self._comp is not None:
            return self._comp.decode_many(rows)
        return [self.space.from_flat_index(r) for r in rows]

    def ask(self) -> Config:
        if self._warm_queue:
            return self._decode_warm(self._warm_take(1))[0]
        if self.index_native:
            return self._comp.decode_row(self.ask_rows(1)[0])
        return self.ask_scalar()

    def tell(self, trial: Trial) -> None:
        if self.index_native:
            self.report_rows([self.space.flat_index(trial.config)],
                             [_objective_of(trial)])
        else:
            if self._warm_pending > 0:
                self._warm_account(self.space.flat_index(trial.config),
                                   _objective_of(trial))
                self._absorb_warm_scalar(trial)
                self._warm_maybe_adopt()
                return
            self.tell_scalar(trial)

    # -- batched protocol ------------------------------------------------- #
    def ask_batch(self, n: int) -> list[Config]:
        """Propose up to ``n`` configs at once.  Callers must clamp ``n`` to
        :attr:`max_parallel_asks` and tell every asked config exactly once,
        in ask order, before the next batch.  An empty batch is an
        exhaustion signal equivalent to :meth:`finished` — callers must
        stop asking rather than index into it."""
        if self._warm_queue:
            return self._decode_warm(self._warm_take(max(1, n)))
        if self.index_native:
            return self._comp.decode_many(self.ask_rows(max(1, n)))
        return [self.ask_scalar() for _ in range(max(1, n))]

    def tell_batch(self, trials: Sequence[Trial]) -> None:
        """Report evaluated trials, in the order they were asked."""
        if self.index_native:
            self.report_rows(
                [int(k) for k in
                 self.space.flat_index_many([t.config for t in trials])],
                [_objective_of(t) for t in trials])
        else:
            for t in trials:
                self.tell(t)

    def finished(self) -> bool:
        """Optional early-termination signal (e.g. grid exhausted)."""
        return False


def run_tuner(tuner: Tuner, problem: TunableProblem, budget: int,
              arch: str = DEFAULT_ARCH, unique: bool = True,
              warm_start: Sequence[int] | None = None,
              screen=None) -> TuneResult:
    """Drive ``tuner`` for ``budget`` objective evaluations.

    ``unique=True``: re-asked configs are answered from cache and do NOT
    consume budget (the standard protocol when tuning over recorded spaces).
    A stall guard stops after 50x budget total asks.

    Index-native tuners run the loop in row space — dedup keys *are* the
    asked rows, no ``flat_index`` per ask — with the same trajectory, budget
    accounting, and trace as the scalar loop.

    ``warm_start``: predicted-top rows installed via
    :meth:`Tuner.set_warm_start` before the loop (``None`` leaves the run
    bit-identical to a cold one).  ``screen``: a surrogate screen
    (``repro_torch.core.surrogate.SurrogateScreen``) whose ``screen_rows``
    may answer fresh configs with model-estimated trials instead of
    measurements — estimated trials carry their provenance in
    ``Trial.info`` and still consume budget.
    """
    if warm_start is not None:
        tuner.set_warm_start(warm_start)
    res = TuneResult(tuner.name, problem.name, arch, tuner.seed)
    cache: dict[int, Trial] = {}
    native = tuner.index_native
    comp = tuner._comp if native else None
    asks = 0
    while len(res.trials) < budget and asks < 50 * budget:
        if tuner.finished():
            break
        asks += 1
        if native:
            with span("tuner.ask", cat="tuner"):
                key = int(tuner.propose_rows(1)[0])
            if key in cache:
                with span("tuner.tell", cat="tuner"):
                    tuner.report_rows([key], [_objective_of(cache[key])])
                if not unique:
                    res.trials.append(cache[key])
                continue
            t = screen.screen_rows([key], arch)[0] if screen is not None \
                else None
            if t is None:
                t = problem.evaluate(comp.decode_row(key), arch)
            cache[key] = t
            with span("tuner.tell", cat="tuner"):
                tuner.report_rows([key], [_objective_of(t)])
        else:
            with span("tuner.ask", cat="tuner"):
                cfg = tuner.ask()
            key = problem.space.flat_index(cfg)
            if key in cache:
                with span("tuner.tell", cat="tuner"):
                    tuner.tell(cache[key])
                if not unique:
                    res.trials.append(cache[key])
                continue
            t = screen.screen_rows([key], arch)[0] if screen is not None \
                else None
            if t is None:
                t = problem.evaluate(cfg, arch)
            cache[key] = t
            with span("tuner.tell", cat="tuner"):
                tuner.tell(t)
        res.trials.append(t)
    return res


def run_many(make_tuner, problem: TunableProblem, budget: int, repeats: int,
             arch: str = DEFAULT_ARCH, seed0: int = 0) -> list[TuneResult]:
    """Repeat a tuner run with different seeds (median-of-N protocol)."""
    return [run_tuner(make_tuner(problem.space, seed0 + i), problem, budget,
                      arch) for i in range(repeats)]
