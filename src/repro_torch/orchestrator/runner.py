"""The session runner: batched ask/tell over a worker pool, with resume.

The loop generalizes ``run_tuner`` (same budget accounting, dedup cache and
stall guard) to batches:

1. ask the tuner for a batch (its declared safe width, capped by the
   remaining budget),
2. resolve each asked config against the dedup cache and the resume
   journal, evaluate the genuinely new ones in parallel,
3. journal the fresh evaluations, then tell the whole batch back *in ask
   order* and append the budget-consuming trials to the trace.

Determinism: batch width depends only on the tuner (not on worker count or
completion timing) and results are told in ask order, so a session's
trajectory is a pure function of (spec, tuner) — the property that makes
resume exact.  Resume replays the journal *through the tuner*: re-asked
journaled configs are answered from disk (consuming budget, not hardware),
which reconstructs the tuner's RNG state and then continues with fresh
evaluations.  For ask-independent tuners (random, grid) the parallel trace
is bit-for-bit identical to serial ``run_tuner``; sequential tuners
(``max_parallel_asks == 1``) degrade to the serial protocol exactly.

Stepper architecture
--------------------
The loop itself lives in :func:`session_stepper`, a generator that *yields*
an :class:`EvalRequest` whenever it has genuinely-new work and receives the
evaluated trials back via ``send``.  Everything session-local — ask stream,
dedup cache, journal replay, journaling, tells, budget accounting, status
transitions — happens inside the generator, so any driver that answers its
requests faithfully produces the identical trajectory and journal:

* :func:`run_session` drives one stepper against its own pool (the classic
  serial entry point, API-unchanged);
* :func:`~repro_torch.orchestrator.campaign.run_campaign` drives N steppers
  round-robin against one shared pool, answering row requests of
  portability grids from arch-shared evaluations (each deduped row
  evaluated once, all architectures read from shared value columns);
* ``run_campaign(..., broker=...)`` publishes requests as jobs on a
  durable :class:`~repro_torch.orchestrator.broker.Broker` and tells each
  stepper asynchronously when its batch completes — the multi-host
  backend, served by detached ``python -m repro_torch.orchestrator worker``
  processes (``run_session(broker=...)`` is the single-session form).

The stepper/EvalRequest protocol and its determinism guarantees are
documented as a stable contract in ``docs/architecture.md``.

A spec's ``warm_start`` rows are installed on the tuner
(:meth:`Tuner.set_warm_start`) and proposed before its own asks.  A
``screen=`` (``repro_torch.core.surrogate.SurrogateScreen``) answers the
predicted-poor slice of each fresh batch with model-estimated trials,
journaled beside the measured ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Generator

from ..core.problem import Trial, TunableProblem
from ..core.tuners import TUNERS
from ..core.tuners.base import Tuner, TuneResult
from ..telemetry import metrics as _metrics
from ..telemetry.trace import span
from .registry import make_problem
from .session import DONE, FAILED, INTERRUPTED, RUNNING, SessionSpec
from .store import SessionStore
from .workers import WorkerPool

#: batch width for tuners with unbounded parallel asks.  A constant — never
#: derived from worker count — so the ask stream, budget accounting, and
#: journal are identical at any parallelism (a worker-scaled width would
#: change, e.g., how many post-exhaustion grid fallbacks a unique=False
#: session records).
_UNBOUNDED_BATCH = 16


def _batch_cap(tuner: Tuner) -> int:
    if tuner.max_parallel_asks is None:
        return _UNBOUNDED_BATCH
    return max(1, tuner.max_parallel_asks)


@dataclass
class EvalRequest:
    """One batch of genuinely-new evaluations a session stepper needs.

    Exactly one of ``rows`` (index-native sessions) and ``configs``
    (dict-path sessions over uncompiled spaces) is set; the driver answers
    with ``list[Trial]`` aligned with it.  ``problem``/``arch`` ride along
    so a shared multi-session pool can dispatch without consulting the
    spec.
    """

    problem: TunableProblem
    arch: str
    rows: list[int] | None = None
    configs: list | None = None


def resolve_session(spec: SessionSpec,
                    problem: TunableProblem | None = None,
                    tuner: Tuner | None = None
                    ) -> tuple[TunableProblem, Tuner]:
    """Materialize the live problem/tuner a spec names (registry lookups
    unless explicit instances are provided)."""
    if problem is None:
        problem = make_problem(spec.problem, **spec.problem_kwargs)
    if tuner is None:
        if spec.tuner not in TUNERS:
            raise KeyError(f"unknown tuner {spec.tuner!r}; "
                           f"registered: {', '.join(sorted(TUNERS))}")
        tuner = TUNERS[spec.tuner](problem.space, seed=spec.seed,
                                   **spec.tuner_kwargs)
    if spec.warm_start:
        # the spec stores resolved rows (not a model reference), so resumed
        # and fresh runs install the identical warm queue
        tuner.set_warm_start(spec.warm_start)
    return problem, tuner


def session_stepper(spec: SessionSpec, *, problem: TunableProblem,
                    tuner: Tuner, store: SessionStore | None = None,
                    stop_after: int | None = None,
                    on_batch: Callable[[TuneResult], None] | None = None,
                    screen=None
                    ) -> Generator[EvalRequest, list, TuneResult]:
    """The session loop as a coroutine: yields :class:`EvalRequest` for
    fresh work, receives the evaluated trials, returns the full trace.

    Drivers must answer every yielded request (trials in request order)
    and may throw an exception into the generator to abort — the session
    is then marked FAILED with its journal intact, like any crash.

    ``screen`` (a surrogate screen, see ``repro_torch.core.surrogate``)
    answers a slice of each fresh batch with model-estimated trials; only
    the remainder is yielded for measurement.  Estimated trials are
    journaled and told like measured ones.
    """
    space = problem.space
    space.compile_eagerly()   # one-time table build: mask-backed fast paths
    res = TuneResult(tuner.name, problem.name, spec.arch, spec.seed)

    sid = None
    replay: dict[int, list] = {}       # key -> [trial, remaining_count]
    if store is not None:
        sid = store.create(spec)
        for key, t in store.load_journal(sid, space, spec.arch):
            if key in replay:
                replay[key][1] += 1
            else:
                replay[key] = [t, 1]
        store.update_meta(sid, status=RUNNING)

    cache: dict[int, object] = {}
    cap = _batch_cap(tuner)
    # telemetry handles resolved once (no-ops while metrics are off, so the
    # per-batch cost of the disabled path is a few no-op method calls).
    # Telemetry reads the trajectory, never steers it: no rng draws, no
    # batch reshaping — bit-identity with telemetry off is a contract.
    _slabel = spec.session_id
    _c_evals = _metrics.counter("session.evals", session=_slabel)
    _c_cache = _metrics.counter("session.cache_hits", session=_slabel)
    _g_best = _metrics.gauge("session.best", session=_slabel)
    _g_to_best = _metrics.gauge("session.evals_to_best", session=_slabel)
    _best_seen = math.inf
    # index-native fast path: ask rows, dedup on the rows themselves (a row
    # *is* the flat index), evaluate through the pool's row path.  The ask
    # stream, batch widths, trajectories, and journal are identical to the
    # dict path — only the per-config encode/decode/flat_index work is gone.
    native = tuner.index_native
    asks = 0
    stopped_early = False
    try:
        while len(res.trials) < spec.budget and asks < 50 * spec.budget:
            if tuner.finished():
                break
            if stop_after is not None and len(res.trials) >= stop_after:
                stopped_early = True
                break
            # stop_after checks at batch boundaries only (loop top) and never
            # reshapes batches: truncating a batch would shift the generation
            # boundaries of population tuners, making the resumed trajectory
            # diverge from the never-interrupted one.  A real kill has the
            # same semantics — only whole journaled batches survive.
            n = min(cap, spec.budget - len(res.trials))
            with span("session.ask", cat="session", n=n):
                if native:
                    keys = [int(r) for r in tuner.propose_rows(max(1, n))]
                    cfgs: list = []
                else:
                    cfgs = tuner.ask_batch(n)
                    keys = [int(k) for k in space.flat_index_many(cfgs)] \
                        if len(cfgs) > 1 else \
                        [space.flat_index(cfgs[0])] if cfgs else []
            if not keys:
                # an empty ask is a finished() signal: a tuner whose
                # exhaustion flips mid-batch may legally return fewer
                # configs than asked — including none at all
                break
            asks += len(keys)

            results: list = [None] * len(keys)
            consume = [False] * len(keys)
            fresh: list[int] = []          # positions to actually evaluate
            first_seen: dict[int, int] = {}
            cache_hits = 0
            for j, key in enumerate(keys):
                if key in cache:
                    results[j] = cache[key]
                    consume[j] = not spec.unique
                    cache_hits += 1
                elif key in replay:        # answered from the journal
                    entry = replay[key]
                    entry[1] -= 1
                    if entry[1] <= 0:
                        del replay[key]
                    cache[key] = entry[0]
                    results[j] = entry[0]
                    consume[j] = True      # consumed budget in the prior run
                elif key in first_seen:    # intra-batch duplicate
                    consume[j] = not spec.unique
                else:
                    first_seen[key] = j
                    fresh.append(j)

            screened: list[tuple[int, Trial]] = []
            if screen is not None and fresh:
                # the screen answers the predicted-poor slice itself; only
                # the remainder goes out for measurement
                verdicts = screen.screen_rows([keys[j] for j in fresh],
                                              spec.arch)
                kept: list[int] = []
                for j, v in zip(fresh, verdicts):
                    if v is None:
                        kept.append(j)
                    else:
                        screened.append((j, v))
                fresh = kept
            if not fresh:
                evaluated: list[Trial] = []
            elif native:
                evaluated = yield EvalRequest(problem, spec.arch,
                                              rows=[keys[j] for j in fresh])
            else:
                evaluated = yield EvalRequest(problem, spec.arch,
                                              configs=[cfgs[j] for j in fresh])
            journal_records = []
            # journal in ask order, estimated and measured alike
            for j, t in sorted(list(zip(fresh, evaluated)) + screened):
                cache[keys[j]] = t
                results[j] = t
                consume[j] = True
                journal_records.append((keys[j], t))
            for j in range(len(keys)):     # resolve intra-batch duplicates
                if results[j] is None:
                    results[j] = cache[keys[j]]

            if store is not None and journal_records:
                store.append_trials(sid, space, journal_records)
            with span("session.tell", cat="session", n=len(keys)):
                if native:
                    tuner.report_rows(keys, [t.objective if t.ok else math.inf
                                             for t in results])
                else:
                    tuner.tell_batch(results)
            for j in range(len(keys)):
                if consume[j]:
                    res.trials.append(results[j])
            if _metrics.is_enabled():
                _c_evals.inc(len(fresh))
                _c_cache.inc(cache_hits)
                if screened:
                    _metrics.counter("session.screened",
                                     session=_slabel).inc(len(screened))
                batch_best = min((t.objective for t in results if t.ok),
                                 default=math.inf)
                if batch_best < _best_seen:
                    _best_seen = batch_best
                    _g_best.set(batch_best)
                    _g_to_best.set(len(res.trials))

            if store is not None:
                b = res.best
                store.update_meta(
                    sid, evaluated=len(res.trials),
                    best=None if not math.isfinite(b.objective) else b.objective)
            if on_batch is not None:
                on_batch(res)

        if store is not None:
            if stopped_early:
                store.update_meta(sid, status=INTERRUPTED)
            else:
                # publish BEFORE flipping to DONE: a crash between the two
                # leaves a FAILED session (resumable — the full replay
                # republishes idempotently) rather than a DONE session
                # with no table
                store.publish_trace(sid, problem, res)
                store.update_meta(sid, status=DONE,
                                  evaluated=len(res.trials))
    except BaseException:
        # never leave a dead session looking alive; the journal keeps every
        # completed batch, so a failed session resumes like any other
        if store is not None:
            store.update_meta(sid, status=FAILED)
        raise
    return res


def drive(gen: Generator[EvalRequest, list, TuneResult],
          pool: WorkerPool) -> TuneResult:
    """Run one stepper to completion against ``pool``.

    Evaluation errors are thrown *into* the generator so the session is
    marked FAILED (journal intact) exactly as under the monolithic loop.
    """
    try:
        req = next(gen)
        while True:
            try:
                if req.rows is not None:
                    trials = pool.evaluate_rows(req.rows, arch=req.arch,
                                                problem=req.problem)
                else:
                    trials = pool.evaluate(req.configs, arch=req.arch,
                                           problem=req.problem)
            except BaseException as e:
                gen.throw(e)
                raise                  # pragma: no cover — throw re-raises
            req = gen.send(trials)
    except StopIteration as e:
        return e.value


def run_session(spec: SessionSpec, *, problem: TunableProblem | None = None,
                tuner: Tuner | None = None, store: SessionStore | None = None,
                pool: WorkerPool | None = None, workers: int | None = None,
                mode: str = "auto", max_retries: int = 2,
                stop_after: int | None = None, broker=None,
                on_batch: Callable[[TuneResult], None] | None = None,
                screen=None) -> TuneResult:
    """Run (or resume) one tuning session; returns the full trace.

    ``problem``/``tuner`` default to registry/``TUNERS`` lookups from the
    spec.  With a ``store``, every completed batch is journaled so the
    session survives a kill; an existing journal is replayed first.
    ``stop_after`` ends the run at the first batch boundary with at least
    that many trials recorded (checkpoint-and-stop — also how tests
    simulate a crash).  With ``broker=``, evaluation goes to a durable job
    queue served by detached worker processes instead of a local pool
    (trajectory unchanged).  Because workers rematerialize the problem
    from the registry by name, live ``problem``/``tuner`` instances are
    rejected in broker mode — a driver-side instance that disagreed with
    the registry would silently break the bit-identity guarantee —
    as are ``pool``/``stop_after``/``on_batch`` (monitor via the store's
    ``status`` instead).  ``screen`` answers a slice of each fresh batch
    with model-estimated trials (:func:`session_stepper`); broker mode
    refuses it.
    """
    if broker is not None:
        if (pool is not None or stop_after is not None or tuner is not None
                or problem is not None or on_batch is not None
                or screen is not None):
            raise ValueError(
                "broker sessions take none of pool=/stop_after=/tuner=/"
                "problem=/on_batch=/screen= — workers rematerialize the "
                "problem from the registry, and tells batch at session "
                "granularity (watch progress via `status --store`)")
        from .campaign import run_campaign
        return run_campaign([spec], store,
                            broker=broker)[spec.session_id]
    problem, tuner = resolve_session(spec, problem, tuner)
    workers = spec.workers if workers is None else workers
    own_pool = pool is None
    if pool is None:
        pool = WorkerPool(problem, spec.arch, workers=workers, mode=mode,
                          max_retries=max_retries)
    gen = session_stepper(spec, problem=problem, tuner=tuner, store=store,
                          stop_after=stop_after, on_batch=on_batch,
                          screen=screen)
    try:
        return drive(gen, pool)
    finally:
        if own_pool:
            pool.close()


def resume_session(sid: str, store: SessionStore, *,
                   workers: int | None = None, mode: str = "auto",
                   max_retries: int = 2,
                   stop_after: int | None = None) -> TuneResult:
    """Continue an interrupted session from its journal.

    The spec (including worker count, hence the batch schedule) comes from
    the store, so the replayed prefix matches the original run exactly and
    no journaled config is ever re-evaluated.  Also repairs a session that
    crashed between trace publication and its DONE mark: the full replay
    re-publishes idempotently.
    """
    spec = store.load_spec(sid)
    return run_session(spec, store=store, workers=workers, mode=mode,
                       max_retries=max_retries, stop_after=stop_after)
